"""SNAC — Multi-Scale Neural Audio Codec, PyTorch port.

Counterpart of neuralcodecs_tpu.models.snac.model. Topology:

  pad → Encoder (WNConv1d k7 → N×[3 dilated ResUnits + Snake + strided conv]
        → optional LocalMHA → depthwise WNConv1d k7)
      → multi-scale RVQ (per-stage stride pooling, normalized L2 argmin)
      → Decoder (depthwise conv pair → optional LocalMHA →
        N×[Snake → ConvTranspose → Noise → 3 ResUnits] → Snake → conv → tanh)
      → trim to input length.

Module and parameter names follow the upstream checkpoint (``encoder.block``,
``quantizer.quantizers``, ``decoder.model``). On a CUDA device the 24
residual units (SNAC-24k) run the fused residual-unit kernel and every RVQ
stage runs the codebook kernel.

Chunked execution (ops/chunking.py), as in the JAX package: the encoder's
in-conv and all but its last block, and the decoder's tail after its first
DecoderBlock, can run on n overlapping windows batched on the leading axis
(``_forward_chunked_fn`` / ``_encode_chunked_fn`` / ``_decode_chunked_fn``);
the last encoder block, LocalMHA, the RVQ and the decoder head see the whole
stream. The stages are index ranges of ``encoder.block`` and
``decoder.model``, so the state dict's keys are the unchunked model's. With
noise on, the chunked tail draws another noise pattern than the unchunked
one, as in JAX. ``forward`` / ``encode`` / ``decode`` run n = 1 on every
device, where JAX's pick n with ``_auto_chunks``: the result is the same
function, and the A/B of the served 4 x 10 s round trip on an H100 80GB
HBM3 at 700 W measured the chunked one 4.4-4.6% slower (32.7-33.0 against
31.3-31.5 ms; PERF.md §5, the chunked A/B).

Spans (``diagnostics.profiler.span``): ``forward`` / ``encode`` / ``decode``
each open one root, ``snac.forward`` / ``snac.encode`` / ``snac.decode``,
with ``snac.prepare`` (the upload), ``snac.encoder``, ``snac.quantizer`` and
``snac.decoder`` under it as the call runs them. The root counts the
residual units the call ran (``units``) and those whose wrapper launched
kernel 2a (``unit_kernel_units``), from the wrapper's own counters on the
host: nothing waits for the card.

Precision modes, as in the JAX package: the encoder takes its input in
``compute_dtype``, the RVQ runs in f32, and the decoder takes z_q in
``decoder_dtype`` (default ``compute_dtype``, default f32); the output is
f32. ``decoder_dtype=torch.bfloat16`` alone is the mixed mode, whose codes
are the f32 mode's. Parameters stay f32 and each conv casts its weight to
its input's dtype, so under the JAX semantics only the first conv of a
stage runs in bf16: its f32 bias promotes the sum (ops/conv.py), and the
kernels always see f32.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.weights import CodecWeights
from neuralcodecs_tpu_torch.diagnostics.profiler import span
from neuralcodecs_tpu_torch.dsp.resample import linear_resample
from neuralcodecs_tpu_torch.models.layers import (
    LocalMHA,
    NoiseBlock,
    ResidualUnit,
    Sequential,
    Snake1d,
    Tanh,
    WNConv1d,
    WNConvTranspose1d,
    run_layers,
)
from neuralcodecs_tpu_torch.models.snac.config import SNACConfig
from neuralcodecs_tpu_torch.ops.chunking import (
    codec_stages,
    plan_chunks,
    split_chunks,
    stitch_chunks,
)
from neuralcodecs_tpu_torch.ops.kernels.resunit import fused_residual_unit
from neuralcodecs_tpu_torch.ops.vq import codebook_lookup, cosine_argmin_codes


@contextlib.contextmanager
def _call_span(name: str):
    """The root span of one public call, with the residual units the call
    ran and those that launched kernel 2a: the wrapper's counts after the
    call less those before it."""
    with span(name) as root:
        units, launches = fused_residual_unit.units, fused_residual_unit.launches
        yield
        root.set(units=fused_residual_unit.units - units,
                 unit_kernel_units=fused_residual_unit.launches - launches)


class EncoderBlock(nn.Module):
    """3×ResidualUnit(dil 1/3/9) + Snake + strided conv."""

    def __init__(self, out_dim: int, stride: int, groups: int):
        super().__init__()
        in_dim = out_dim // 2
        self.block = nn.Sequential(
            ResidualUnit(in_dim, dilation=1, groups=groups),
            ResidualUnit(in_dim, dilation=3, groups=groups),
            ResidualUnit(in_dim, dilation=9, groups=groups),
            Snake1d(in_dim),
            WNConv1d(in_dim, out_dim, 2 * stride, stride=stride, padding=-(-stride // 2)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DecoderBlock(nn.Module):
    """Snake → ConvTranspose(k=2s, output_padding=s%2) → Noise? → 3×ResUnit."""

    takes_generator = True

    def __init__(self, in_dim: int, out_dim: int, stride: int, noise: bool, groups: int):
        super().__init__()
        layers: list[nn.Module] = [
            Snake1d(in_dim),
            WNConvTranspose1d(in_dim, out_dim, 2 * stride, stride=stride,
                              padding=-(-stride // 2), output_padding=stride % 2),
        ]
        if noise:
            layers.append(NoiseBlock(out_dim))
        layers += [ResidualUnit(out_dim, dilation=d, groups=groups) for d in (1, 3, 9)]
        self.block = Sequential(*layers)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.block(x, generator)


class Encoder(nn.Module):
    def __init__(self, cfg: SNACConfig):
        super().__init__()
        layers: list[nn.Module] = [WNConv1d(1, cfg.encoder_dim, 7, padding=3)]
        dim = cfg.encoder_dim
        for stride in cfg.encoder_rates:
            dim *= 2
            layers.append(EncoderBlock(dim, stride, dim // 2 if cfg.depthwise else 1))
        if cfg.attn_window_size:
            layers.append(LocalMHA(dim, window_size=cfg.attn_window_size))
        layers.append(WNConv1d(dim, dim, 7, padding=3, groups=dim if cfg.depthwise else 1))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Decoder(nn.Module):
    def __init__(self, cfg: SNACConfig):
        super().__init__()
        latent = cfg.resolved_latent_dim
        if cfg.depthwise:
            layers: list[nn.Module] = [
                WNConv1d(latent, latent, 7, padding=3, groups=latent),
                WNConv1d(latent, cfg.decoder_dim, 1),
            ]
        else:
            layers = [WNConv1d(latent, cfg.decoder_dim, 7, padding=3)]
        if cfg.attn_window_size:
            layers.append(LocalMHA(cfg.decoder_dim, window_size=cfg.attn_window_size))
        out_dim = cfg.decoder_dim
        for i, rate in enumerate(cfg.decoder_rates):
            in_dim = cfg.decoder_dim // (1 << i)
            out_dim = cfg.decoder_dim // (1 << (i + 1))
            layers.append(DecoderBlock(in_dim, out_dim, rate, cfg.noise,
                                       out_dim if cfg.depthwise else 1))
        layers += [Snake1d(out_dim), WNConv1d(out_dim, 1, 7, padding=3), Tanh()]
        self.model = Sequential(*layers)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.model(x, generator)


class VectorQuantizer(nn.Module):
    """One RVQ stage: stride pool → in_proj → argmin codebook → out_proj →
    repeat_interleave."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, stride: int):
        super().__init__()
        self.stride = stride
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """z: [B, C, T] residual at full frame rate -> (z_q [B, C, T], codes [B, T/s])."""
        if self.stride > 1:
            b, c, t = z.shape
            z = z.reshape(b, c, t // self.stride, self.stride).mean(dim=-1)
        z_e = self.in_proj(z).to(torch.float32)                       # [B, D, T']
        codebook = self.codebook.weight
        codes = cosine_argmin_codes(z_e.transpose(1, 2), codebook)   # [B, T']
        z_q = codebook_lookup(codes, codebook).transpose(1, 2)
        z_q = z_e + (z_q - z_e).detach()  # straight-through, rounded as the JAX forward rounds it
        z_q = self.out_proj(z_q)
        if self.stride > 1:
            z_q = z_q.repeat_interleave(self.stride, dim=-1)
        return z_q, codes

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T/s] -> z_q contribution [B, C, T]."""
        z_q = self.out_proj(codebook_lookup(codes, self.codebook.weight).transpose(1, 2))
        if self.stride > 1:
            z_q = z_q.repeat_interleave(self.stride, dim=-1)
        return z_q


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, cfg: SNACConfig):
        super().__init__()
        self.quantizers = nn.ModuleList(
            VectorQuantizer(cfg.resolved_latent_dim, cfg.codebook_size, cfg.codebook_dim, s)
            for s in cfg.vq_strides)

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        residual, z_q = z, torch.zeros_like(z)
        codes = []
        for vq in self.quantizers:
            z_q_i, codes_i = vq(residual)
            residual = residual - z_q_i
            z_q = z_q + z_q_i
            codes.append(codes_i)
        return z_q, codes

    def from_codes(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        z_q = self.quantizers[0].decode_code(codes[0])
        for vq, c in zip(self.quantizers[1:], codes[1:]):
            z_q = z_q + vq.decode_code(c)
        return z_q


class SNAC(CodecWeights, nn.Module):
    """Public SNAC codec: forward / encode / decode / process_audio.

    Weights are torch-default random from ``seed`` (made on the CPU, so the
    same seed gives the same weights on every device) until a checkpoint is
    loaded: ``load_snac`` / ``load_pretrained``, or by hand a folded
    hubertsiuzdak/snac state dict with ``load_upstream_state_dict`` (the
    real files' ``rel_pos.inv_freq`` buffers are dropped). The model lives
    on ``device``, "cuda" when none is given."""

    def __init__(self, config: SNACConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 decoder_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config or SNACConfig()
        self.compute_dtype = compute_dtype or torch.float32
        self.decoder_dtype = decoder_dtype or self.compute_dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.encoder = Encoder(self.config)
            self.quantizer = ResidualVectorQuantizer(self.config)
            self.decoder = Decoder(self.config)
        self.to(resolve_device(device))
        # the chunked stages: encoder.block[:enc_split] and
        # decoder.model[_dec_split:] (after the first DecoderBlock)
        self._stages = codec_stages(self.config.encoder_rates, self.config.decoder_rates)
        self._dec_split = 1 + next(
            (i for i, layer in enumerate(self.decoder.model) if isinstance(layer, DecoderBlock)),
            len(self.decoder.model))

    @property
    def device(self) -> torch.device:
        return self.quantizer.quantizers[0].codebook.weight.device

    # ----------------------------------------------------------------- compute

    def _encoder_out(self, audio: torch.Tensor) -> torch.Tensor:
        """The encoder on audio in ``compute_dtype``; the RVQ's input in f32."""
        with span("snac.encoder"):
            return self.encoder(audio.to(self.compute_dtype)).to(torch.float32)

    def _run_decoder(self, z_q: torch.Tensor, generator: torch.Generator | None
                     ) -> torch.Tensor:
        """The decoder on z_q in ``decoder_dtype``; the audio in f32."""
        with span("snac.decoder"):
            return self.decoder(z_q.to(self.decoder_dtype), generator).to(torch.float32)

    def _quantize(self, z: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The RVQ on the encoder's output. Its own frame, so that the
        caller holds no reference to z while the decoder runs."""
        with span("snac.quantizer"):
            return self.quantizer(z)

    def _forward_fn(self, audio: torch.Tensor, generator: torch.Generator | None
                    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Round trip on padded [B, 1, T] audio -> ([B, 1, T], codes)."""
        z_q, codes = self._quantize(self._encoder_out(audio))
        return self._run_decoder(z_q, generator), codes

    def _encode_fn(self, audio: torch.Tensor) -> list[torch.Tensor]:
        return self._quantize(self._encoder_out(audio))[1]

    def _decode_fn(self, codes: Sequence[torch.Tensor],
                   generator: torch.Generator | None) -> torch.Tensor:
        with span("snac.quantizer"):
            z_q = self.quantizer.from_codes(codes)
        return self._run_decoder(z_q, generator)

    # ------------------------------------------------- chunked-batch execution

    def _auto_chunks(self, samples: int) -> int:
        """Largest chunk count (<=8) whose overlap windows still pay off."""
        return self._stages.auto_chunks(samples)

    def _encoder_staged(self, audio: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """The encoder with its long-T early stages chunk-batched; exact. The
        last block, LocalMHA and the depthwise conv run on the stitched
        stream, so attention windows are the unchunked ones. Returns the
        RVQ's f32 input, as ``_encoder_out``."""
        st = self._stages
        plan = plan_chunks(audio.shape[-1] // st.enc_ratio, n_chunks, st.enc_halo)
        if plan is None:
            return self._encoder_out(audio)
        layers = list(self.encoder.block)
        h = run_layers(layers[: st.enc_split],
                       split_chunks(audio.to(self.compute_dtype), plan, scale=st.enc_ratio))
        return run_layers(layers[st.enc_split:], stitch_chunks(h, plan)).to(torch.float32)

    def _run_decoder_staged(self, z_q: torch.Tensor, generator: torch.Generator | None,
                            n_chunks: int) -> torch.Tensor:
        """The decoder head (convs, LocalMHA, first block) on the stream, its
        narrow long-T tail chunk-batched; f32 audio. The generator runs on
        from the head into the tail."""
        layers = list(self.decoder.model)
        x = run_layers(layers[: self._dec_split], z_q.to(self.decoder_dtype), generator)
        plan = plan_chunks(x.shape[-1], n_chunks, self._stages.dec_tail_halo)
        if plan is None:
            return run_layers(layers[self._dec_split:], x, generator).to(torch.float32)
        y = run_layers(layers[self._dec_split:], split_chunks(x, plan), generator)
        return stitch_chunks(y, plan, scale=self._stages.dec_tail_ratio).to(torch.float32)

    def _forward_chunked_fn(self, audio: torch.Tensor, generator: torch.Generator | None,
                            n_chunks: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
        if n_chunks <= 1:
            return self._forward_fn(audio, generator)
        z_q, codes = self.quantizer(self._encoder_staged(audio, n_chunks))
        return self._run_decoder_staged(z_q, generator, n_chunks), codes

    def _encode_chunked_fn(self, audio: torch.Tensor, n_chunks: int) -> list[torch.Tensor]:
        if n_chunks <= 1:
            return self._encode_fn(audio)
        return self.quantizer(self._encoder_staged(audio, n_chunks))[1]

    def _decode_chunked_fn(self, codes: Sequence[torch.Tensor],
                           generator: torch.Generator | None, n_chunks: int) -> torch.Tensor:
        return self._run_decoder_staged(self.quantizer.from_codes(codes), generator, n_chunks)

    # ------------------------------------------------------------- public API

    def _pad_length(self, length: int) -> int:
        pad_to = self.config.pad_to
        return -(-length // pad_to) * pad_to

    def _prepare(self, audio) -> tuple[torch.Tensor, int]:
        """[T] | [B, T] | [B, 1, T] -> padded [B, 1, T'] on the model's device,
        plus the original length."""
        a = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if a.dim() == 1:
            a = a[None, :]
        elif a.dim() == 3:
            a = a[:, 0, :]
        length = a.shape[-1]
        a = torch.nn.functional.pad(a, (0, self._pad_length(length) - length))
        return a[:, None, :].contiguous(), length

    def _noise_generator(self, generator: torch.Generator | None) -> torch.Generator | None:
        """The generator for the decoder noise: None when the config has no
        noise; a fresh one seeded 0 when noise is on and none is given."""
        if not self.config.noise:
            return None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    @torch.no_grad()
    def forward(self, audio, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Round trip: returns (audio_hat [B, T], codes list of [B, frames_i])."""
        with _call_span("snac.forward"):
            with span("snac.prepare"):
                a, length = self._prepare(audio)
                generator = self._noise_generator(generator)
            audio_hat, codes = self._forward_fn(a, generator)
            return audio_hat[:, 0, :length], codes

    @torch.no_grad()
    def encode(self, audio) -> list[torch.Tensor]:
        """Audio -> list of per-stage code index arrays [B, frames_i]."""
        with _call_span("snac.encode"):
            with span("snac.prepare"):
                a = self._prepare(audio)[0]
            return self._encode_fn(a)

    @torch.no_grad()
    def decode(self, codes: Sequence, generator: torch.Generator | None = None) -> torch.Tensor:
        """Codes -> audio [B, T] (T = frames of the stride-1 stage × hop)."""
        with _call_span("snac.decode"):
            with span("snac.prepare"):
                codes = [torch.as_tensor(c, dtype=torch.int32, device=self.device) for c in codes]
                codes = [c[None, :] if c.dim() == 1 else c for c in codes]
                generator = self._noise_generator(generator)
            return self._decode_fn(codes, generator)[:, 0, :]

    def process_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Resample to the model's rate if needed, then round-trip one clip
        ([T], an array or a tensor, taken to the model's device; numpy out).
        With diagnostics on (``diagnostics.set_diagnostics``) it runs staged,
        encode then decode, so the context sees each phase's time and codes."""
        from neuralcodecs_tpu_torch.diagnostics.context import get_diagnostics

        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if sample_rate != self.config.sample_rate:
            audio = linear_resample(audio, sample_rate, self.config.sample_rate)
        diag = get_diagnostics()
        if diag.enabled:
            diag.log_tensor("snac", "input", audio)
            with diag.track_scope("snac.encode"):
                codes = [c.cpu().numpy() for c in self.encode(audio)]
            for i, c in enumerate(codes):
                diag.log_tensor("snac.encode", f"codes_{i}", c)
            with diag.track_scope("snac.decode"):
                out = self.decode(codes).cpu().numpy()
            diag.log_tensor("snac.decode", "audio_out", out)
            return out[0, : audio.shape[-1]]
        out, _ = self.forward(audio)
        return (out[0] if out.dim() == 2 else out).cpu().numpy()


registry.register("snac", SNAC, SNACConfig)  # the factory: SNAC(config, device=, seed=)
