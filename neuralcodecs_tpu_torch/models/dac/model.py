"""DAC — Descript Audio Codec, PyTorch port.

Counterpart of neuralcodecs_tpu.models.dac.model. Topology:

  pad to the hop → Encoder (WNConv1d k7 → N×[3 dilated ResUnits + Snake +
        strided conv] → Snake → WNConv1d k3 to the latent)
      → RVQ (per stage: in_proj → normalized-L2 argmin → raw-codebook
        embedding → straight-through → out_proj; commitment and codebook
        losses)
      → Decoder (WNConv1d k7 → N×[Snake → ConvTranspose → 3 ResUnits] →
        Snake → WNConv1d k7 → tanh)
      → trim to at most the input length.

Module and parameter names follow the descript checkpoint (``encoder.block``,
``quantizer.quantizers``, ``decoder.model``), so a weight-norm-folded
checkpoint loads with ``load_state_dict(strict=True)``. Every residual unit
is dense (groups = 1): on a CUDA device the 24 units of a DAC-44k forward run
the dense residual-unit kernel and every RVQ stage the codebook kernel.

Chunked execution (ops/chunking.py), as in the JAX package: the encoder's
in-conv and all but its last block, and the decoder's tail after its first
block, can run on n overlapping windows batched on the leading axis
(``_forward_chunked_fn`` / ``_encode_chunked_fn`` / ``_decode_chunked_fn``);
the rest and the RVQ see the whole stream. The stages are index ranges of
``encoder.block`` and ``decoder.model``, so the state dict's keys are the
unchunked model's. ``forward`` / ``encode`` / ``decode`` / ``from_codes`` /
``from_latents`` (and with them Dia's vocoder) run n = 1 on every device,
where JAX's pick n with ``_auto_chunks``: the result is the same function,
and the A/B of the served 4 x 10 s round trip on an H100 80GB HBM3 at
700 W measured the chunked one 1.2-1.5% slower (150.9-151.6 against
149.0-149.6 ms; PERF.md §5, the chunked A/B). Training runs unchunked, as
in JAX.

Precision modes, as in the JAX package: the encoder takes its input in
``compute_dtype``, each RVQ stage's z_e goes to f32, and the decoder takes
z_q in ``decoder_dtype`` (default ``compute_dtype``, default f32) and gives
f32 audio. ``decoder_dtype=torch.bfloat16`` alone is the mixed mode, whose
codes are the f32 mode's. Parameters stay f32; each conv casts its weight
to its input's dtype, and the first biased conv of a stage promotes to f32
(ops/conv.py), so the kernels see f32 only.

Training: ``_forward_fn`` and ``forward_train`` (quantizer dropout) are
differentiable. The straight-through estimator passes z_e's gradient to the
encoder, the commitment loss trains the encoder and the codebook loss the
codebook, as in the JAX package; in grad mode the residual units run the
dense kernel's training form and its backward
(``ops/kernels/resunit.DenseResidualUnitFn``). Quantizer dropout draws its
stage counts from a ``torch.Generator``, which cannot give ``jax.random``'s
numbers: the tests replace ``draw_dropout_mask`` by the JAX mask.

Public layouts are the JAX package's: audio [B, T], codes [B, Nq, T],
``z`` and ``latents`` [B, T, C]. Inside, activations are [B, C, T].
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.weights import CodecWeights
from neuralcodecs_tpu_torch.dsp.resample import resample_poly
from neuralcodecs_tpu_torch.models.dac.config import DACConfig
from neuralcodecs_tpu_torch.models.layers import (
    ResidualUnit,
    Snake1d,
    Tanh,
    WNConv1d,
    WNConvTranspose1d,
    run_layers,
)
from neuralcodecs_tpu_torch.ops.chunking import (
    codec_stages,
    plan_chunks,
    split_chunks,
    stitch_chunks,
)
from neuralcodecs_tpu_torch.ops.vq import codebook_lookup, cosine_argmin_codes


class EncoderBlock(nn.Module):
    """3×ResidualUnit(dil 1/3/9) at dim/2 + Snake + strided conv to dim."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        half = dim // 2
        self.block = nn.Sequential(
            *(ResidualUnit(half, dilation=d) for d in (1, 3, 9)),
            Snake1d(half),
            WNConv1d(half, dim, 2 * stride, stride=stride, padding=-(-stride // 2)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DecoderBlock(nn.Module):
    """Snake → ConvTranspose(k = 2s) → 3×ResidualUnit(dil 1/3/9)."""

    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(in_dim),
            WNConvTranspose1d(in_dim, out_dim, 2 * stride, stride=stride,
                              padding=-(-stride // 2)),
            *(ResidualUnit(out_dim, dilation=d) for d in (1, 3, 9)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Encoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        layers: list[nn.Module] = [WNConv1d(1, cfg.encoder_dim, 7, padding=3)]
        dim = cfg.encoder_dim
        for stride in cfg.encoder_rates:
            dim *= 2
            layers.append(EncoderBlock(dim, stride))
        layers += [Snake1d(dim), WNConv1d(dim, cfg.resolved_latent_dim, 3, padding=1)]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Decoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        layers: list[nn.Module] = [WNConv1d(cfg.resolved_latent_dim, cfg.decoder_dim, 7,
                                            padding=3)]
        out_dim = cfg.decoder_dim
        for i, rate in enumerate(cfg.decoder_rates):
            out_dim = cfg.decoder_dim // (1 << (i + 1))
            layers.append(DecoderBlock(cfg.decoder_dim // (1 << i), out_dim, rate))
        layers += [Snake1d(out_dim), WNConv1d(out_dim, 1, 7, padding=3), Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class VectorQuantizer(nn.Module):
    """One RVQ stage with its commitment and codebook losses."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def quantize(self, z_e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """z_e [B, D, T] -> (codes [B, T], raw-codebook embedding [B, D, T])."""
        codebook = self.codebook.weight
        codes = cosine_argmin_codes(z_e.transpose(1, 2), codebook)
        return codes, codebook_lookup(codes, codebook).transpose(1, 2)

    def forward(self, z: torch.Tensor):
        """z [B, C, T] -> (z_q [B, C, T], commit [B], codebook_loss [B],
        codes [B, T], z_e [B, D, T])."""
        z_e = self.in_proj(z).to(torch.float32)
        codes, z_q = self.quantize(z_e)
        # the commitment loss trains the encoder only, the codebook loss the
        # codebook only; the straight-through output passes z_e's gradient
        # and rounds as the JAX forward rounds it
        commit = torch.mean((z_e - z_q.detach()) ** 2, dim=(1, 2))
        codebook_loss = torch.mean((z_q - z_e.detach()) ** 2, dim=(1, 2))
        z_q = z_e + (z_q - z_e).detach()
        return self.out_proj(z_q), commit, codebook_loss, codes, z_e

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> z_q contribution [B, C, T]."""
        return self.out_proj(codebook_lookup(codes, self.codebook.weight).transpose(1, 2))


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.quantizers = nn.ModuleList(
            VectorQuantizer(cfg.resolved_latent_dim, cfg.codebook_size, cfg.codebook_dim)
            for _ in range(cfg.n_codebooks))

    def forward(self, z: torch.Tensor, n_quantizers: int | None = None,
                dropout_mask: torch.Tensor | None = None):
        """z [B, C, T] -> (z_q [B, C, T], codes [B, Nq, T], latents
        [B, Nq·D, T], commitment loss, codebook loss); the losses are the sums
        over stages of each stage's batch mean.

        dropout_mask: optional [B] int counts of active stages (quantizer
        dropout). With a mask every stage runs, and stage i's z_q and
        losses count for row b only where i < mask[b]; ``n_quantizers`` is
        then not read."""
        residual, z_q = z, torch.zeros_like(z)
        codes, latents = [], []
        commit = torch.zeros((), device=z.device)
        codebook_loss = torch.zeros((), device=z.device)
        limit = len(self.quantizers) if n_quantizers is None or dropout_mask is not None \
            else n_quantizers
        for i, vq in enumerate(self.quantizers[:limit]):
            z_q_i, commit_i, cb_i, codes_i, z_e_i = vq(residual)
            if dropout_mask is None:
                z_q = z_q + z_q_i
                commit = commit + torch.mean(commit_i)
                codebook_loss = codebook_loss + torch.mean(cb_i)
            else:
                active = (i < dropout_mask).to(z.dtype)  # [B]
                z_q = z_q + z_q_i * active[:, None, None]
                commit = commit + torch.mean(commit_i * active)
                codebook_loss = codebook_loss + torch.mean(cb_i * active)
            residual = residual - z_q_i
            codes.append(codes_i)
            latents.append(z_e_i)
        return (z_q, torch.stack(codes, dim=1), torch.cat(latents, dim=1), commit,
                codebook_loss)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, Nq, T] -> z_q [B, C, T]."""
        z_q = self.quantizers[0].decode_code(codes[:, 0])
        for i in range(1, codes.shape[1]):
            z_q = z_q + self.quantizers[i].decode_code(codes[:, i])
        return z_q

    def from_latents(self, latents: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Latents [B, Σ D_i, T] (the stages' z_e, concatenated) -> (z_q, codes):
        each stage's span is re-quantized and its projection summed."""
        dims = np.cumsum([0] + [vq.codebook.weight.shape[1] for vq in self.quantizers]).tolist()
        n_stages = int(np.searchsorted(dims, latents.shape[1], side="right")) - 1
        z_q, codes = None, []
        for i, vq in enumerate(self.quantizers[:n_stages]):
            stage_codes, z_p = vq.quantize(latents[:, dims[i]: dims[i + 1]])
            contrib = vq.out_proj(z_p)
            z_q = contrib if z_q is None else z_q + contrib
            codes.append(stage_codes)
        return z_q, torch.stack(codes, dim=1)


class DAC(CodecWeights, nn.Module):
    """Public DAC codec: forward / encode / decode / from_codes / from_latents,
    the .dac container and process_audio.

    Weights are torch-default random from ``seed`` (made on the CPU, so the
    same seed gives the same weights on every device) until a checkpoint is
    loaded: ``load_dac`` / ``load_pretrained``, or by hand a folded
    descript state dict with ``load_upstream_state_dict``. The model lives
    on ``device``, "cuda" when none is given."""

    def __init__(self, config: DACConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 decoder_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config or DACConfig()
        self.compute_dtype = compute_dtype or torch.float32
        self.decoder_dtype = decoder_dtype or self.compute_dtype
        self.hop_length = self.config.hop_length
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.encoder = Encoder(self.config)
            self.quantizer = ResidualVectorQuantizer(self.config)
            self.decoder = Decoder(self.config)
        self.to(resolve_device(device))
        # the chunked stages: encoder.block[:enc_split] and
        # decoder.model[_dec_split:] (after the in-conv and the first block)
        self._stages = codec_stages(self.config.encoder_rates, self.config.decoder_rates)
        self._dec_split = 1 + min(1, len(self.config.decoder_rates))

    @property
    def device(self) -> torch.device:
        return self.quantizer.quantizers[0].codebook.weight.device

    # ----------------------------------------------------------------- compute

    def _encode_fn(self, audio: torch.Tensor, n_quantizers: int | None):
        """The encoder on padded [B, 1, T] audio in ``compute_dtype``, then
        the RVQ: (z_q, codes, latents, commitment loss, codebook loss)."""
        return self.quantizer(self.encoder(audio.to(self.compute_dtype)), n_quantizers)

    def _decode_fn(self, z_q: torch.Tensor) -> torch.Tensor:
        """The decoder on z_q [B, C, T] in ``decoder_dtype``; f32 audio."""
        return self.decoder(z_q.to(self.decoder_dtype)).to(torch.float32)

    def _forward_fn(self, audio: torch.Tensor, n_quantizers: int | None) -> dict[str, Any]:
        """Round trip on padded [B, 1, T] audio; internal [B, C, T] layouts."""
        z_q, codes, latents, commit, cb = self._encode_fn(audio, n_quantizers)
        return {"audio": self._decode_fn(z_q), "z": z_q, "codes": codes, "latents": latents,
                "vq/commitment_loss": commit, "vq/codebook_loss": cb}

    # ------------------------------------------------- chunked-batch execution

    def _auto_chunks(self, frames: int) -> int:
        """Largest chunk count (<=8) whose overlap windows still pay off."""
        return self._stages.auto_chunks(frames * self.hop_length)

    def _encoder_staged(self, audio: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """The encoder with its long-T early stages chunk-batched; exact."""
        st = self._stages
        x = audio.to(self.compute_dtype)
        plan = plan_chunks(x.shape[-1] // st.enc_ratio, n_chunks, st.enc_halo)
        if plan is None:
            return self.encoder(x)
        layers = list(self.encoder.block)
        h = run_layers(layers[: st.enc_split], split_chunks(x, plan, scale=st.enc_ratio))
        return run_layers(layers[st.enc_split:], stitch_chunks(h, plan))

    def _decode_chunked_fn(self, z_q: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """z_q [B, C, F] -> f32 audio [B, 1, F·hop]: the in-conv and first
        block on the stream (short T), the narrow long-T tail chunk-batched;
        exact (ops/chunking.py)."""
        layers = list(self.decoder.model)
        h = run_layers(layers[: self._dec_split], z_q.to(self.decoder_dtype))
        plan = plan_chunks(h.shape[-1], n_chunks, self._stages.dec_tail_halo)
        if plan is None:
            return run_layers(layers[self._dec_split:], h).to(torch.float32)
        y = run_layers(layers[self._dec_split:], split_chunks(h, plan)).to(torch.float32)
        return stitch_chunks(y, plan, scale=self._stages.dec_tail_ratio)

    def _forward_chunked_fn(self, audio: torch.Tensor, n_quantizers: int | None,
                            n_chunks: int) -> dict[str, Any]:
        """The round trip with stage-level chunking on padded [B, 1, T] audio;
        ``_forward_fn`` itself at n_chunks <= 1."""
        if n_chunks <= 1:
            return self._forward_fn(audio, n_quantizers)
        z_q, codes, latents, commit, cb = self.quantizer(self._encoder_staged(audio, n_chunks),
                                                         n_quantizers)
        return {"audio": self._decode_chunked_fn(z_q, n_chunks), "z": z_q, "codes": codes,
                "latents": latents, "vq/commitment_loss": commit, "vq/codebook_loss": cb}

    def _encode_chunked_fn(self, audio: torch.Tensor, n_quantizers: int | None,
                           n_chunks: int):
        if n_chunks <= 1:
            return self._encode_fn(audio, n_quantizers)
        return self.quantizer(self._encoder_staged(audio, n_chunks), n_quantizers)

    def draw_dropout_mask(self, batch: int, generator: torch.Generator | None = None
                          ) -> torch.Tensor:
        """[B] int counts of active RVQ stages for a training batch: the first
        int(B · quantizer_dropout) rows draw theirs from [1, Nq], the rest
        keep all Nq (n_stages + 1, as the JAX package marks them)."""
        n_stages = len(self.quantizer.quantizers)
        mask = torch.full((batch,), n_stages + 1, dtype=torch.int64)
        n_dropout = int(batch * self.config.quantizer_dropout)
        if n_dropout > 0:
            draws = torch.randint(1, n_stages + 1, (batch,), generator=generator)
            mask[:n_dropout] = draws[:n_dropout]
        return mask.to(self.device)

    def forward_train(self, audio: torch.Tensor, generator: torch.Generator | None = None
                      ) -> dict[str, Any]:
        """Training forward with quantizer dropout on padded [B, 1, T] audio,
        outputs as ``_forward_fn``'s. Every RVQ stage runs; a
        ``quantizer_dropout`` share of the rows trains with a random count
        of active stages (``draw_dropout_mask``, from ``generator``, a CPU
        generator)."""
        z = self.encoder(audio.to(self.compute_dtype))
        mask = self.draw_dropout_mask(audio.shape[0], generator)
        z_q, codes, latents, commit, cb = self.quantizer(z, None, mask)
        return {"audio": self.decoder(z_q), "z": z_q, "codes": codes, "latents": latents,
                "vq/commitment_loss": commit, "vq/codebook_loss": cb}

    # ------------------------------------------------------------- public API

    def _prepare(self, audio) -> tuple[torch.Tensor, int]:
        """[T] | [B, T] | [B, 1, T] -> padded [B, 1, T'] on the model's device,
        plus the original length."""
        a = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if a.dim() == 1:
            a = a[None, :]
        elif a.dim() == 3:
            a = a[:, 0, :]
        length = a.shape[-1]
        padded = -(-length // self.hop_length) * self.hop_length
        a = torch.nn.functional.pad(a, (0, padded - length))
        return a[:, None, :].contiguous(), length

    @torch.no_grad()
    def forward(self, audio, n_quantizers: int | None = None) -> dict[str, Any]:
        """Round trip: ``audio`` [B, T] (at most the input length), ``z``
        [B, T, C], ``codes`` [B, Nq, T], ``latents`` [B, T, Nq·D] and the two
        VQ loss values."""
        a, length = self._prepare(audio)
        out = self._forward_fn(a, n_quantizers)
        out["audio"] = out["audio"][:, 0, :length]
        out["z"] = out["z"].transpose(1, 2)
        out["latents"] = out["latents"].transpose(1, 2)
        return out

    @torch.no_grad()
    def encode(self, audio, n_quantizers: int | None = None):
        """Returns (z_q [B, T, C], codes [B, Nq, T], latents [B, T, Nq·D],
        commitment loss, codebook loss)."""
        z_q, codes, latents, commit, cb = self._encode_fn(self._prepare(audio)[0], n_quantizers)
        return z_q.transpose(1, 2), codes, latents.transpose(1, 2), commit, cb

    @torch.no_grad()
    def decode(self, z_q) -> torch.Tensor:
        """Latents [B, T, C] -> audio [B, T·hop]."""
        z_q = torch.as_tensor(z_q, dtype=torch.float32, device=self.device)
        return self._decode_fn(z_q.transpose(1, 2).contiguous())[:, 0]

    @torch.no_grad()
    def from_codes(self, codes) -> torch.Tensor:
        """Code indices [B, Nq, T] (or [Nq, T]) -> audio [B, T·hop]."""
        codes = torch.as_tensor(codes, dtype=torch.int32, device=self.device)
        if codes.dim() == 2:
            codes = codes[None]
        return self._decode_fn(self.quantizer.from_codes(codes))[:, 0]

    @torch.no_grad()
    def from_latents(self, latents) -> torch.Tensor:
        """Latents [B, T, Σ D_i] (the stages' z_e) -> audio [B, T·hop]."""
        latents = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        z_q, _ = self.quantizer.from_latents(latents.transpose(1, 2))
        return self._decode_fn(z_q)[:, 0]

    def encode_to_file(self, audio, path) -> None:
        """Encode audio and write the codes and config as a .dac artifact."""
        from neuralcodecs_tpu_torch.models.dac.dacfile import save_dac_file

        _, codes, _, _, _ = self.encode(audio)
        save_dac_file(path, [codes.cpu().numpy()], self.config)

    def decode_from_file(self, path) -> torch.Tensor:
        """Decode audio [B, T·hop] from a .dac artifact."""
        from neuralcodecs_tpu_torch.models.dac.dacfile import load_dac_file

        codes, _ = load_dac_file(path)
        return self.from_codes(np.array(codes[0]))  # a writable copy of the buffer

    def process_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Resample one clip to the model's rate on its device if needed, then
        round-trip it: [T] in (an array or a tensor), numpy [T'] out. With
        diagnostics on (``diagnostics.set_diagnostics``) it runs staged,
        encode then decode, so the context sees each phase's time, codes and
        latents."""
        from neuralcodecs_tpu_torch.diagnostics.context import get_diagnostics

        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if sample_rate != self.config.sample_rate:
            audio = resample_poly(audio, sample_rate, self.config.sample_rate)
        diag = get_diagnostics()
        if diag.enabled:
            diag.log_tensor("dac", "input", audio)
            with diag.track_scope("dac.encode"):
                z_q, codes, latents, _, _ = self.encode(audio)
                z_q = z_q.cpu().numpy()
            diag.log_tensor("dac.encode", "codes", codes)
            diag.log_tensor("dac.encode", "latents", latents)
            with diag.track_scope("dac.decode"):
                out = self.decode(z_q).cpu().numpy()
            diag.log_tensor("dac.decode", "audio_out", out)
            return out[0, : audio.shape[-1]]
        return self.forward(audio)["audio"][0].cpu().numpy()


registry.register("dac", DAC, DACConfig)  # the factory: DAC(config, device=, seed=)
