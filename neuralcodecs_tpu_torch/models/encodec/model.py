"""Encodec, PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.model: chunked encode (1 s
segments with 1% overlap for the 48 kHz preset), per-chunk volume
normalisation with transmitted scales, the SEANet encoder and decoder with
their SLSTMs, the plain-L2 RVQ with bandwidth → n_q selection, and the
triangular overlap-add that recombines decoded chunks.

``encode`` stacks all full chunks into one batch and runs a partial tail on
its own; ``decode`` batches equal-length frames the same way, so
``forward`` = decode(encode(x)) is the chunked round trip in two batched
passes (full chunks, tail), the eager counterpart of the JAX package's
single-program ``_stream_roundtrip_fn``. On a CUDA device each SLSTM layer
runs the LSTM kernel and each RVQ stage the codebook kernel.

The LM-coded .ecdc path takes its language model from
``get_language_model`` / ``set_language_model`` (lm.py, compressor.py);
streaming sessions of the causal 24 kHz model are in streaming.py.

Public layouts are the JAX package's: audio [T], [C, T] or [B, C, T] in,
[B, C, T] out; codes [B, n_q, frames].

Precision modes, as in the JAX package: each chunk, normalised in f32, goes
to the encoder in ``compute_dtype``; the RVQ takes f32; the decoder takes
the dequantised latents in ``decoder_dtype`` (default ``compute_dtype``,
default f32) and gives f32 audio. ``decoder_dtype=torch.bfloat16`` alone is
the mixed mode, whose codes are the f32 mode's. Parameters stay f32; each
conv casts its weight to its input's dtype and the first biased conv of a
stage promotes to f32 (ops/conv.py), so the SLSTM and the kernels see f32.
The streaming sessions and the LM path run in f32, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.core.exceptions import CodecError, LoadError
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.weights import CodecWeights, fold_weight_norm
from neuralcodecs_tpu_torch.dsp.overlap import linear_overlap_add
from neuralcodecs_tpu_torch.dsp.resample import resample_poly
from neuralcodecs_tpu_torch.models.encodec import compressor
from neuralcodecs_tpu_torch.models.encodec.config import EncodecConfig
from neuralcodecs_tpu_torch.models.encodec.lm import EncodecLanguageModel, EncodecLMConfig
from neuralcodecs_tpu_torch.models.encodec.quantize import ResidualVectorQuantizer
from neuralcodecs_tpu_torch.models.encodec.seanet import SEANetDecoder, SEANetEncoder


class EncodedFrame(NamedTuple):
    """(codes [B, n_q, frames], scale [B, 1] | None)."""

    codes: torch.Tensor
    scale: torch.Tensor | None


def normalize_source_names(sd: dict) -> dict:
    """Map the original-encodec, HF-transformers and C#-reference key
    spellings onto the port's (the JAX package's) names."""
    out = {}
    for key, value in sd.items():
        key = key.replace("encoder.model.", "encoder.layers.")
        key = key.replace("decoder.model.", "decoder.layers.")
        # time_group_norm checkpoints nest the GroupNorm under the
        # Norm(Conv) wrapper: NormConv1d.norm -> the flat ".norm."
        key = key.replace(".conv.norm.", ".norm.")
        key = key.replace(".convtr.norm.", ".norm.")
        key = key.replace(".conv.conv.", ".conv.")
        key = key.replace(".convtr.convtr.", ".conv.")
        key = key.replace("quantizer.vq.layers.", "quantizer.layers.")
        key = key.replace("._codebook.", ".codebook.")
        out[key] = value
    return out


class Encodec(CodecWeights, nn.Module):
    """Public Encodec codec: encode / decode / forward / process_audio and
    the .ecdc compress / decompress, raw or LM-coded.

    Weights are torch-default random from ``seed`` (made on the CPU, so the
    same seed gives the same weights on every device) until a checkpoint is
    loaded: ``load_encodec`` / ``load_pretrained``, or by hand the port's
    own names with ``load_state_dict``, upstream or HF spellings with
    ``load_upstream_state_dict``. The model lives on ``device``, "cuda"
    when none is given."""

    def __init__(self, config: EncodecConfig | None = None, *,
                 device: torch.device | str | None = None, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 decoder_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype or torch.float32
        self.decoder_dtype = decoder_dtype or self.compute_dtype
        self.config = cfg = config or EncodecConfig()
        if cfg.bandwidth is not None and cfg.bandwidth not in cfg.target_bandwidths:
            raise CodecError(f"Invalid bandwidth {cfg.bandwidth}. "
                             f"Select one of {cfg.target_bandwidths}")
        self.bandwidth = cfg.bandwidth
        seanet = dict(channels=cfg.channels, dimension=cfg.hidden_size,
                      n_filters=cfg.num_filters, n_residual_layers=cfg.num_residual_layers,
                      ratios=cfg.upsampling_ratios, kernel_size=cfg.kernel_size,
                      last_kernel_size=cfg.last_kernel_size,
                      residual_kernel_size=cfg.residual_kernel_size,
                      dilation_base=cfg.dilation_growth_rate, causal=cfg.use_causal_conv,
                      norm_type=cfg.norm_type, pad_mode=cfg.pad_mode,
                      compress=cfg.compress, lstm=cfg.num_lstm_layers)
        self.frame_rate = math.ceil(cfg.sample_rate / cfg.hop_length)
        # nQ = 1000·max(bw) / (ceil(sr/hop)·10), at least 1
        n_q = max(1, int(1000 * max(cfg.target_bandwidths) / (self.frame_rate * 10)))
        self.bits_per_codebook = int(math.log2(cfg.codebook_size))
        if 2 ** self.bits_per_codebook != cfg.codebook_size:
            raise CodecError("Quantizer bins must be a power of 2")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.encoder = SEANetEncoder(**seanet)
            self.decoder = SEANetDecoder(**seanet, trim_right_ratio=cfg.trim_right_ratio)
            self.quantizer = ResidualVectorQuantizer(cfg.codebook_dim, n_q, cfg.codebook_size)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------ state

    @property
    def device(self) -> torch.device:
        return self.quantizer.layers[0].codebook.embed.device

    def release_graphs(self) -> None:
        """Drop the streaming sessions' captured pushes (streaming.py)."""
        self.__dict__["_graph_cache"] = None

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda() ...: the captured pushes read the old storage
        self.release_graphs()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self.release_graphs()
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    @property
    def num_codebooks(self) -> int:
        return self.quantizer.num_quantizers

    @property
    def segment_length(self) -> int | None:
        return self.config.chunk_length

    @property
    def segment_stride(self) -> int | None:
        return self.config.chunk_stride

    def load_upstream_state_dict(self, sd: dict) -> "Encodec":
        """Load an original-encodec or HF-transformers state dict: rename the
        keys, fold weight norm, fill the codebook training buffers a
        checkpoint may omit, then load: keys the port has no slot for are
        dropped, as the JAX loader drops them; a missing one raises
        LoadError."""
        sd = fold_weight_norm({k: np.asarray(v) for k, v in normalize_source_names(sd).items()})
        for i in range(self.num_codebooks):
            prefix = f"quantizer.layers.{i}.codebook."
            embed = sd.get(prefix + "embed")
            if embed is not None:  # else the load names the missing key
                sd.setdefault(prefix + "embed_avg", embed)
                sd.setdefault(prefix + "cluster_size", np.zeros(embed.shape[0], np.float32))
                sd.setdefault(prefix + "inited", np.ones(1, np.float32))
        return super().load_upstream_state_dict(sd)

    def set_target_bandwidth(self, bandwidth: float) -> None:
        if bandwidth not in self.config.target_bandwidths:
            raise CodecError(
                f"This model doesn't support the bandwidth {bandwidth} kbps. "
                f"Select one of {self.config.target_bandwidths} kbps")
        self.bandwidth = bandwidth

    def _n_q(self) -> int:
        return self.quantizer.num_quantizers_for_bandwidth(self.frame_rate, self.bandwidth)

    # ----------------------------------------------------------------- compute

    def _normalize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Per-chunk volume normalisation of [N, C, T]: (x / scale, scale [N, 1])."""
        if not self.config.normalize:
            return x, None
        mono = torch.mean(x, dim=1, keepdim=True)                          # [N, 1, T]
        scale = torch.sqrt(torch.mean(mono ** 2, dim=-1, keepdim=True)) + 1e-8
        return x / scale, scale[:, :, 0]

    def _encode_frame(self, x: torch.Tensor, n_q: int) -> EncodedFrame:
        """x [N, C, T] -> codes [N, n_q, frames], scale [N, 1] | None."""
        x, scale = self._normalize(x)
        emb = self.encoder(x.to(self.compute_dtype)).to(torch.float32)
        return EncodedFrame(self.quantizer.encode(emb, n_q), scale)

    def _decode_frame(self, codes: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
        """codes [N, n_q, frames] -> audio [N, C, T]."""
        emb = self.quantizer.decode(codes).to(self.decoder_dtype)
        out = self.decoder(emb).to(torch.float32)
        return out if scale is None else out * scale[:, :, None]

    # ------------------------------------------------------------- public API

    def _prepare(self, audio) -> torch.Tensor:
        """[T], [C, T] or [B, C, T] -> [B, C, T] f32 on the model's device."""
        a = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if a.dim() == 1:
            a = a[None, None, :]
        elif a.dim() == 2:
            a = a[None, :, :]
        if a.shape[1] != self.config.channels:
            raise CodecError(f"Expected {self.config.channels} channels, got {a.shape[1]}")
        return a

    @torch.no_grad()
    def encode(self, audio) -> list[EncodedFrame]:
        """Audio -> one EncodedFrame per chunk: all full chunks through one
        batched call, a partial tail through a second."""
        x = self._prepare(audio)
        batch, length = x.shape[0], x.shape[-1]
        segment = self.segment_length or length
        stride = self.segment_stride or length
        n_q = self._n_q()
        offsets = list(range(0, length, stride))
        full = [o for o in offsets if o + segment <= length]
        frames: dict[int, EncodedFrame] = {}
        if full:
            codes, scale = self._encode_frame(
                torch.cat([x[..., o: o + segment] for o in full]), n_q)
            for i, offset in enumerate(full):
                sl = slice(i * batch, (i + 1) * batch)
                frames[offset] = EncodedFrame(codes[sl], None if scale is None else scale[sl])
        for offset in offsets:
            if offset not in frames:
                frames[offset] = self._encode_frame(x[..., offset:], n_q)
        return [frames[o] for o in offsets]

    @torch.no_grad()
    def decode(self, frames: Sequence[EncodedFrame]) -> torch.Tensor:
        """Encoded frames -> audio [B, C, T]; equal-length frames are decoded
        as one batch, then recombined by overlap-add."""
        if not frames:
            raise CodecError("No frames provided to decode")
        frames = [EncodedFrame(torch.as_tensor(f.codes, device=self.device),
                               None if f.scale is None else
                               torch.as_tensor(f.scale, dtype=torch.float32, device=self.device))
                  for f in frames]
        if self.segment_length is None:
            if len(frames) != 1:
                raise CodecError("Expected single frame when no segmentation is used")
            return self._decode_frame(*frames[0])
        decoded: list = [None] * len(frames)
        by_len: dict[int, list[int]] = {}
        for i, f in enumerate(frames):
            by_len.setdefault(f.codes.shape[-1], []).append(i)
        for idx in by_len.values():
            group = [frames[i] for i in idx]
            batch = group[0].codes.shape[0]
            scale = (None if group[0].scale is None
                     else torch.cat([f.scale for f in group]))
            out = self._decode_frame(torch.cat([f.codes for f in group]), scale)
            for j, i in enumerate(idx):
                decoded[i] = out[j * batch: (j + 1) * batch]
        return linear_overlap_add(decoded, self.segment_stride)

    @torch.no_grad()
    def forward(self, audio) -> torch.Tensor:
        """Round trip, trimmed to the input length: [B, C, T]."""
        x = self._prepare(audio)
        return self.decode(self.encode(x))[..., : x.shape[-1]]

    def process_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """[T] or [C, T] at any rate -> the model's channel layout at its
        rate: [C, T] for the stereo preset (a mono input is duplicated across
        channels), [T] for the mono one."""
        audio = torch.as_tensor(np.asarray(audio, dtype=np.float32), device=self.device)
        if sample_rate != self.config.sample_rate:
            audio = resample_poly(audio, sample_rate, self.config.sample_rate)
        channels = self.config.channels
        if channels > 1 and (audio.dim() == 1 or audio.shape[0] == 1):
            audio = audio.reshape(1, -1).expand(channels, -1)
        return self._squeeze_out(self.forward(audio).cpu().numpy())

    @staticmethod
    def _squeeze_out(out: np.ndarray) -> np.ndarray:
        """[B, C, T] -> [C, T] (stereo) or [T] (mono)."""
        if out.ndim == 3:
            return out[0] if out.shape[1] > 1 else out[0, 0]
        return out

    # ---- language model ----------------------------------------------------

    _LM_CHECKPOINTS = {
        24000: "https://dl.fbaipublicfiles.com/encodec/v0/encodec_lm_24khz-1608e3c0.th",
        48000: "https://dl.fbaipublicfiles.com/encodec/v0/encodec_lm_48khz-7add9fc3.th",
    }

    def get_language_model(self, download: bool = True) -> EncodecLanguageModel:
        """The LM the LM-coded .ecdc path uses: the one ``set_language_model``
        gave, else one built on first use, on the model's device, at the
        pretrained LM's width (dimension 200, 8 heads, 5 layers, 3.5 s of
        past context). With ``download`` and a preset that has a pretrained
        LM, its checkpoint comes through the loader's cache (fetched on a
        miss) and loads into it; any failure raises LoadError rather than
        code against an untrained LM that peers holding the real weights
        could not decode. ``download=False`` keeps the seeded LM."""
        lm = self.__dict__.get("_lm")
        if lm is not None:
            return lm
        lm = EncodecLanguageModel(EncodecLMConfig(
            codebook_size=self.config.codebook_size, num_codebooks=self.num_codebooks,
            dimension=200, num_heads=8, num_layers=5,
            past_context=int(3.5 * self.frame_rate)), device=self.device).eval()
        url = self._LM_CHECKPOINTS.get(self.config.sample_rate)
        if download and url is not None:
            from neuralcodecs_tpu_torch.core.importer import import_checkpoint
            from neuralcodecs_tpu_torch.core.loader import LoadOptions, ModelLoader

            try:
                lm.load_state_dict(import_checkpoint(ModelLoader().resolve(url, LoadOptions())))
            except Exception as exc:
                raise LoadError(
                    f"Pretrained Encodec LM could not be loaded from {url}; refusing to "
                    "continue with an untrained LM (its streams would not decode on peers "
                    "holding the real weights). Pass download=False or call "
                    "set_language_model() to use an untrained LM") from exc
        self.set_language_model(lm)
        return lm

    def set_language_model(self, lm) -> None:
        # kept out of the module tree: the LM is not part of the codec's state dict
        self.__dict__["_lm"] = lm

    # ---- .ecdc --------------------------------------------------------------

    def compress(self, audio, use_lm: bool = False, lm=None, lm_batch: int = 1) -> bytes:
        """Compress one waveform to .ecdc bytes: bit-packed codes, or with
        ``use_lm`` range-coded against the language model's pdfs."""
        return compressor.compress(self, audio, use_lm=use_lm, lm=lm, lm_batch=lm_batch)

    def compress_batch(self, audios, use_lm: bool = False, lm=None,
                       lm_batch: int | None = None) -> list[bytes]:
        """Compress independent waveforms, sharing each LM step across them."""
        return compressor.compress_batch(self, audios, use_lm=use_lm, lm=lm, lm_batch=lm_batch)

    def decompress(self, data: bytes, lm=None) -> torch.Tensor:
        """.ecdc bytes -> audio [1, C, T]."""
        return compressor.decompress(self, data, lm=lm)

    def decompress_batch(self, blobs, lm=None) -> list[torch.Tensor]:
        return compressor.decompress_batch(self, blobs, lm=lm)


registry.register("encodec", Encodec, EncodecConfig)  # the factory: Encodec(config, device=, seed=)
