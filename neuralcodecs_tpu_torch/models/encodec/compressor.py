""".ecdc compression and decompression, raw path.

Counterpart of neuralcodecs_tpu.models.encodec.compressor without the
language model: a header, then per frame the scale block (normalising
configs) and the codes bit-packed at log2(codebook size) bits, in the order
for t, for k. The bytes equal the JAX package's for equal codes and scales.

The LM-coded path (``use_lm=True``: the Encodec language model and the
arithmetic coder) is not ported yet: ROADMAP, queue 1, "Encodec remainder".
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.exceptions import CodecError
from neuralcodecs_tpu_torch.models.encodec import ecdc
from neuralcodecs_tpu_torch.models.encodec.entropy import BitPacker, BitUnpacker

_NO_LM = ("the LM-coded .ecdc path (Encodec language model + arithmetic coder) is not "
          "ported yet: ROADMAP, queue 1, 'Encodec remainder'")


def _model_name(model) -> str:
    return f"encodec_{model.config.sample_rate // 1000}khz"


def _build_stream(model, x: np.ndarray, frames) -> bytes:
    """One .ecdc container from a waveform's encoded frames."""
    out = io.BytesIO()
    metadata = {
        "m": _model_name(model),
        "al": int(x.shape[-1]),
        "nc": int(frames[0].codes.shape[1]),
        "lm": False,
        "ch": int(x.shape[0]),
        "sr": int(model.config.sample_rate),
    }
    if model.bandwidth is not None:
        metadata["bw"] = float(model.bandwidth)
    ecdc.write_header(out, metadata)
    for codes, scale in frames:
        if scale is not None:
            ecdc.write_scale_values(out, scale.cpu().numpy().reshape(-1))
        packer = BitPacker(model.bits_per_codebook, out)
        packer.push_many(codes[0].cpu().numpy().T.reshape(-1))
        packer.flush()
    return out.getvalue()


def _check_input(model, audio) -> np.ndarray:
    x = np.asarray(audio, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise CodecError("Only single waveform can be encoded (shape [C, T])")
    if x.shape[0] != model.config.channels:
        raise CodecError(f"Expected {model.config.channels} channels, got {x.shape[0]}")
    return x


def compress(model, audio, use_lm: bool = False) -> bytes:
    """Compress one waveform ([C, T] or [T]) to .ecdc bytes."""
    return compress_batch(model, [audio], use_lm=use_lm)[0]


def compress_batch(model, audios, use_lm: bool = False) -> list[bytes]:
    """Compress independent waveforms to .ecdc bytes, one container each."""
    if use_lm:
        raise NotImplementedError(_NO_LM)
    xs = [_check_input(model, a) for a in audios]
    return [_build_stream(model, x, model.encode(x)) for x in xs]


def _parse_stream(model, data: bytes):
    """Read one raw .ecdc container -> (metadata, [(frames, scale | None)],
    [codes [n_q, frames] per chunk])."""
    stream = io.BytesIO(data)
    metadata = ecdc.read_header(stream)
    ecdc.validate_metadata(metadata)
    if bool(metadata["lm"]):
        raise NotImplementedError(_NO_LM)
    audio_length = int(metadata["al"])
    num_codebooks = int(metadata["nc"])
    if "bw" in metadata:
        model.set_target_bandwidth(float(metadata["bw"]))
    segment_length = model.segment_length or audio_length
    segment_stride = model.segment_stride or audio_length
    frame_meta, payloads = [], []
    for offset in range(0, audio_length, segment_stride):
        this_len = min(audio_length - offset, segment_length)
        frame_length = int(math.ceil(this_len * model.frame_rate / model.config.sample_rate))
        scale = None
        if model.config.normalize:
            scale = torch.tensor(ecdc.read_scale_values(stream),
                                 dtype=torch.float32).reshape(1, -1)
        codes = np.zeros((num_codebooks, frame_length), np.int64)
        unpacker = BitUnpacker(model.bits_per_codebook, stream)
        for step in range(frame_length):
            for k in range(num_codebooks):
                value = unpacker.pull()
                if value is None:
                    raise CodecError("Stream ended too soon")
                codes[k, step] = value
        payloads.append(codes)
        frame_meta.append((frame_length, scale))
    return metadata, frame_meta, payloads


def _assemble_audio(model, metadata, frame_meta, codes_list) -> torch.Tensor:
    from neuralcodecs_tpu_torch.models.encodec.model import EncodedFrame

    frames = [EncodedFrame(torch.from_numpy(c)[None], scale)
              for c, (_len, scale) in zip(codes_list, frame_meta)]
    return model.decode(frames)[..., : int(metadata["al"])]


def decompress(model, data: bytes) -> torch.Tensor:
    """Decompress raw .ecdc bytes -> audio [1, C, T]."""
    metadata, frame_meta, payloads = _parse_stream(model, data)
    return _assemble_audio(model, metadata, frame_meta, payloads)
