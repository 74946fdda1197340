""".ecdc compression and decompression.

Counterpart of neuralcodecs_tpu.models.encodec.compressor: a header, then
per frame the scale block (normalising configs) and the payload. Two
payload codecs:
  * bit packing (no LM): the codes at log2(codebook size) bits, in the
    order for t, for k. The bytes equal the JAX package's for equal codes
    and scales.
  * LM + range coding: each frame's codes are range-coded against the pdfs
    the Encodec language model (lm.py) predicts step by step. The CDFs are
    built on the host in numpy and the symbols coded by the native C++
    coder (native/entropy_native.py).

An LM stream decodes only through the same arithmetic that wrote it: the
CDF quantisation turns any difference in a pdf bit into a different CDF
entry with a sizeable probability, and the stream then desyncs. So encode
and decode walk the same ``lm.step`` path at the same executable batch
shape on the same device. Independent streams (and the frames of one
segmented stream: the LM state resets per frame) share each step as rows
of one batched call. The LM is row-local, so a row's pdfs do not depend on
the other rows' contents (real co-streams when encoding, zero padding when
decoding), but they may depend on the batch shape. The shape used to encode
is recorded in the header (``lmb``) and decode replays it. Streams without
the marker decode on the one-row path, so older files and the goldens stay
bit-identical. Given the JAX LM's pdfs the bytes equal the JAX package's.
"""

from __future__ import annotations

import io
import math
import struct

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.exceptions import CodecError
from neuralcodecs_tpu_torch.models.encodec import ecdc
from neuralcodecs_tpu_torch.models.encodec.entropy import (
    BitPacker,
    BitUnpacker,
    build_stable_quantized_cdf_batch,
)
from neuralcodecs_tpu_torch.native.entropy_native import NativeArithmeticDecoder, encode_symbols

# executable-batch ceiling for grouped LM coding by default: past this the
# per-step host work (CDF build + range coding) outweighs the shared step
DEFAULT_MAX_LM_BATCH = 16

# hard ceiling on the executable LM batch shape, enforced on encode (so every
# stream written is one that will be read back) and on decode, where "lmb"
# comes from an untrusted header and sizes lm.init_state and the per-step
# buffers (~1 MB of LM state a row for the 24 kHz LM)
MAX_LM_BATCH = 64

# teacher-forced encode steps whose pdfs stay on the device before one copy
# to the host
PDF_WINDOW = 64


def _lmb_from_metadata(metadata) -> int:
    """Validated executable LM batch shape from an untrusted .ecdc header."""
    raw = metadata.get("lmb", 1)
    try:
        lmb = int(raw)
    except (TypeError, ValueError):
        raise CodecError(f"Invalid 'lmb' in stream header: {raw!r}")
    if not 1 <= lmb <= MAX_LM_BATCH:
        raise CodecError(f"'lmb' in stream header out of range [1, {MAX_LM_BATCH}]: {lmb}")
    return lmb


def _model_name(model) -> str:
    return f"encodec_{model.config.sample_rate // 1000}khz"


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _lm_encode_entries(lm, entries: list[np.ndarray], lmb: int) -> list[bytes]:
    """Range-code independent code streams through the LM in batches.

    entries: [K, T_i] int code arrays of equal K; each group of <= ``lmb``
    entries shares one batch-``lmb`` LM loop (a shorter row idles on padding
    once done). Returns one payload per entry. Encoding is teacher-forced:
    every step's input comes from the known codes, so the whole group's
    inputs go to the device at once and the pdfs stay there for
    ``PDF_WINDOW`` steps before each copy to the host.
    """
    k = entries[0].shape[0]
    if any(c.shape[0] != k for c in entries):
        raise CodecError("All streams in one batch must share n_q")
    payloads: list[bytes] = []
    for g0 in range(0, len(entries), lmb):
        group = entries[g0:g0 + lmb]
        max_t = max(c.shape[1] for c in group)
        # step t's input holds the codes of step t-1, +1; step 0's and a
        # finished row's are padding
        inputs = np.zeros((max_t, lmb, k, 1), np.int64)
        for j, codes in enumerate(group):
            n = min(codes.shape[1], max_t - 1)
            inputs[1:n + 1, j, :, 0] = codes[:, :n].T + 1
        inputs = torch.as_tensor(inputs, device=lm.device)
        state = lm.init_state(lmb)
        pending, fetched = [], []
        for step in range(max_t):
            probas, state = lm.step(inputs[step], state)
            # the LM predicts all its codebooks (32 for the 24 kHz LM); keep
            # the k the stream carries
            pending.append(probas[:, :, :k, 0])                         # [lmb, card, k]
            if len(pending) == PDF_WINDOW:
                fetched.append(torch.stack(pending).cpu().numpy())
                pending = []
        if pending:
            fetched.append(torch.stack(pending).cpu().numpy())
        pdfs_all = np.concatenate(fetched)                              # [T, lmb, card, k]
        for j, codes in enumerate(group):
            t_j = codes.shape[1]
            pdfs = pdfs_all[:t_j, j].transpose(0, 2, 1).reshape(t_j * k, -1)  # (t, k) order
            cdfs = build_stable_quantized_cdf_batch(pdfs, 24)
            payloads.append(encode_symbols(cdfs, codes.T.reshape(-1), 24))
    return payloads


def _lm_decode_entries(lm, payloads: list[bytes], lengths: list[int],
                       k: int, lmb: int) -> list[np.ndarray]:
    """Inverse of ``_lm_encode_entries`` at the same executable shape: one
    copy to the host a step, and each row feeds back its own decoded
    symbols, so the pdfs repeat the encoder's bit for bit."""
    out = [np.zeros((k, t), np.int64) for t in lengths]
    for g0 in range(0, len(payloads), lmb):
        idxs = list(range(g0, min(g0 + lmb, len(payloads))))
        decoders = [NativeArithmeticDecoder(payloads[i], 24) for i in idxs]
        try:
            state = lm.init_state(lmb)
            inp = np.zeros((lmb, k, 1), np.int64)
            for step in range(max(lengths[i] for i in idxs)):
                probas, state = lm.step(inp, state)
                # slice to the streamed codebooks on the device, before the
                # copy (the 24 kHz LM predicts 32, a 6 kbps stream has 8)
                p = probas[:, :, :k, 0].cpu().numpy()                  # [lmb, card, k]
                inp = np.zeros((lmb, k, 1), np.int64)
                for j, i in enumerate(idxs):
                    if step < lengths[i]:
                        cdfs = build_stable_quantized_cdf_batch(p[j].T, 24)
                        out[i][:, step] = decoders[j].pull_many(cdfs)
                        inp[j, :, 0] = out[i][:, step] + 1
        finally:
            for d in decoders:
                d.close()
    return out


def _build_stream(model, x, frames, use_lm: bool,
                  payloads: list[bytes] | None, lmb: int) -> bytes:
    """One .ecdc container from a waveform's encoded frames (+ LM payloads)."""
    out = io.BytesIO()
    metadata = {
        "m": _model_name(model),
        "al": int(x.shape[-1]),
        "nc": int(frames[0].codes.shape[1]),
        "lm": bool(use_lm),
        "ch": int(x.shape[0]),
        "sr": int(model.config.sample_rate),
    }
    if model.bandwidth is not None:
        metadata["bw"] = float(model.bandwidth)
    if use_lm and model.segment_length is not None:
        # segmented LM streams length-prefix each frame's payload: the range
        # decoder cannot know the encoder's flush bytes, so payloads back to
        # back are not self-delimiting. The reference format has no prefix;
        # the marker keeps readers from mis-parsing such a stream.
        metadata["lp"] = True
    if use_lm and lmb > 1:
        metadata["lmb"] = int(lmb)  # the executable LM batch decode replays
    ecdc.write_header(out, metadata)
    for fi, (codes, scale) in enumerate(frames):
        if scale is not None:
            ecdc.write_scale_values(out, scale.cpu().numpy().reshape(-1))
        if use_lm:
            if model.segment_length is not None:
                out.write(struct.pack(">I", len(payloads[fi])))
            out.write(payloads[fi])
        else:
            packer = BitPacker(model.bits_per_codebook, out)
            packer.push_many(codes[0].cpu().numpy().T.reshape(-1))
            packer.flush()
    return out.getvalue()


def _check_input(model, audio):
    """One waveform as [C, T] f32: a tensor stays a tensor on its device
    (a server's prepared audio), anything else becomes a numpy array."""
    x = (audio.to(torch.float32) if isinstance(audio, torch.Tensor)
         else np.asarray(audio, np.float32))
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise CodecError("Only single waveform can be encoded (shape [C, T])")
    if x.shape[0] != model.config.channels:
        raise CodecError(f"Expected {model.config.channels} channels, got {x.shape[0]}")
    return x


def compress(model, audio, use_lm: bool = False, lm=None, lm_batch: int = 1) -> bytes:
    """Compress one waveform ([C, T] or [T]) to .ecdc bytes. ``lm_batch > 1``
    codes the frames of a segmented stream that many rows at a time."""
    return compress_batch(model, [audio], use_lm=use_lm, lm=lm, lm_batch=lm_batch)[0]


def compress_batch(model, audios, use_lm: bool = False, lm=None,
                   lm_batch: int | None = None) -> list[bytes]:
    """Compress independent waveforms to .ecdc bytes, one container each.

    With the LM every (stream, frame) pair is an independent entropy stream,
    coded ``lm_batch`` at a time through one batched LM step a time step;
    by default ``min(next_pow2(entries), DEFAULT_MAX_LM_BATCH)`` when more
    than one entry is in flight."""
    xs = [_check_input(model, a) for a in audios]
    if not xs:
        return []
    if use_lm and lm is None:
        lm = model.get_language_model()
    per_stream_frames = [model.encode(x) for x in xs]
    if not use_lm:
        return [_build_stream(model, x, frames, False, None, 1)
                for x, frames in zip(xs, per_stream_frames)]
    entries = [codes[0].cpu().numpy() for frames in per_stream_frames
               for codes, _scale in frames]                             # [K, T] each
    if lm_batch is None:
        lm_batch = min(_next_pow2(len(entries)), DEFAULT_MAX_LM_BATCH) if len(entries) > 1 else 1
    if not 1 <= lm_batch <= MAX_LM_BATCH:
        raise CodecError(f"lm_batch must be in [1, {MAX_LM_BATCH}], got {lm_batch}")
    payloads = _lm_encode_entries(lm, entries, lm_batch)
    blobs, fi = [], 0
    for x, frames in zip(xs, per_stream_frames):
        blobs.append(_build_stream(model, x, frames, True, payloads[fi:fi + len(frames)],
                                   lm_batch))
        fi += len(frames)
    return blobs


def _parse_stream(model, data: bytes):
    """Read one .ecdc container -> (metadata, [(frames, scale | None)],
    [payload bytes (LM) or codes [n_q, frames] (raw) per chunk])."""
    stream = io.BytesIO(data)
    metadata = ecdc.read_header(stream)
    ecdc.validate_metadata(metadata)
    audio_length = int(metadata["al"])
    num_codebooks = int(metadata["nc"])
    use_lm = bool(metadata["lm"])
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
        if use_lm:
            if model.segment_length is not None:
                if not metadata.get("lp"):
                    raise CodecError("Segmented LM stream without the 'lp' length-prefix "
                                     "marker: produced by an incompatible writer")
                raw = stream.read(4)
                if len(raw) != 4:
                    raise CodecError("Stream ended too soon")
                (payload_len,) = struct.unpack(">I", raw)
                payloads.append(stream.read(payload_len))
            else:
                payloads.append(stream.read())
        else:
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


def decompress(model, data: bytes, lm=None) -> torch.Tensor:
    """Decompress .ecdc bytes -> audio [1, C, T]."""
    metadata, frame_meta, payloads = _parse_stream(model, data)
    if not bool(metadata["lm"]):
        return _assemble_audio(model, metadata, frame_meta, payloads)
    lmb = _lmb_from_metadata(metadata)
    if lm is None:
        lm = model.get_language_model()
    codes_list = _lm_decode_entries(lm, payloads, [fl for fl, _ in frame_meta],
                                    int(metadata["nc"]), lmb)
    return _assemble_audio(model, metadata, frame_meta, codes_list)


def decompress_batch(model, blobs, lm=None) -> list[torch.Tensor]:
    """Decompress independent .ecdc byte strings, sharing the LM loop: LM
    frames are grouped by their recorded batch shape and n_q, and every
    step of a group serves up to ``lmb`` frames across all the blobs."""
    parsed = [_parse_stream(model, b) for b in blobs]
    groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for bi, (metadata, frame_meta, _payloads) in enumerate(parsed):
        if bool(metadata["lm"]):
            key = (_lmb_from_metadata(metadata), int(metadata["nc"]))
            groups.setdefault(key, []).extend((bi, fi) for fi in range(len(frame_meta)))
    if groups and lm is None:
        lm = model.get_language_model()
    decoded: dict[tuple[int, int], np.ndarray] = {}
    for (lmb, k), members in groups.items():
        codes = _lm_decode_entries(lm, [parsed[bi][2][fi] for bi, fi in members],
                                   [parsed[bi][1][fi][0] for bi, fi in members], k, lmb)
        decoded.update(zip(members, codes))
    outs = []
    for bi, (metadata, frame_meta, payloads) in enumerate(parsed):
        codes_list = ([decoded[(bi, fi)] for fi in range(len(frame_meta))]
                      if bool(metadata["lm"]) else payloads)
        # restore this blob's bandwidth: the parse pass may have switched it
        if "bw" in metadata:
            model.set_target_bandwidth(float(metadata["bw"]))
        outs.append(_assemble_audio(model, metadata, frame_meta, codes_list))
    return outs
