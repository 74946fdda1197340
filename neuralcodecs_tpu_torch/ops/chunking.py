"""Exact chunked-batch execution for the conv codecs (SNAC, DAC).

Counterpart of neuralcodecs_tpu.ops.chunking. A codec's long-T, narrow-C
stages (the encoder's in-conv and first blocks, the decoder's tail after
its first block) run once on n overlapping windows of the stream, batched
on the leading axis, and the windows' cores are stitched back; the deep
stages (LocalMHA, the RVQ) see the whole stream. The plan math is plain
Python, copied from the JAX package; ``split_chunks`` / ``stitch_chunks``
work on the time axis of the port's [B, C, T] layout, chunk-major as in
JAX, and return contiguous tensors (the residual-unit kernels take no
other).

Why the result is exact: a conv is translation-equivariant on its stride
lattice, so a window whose core is flanked by a halo at least as wide as
the stage's receptive field computes the same interior values as the whole
stream. Edge windows are clamped to the stream's ends (no zero-filled
halo), so the first and last cores see the same zero padding as the
unchunked stream: the stitched output is the same function, not an
approximation. Bit for bit it may differ only where a library conv picks
another algorithm for the windows' shape than for the stream's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ChunkPlan:
    """Static slicing plan: n equal windows of ``length`` covering ``total``
    with per-window core [core_off, core_off + core_len) mapping to absolute
    [abs_start, abs_start + core_len)."""

    total: int
    length: int
    starts: tuple[int, ...]       # window start per chunk
    core_offs: tuple[int, ...]    # core start within the window
    core_lens: tuple[int, ...]
    abs_starts: tuple[int, ...]


def plan_chunks(total: int, n_chunks: int, halo: int,
                align: int = 1) -> ChunkPlan | None:
    """Build a chunk plan over ``total`` frames; None if chunking is not
    worthwhile/possible (windows would overlap more than they cover).

    ``align``: core boundaries and window starts land on multiples of this
    (stride-lattice alignment so conv phases match the unchunked stream).
    """
    if n_chunks <= 1 or total <= 0:
        return None
    halo = -(-halo // align) * align
    core = -(-total // n_chunks)          # ceil(total / n)
    core = -(-core // align) * align      # ceil to the stride lattice
    length = core + 2 * halo
    if length >= total:
        return None
    # halo redundancy guard: chunking must not inflate compute >1.5x
    if n_chunks * length > 1.5 * total:
        return None
    starts, core_offs, core_lens, abs_starts = [], [], [], []
    for i in range(n_chunks):
        abs_start = i * core
        core_len = min(core, total - abs_start)
        if core_len <= 0:
            # degenerate tail chunk: keep shapes static by duplicating the
            # last window with an empty core
            starts.append(total - length)
            core_offs.append(0)
            core_lens.append(0)
            abs_starts.append(total)
            continue
        w = min(max(abs_start - halo, 0), total - length)
        starts.append(w)
        core_offs.append(abs_start - w)
        core_lens.append(core_len)
        abs_starts.append(abs_start)
    return ChunkPlan(total, length, tuple(starts), tuple(core_offs),
                     tuple(core_lens), tuple(abs_starts))


def split_chunks(x: torch.Tensor, plan: ChunkPlan, scale: int = 1) -> torch.Tensor:
    """x: [B, C, T] with T == plan.total*scale -> [n*B, C, plan.length*scale].

    Each stream in the batch is chunked with the same plan; chunks are
    stacked chunk-major so ``stitch_chunks`` can reassemble per stream.
    """
    width = plan.length * scale
    return torch.cat([x[..., s * scale: s * scale + width] for s in plan.starts], dim=0)


def stitch_chunks(y: torch.Tensor, plan: ChunkPlan, scale: int = 1) -> torch.Tensor:
    """y: [n*B, C, plan.length*scale] -> [B, C, plan.total*scale] from the
    cores (a degenerate tail window's empty core is skipped)."""
    b = y.shape[0] // len(plan.starts)
    return torch.cat([y[i * b: (i + 1) * b, :, off * scale: (off + n) * scale]
                      for i, (off, n) in enumerate(zip(plan.core_offs, plan.core_lens))
                      if n], dim=-1)


def conv_stack_receptive_field(first_kernel: int, rates: list[int],
                               res_dilations: tuple[int, ...] = (1, 3, 9),
                               res_kernel: int = 7,
                               last_kernel: int | None = 3) -> int:
    """One-sided receptive field (in input samples) of a SNAC/DAC-style
    encoder prefix: k7 in-conv, per-rate blocks of dilated residual units +
    a strided conv, then an optional final conv (None = stack ends after the
    last block). Conservative (counts full kernel extents)."""
    rf = (first_kernel - 1) // 2
    f = 1
    res_extent = sum((res_kernel - 1) * d // 2 for d in res_dilations)
    for s in rates:
        rf += f * res_extent
        rf += f * (2 * s)  # strided conv k=2s (one-sided extent <= 2s-1)
        f *= s
    if last_kernel is not None:
        rf += f * ((last_kernel - 1) // 2 + 1)
    return rf


def decoder_receptive_field_frames(rates: list[int],
                                   res_dilations: tuple[int, ...] = (1, 3, 9),
                                   res_kernel: int = 7,
                                   include_input_conv: bool = True) -> int:
    """One-sided receptive field of a SNAC/DAC-style decoder (suffix),
    measured in frames at the input resolution of the given ``rates``.
    ``include_input_conv=False`` for a decoder TAIL that starts directly at
    a transpose-conv block. Conservative."""
    rf = (res_kernel - 1) / 2 if include_input_conv else 0.0
    u = 1.0
    res_extent = sum((res_kernel - 1) * d // 2 for d in res_dilations)
    for s in rates:
        # transpose conv k=2s stride s: each output depends on <=2 input
        # frames (kernel/stride), i.e. one-sided extent 2/u latent frames
        rf += 2.0 / u
        u *= s
        rf += res_extent / u
    rf += res_kernel / u
    return int(rf) + 2


@dataclass(frozen=True)
class CodecStages:
    """Where a SNAC/DAC-style codec runs chunked, and JAX's rule for n.

    ``encoder.block[:enc_split]`` (the in-conv and every block but the last)
    runs on windows; its output is at 1/``enc_ratio`` of the sample rate,
    with a halo of ``enc_halo`` frames there. The decoder after its first
    block runs on windows of its input, ``dec_head_ratio`` frames a latent
    frame and ``dec_tail_ratio`` output samples a frame, with a halo of
    ``dec_tail_halo`` frames."""

    hop: int
    enc_split: int
    enc_ratio: int
    enc_halo: int
    dec_head_ratio: int
    dec_tail_halo: int

    @property
    def dec_tail_ratio(self) -> int:
        return self.hop // self.dec_head_ratio

    def auto_chunks(self, samples: int) -> int:
        """Largest chunk count (<=8) whose overlap windows still pay off for
        ``samples`` (a multiple of the hop)."""
        for n in (8, 4, 2):
            enc_ok = plan_chunks(samples // self.enc_ratio, n, self.enc_halo) is not None
            dec_ok = plan_chunks(samples // self.hop * self.dec_head_ratio,
                                 n, self.dec_tail_halo) is not None
            if enc_ok and dec_ok:
                return n
        return 1


def codec_stages(encoder_rates: list[int], decoder_rates: list[int]) -> CodecStages:
    """The chunked stages of a codec with these rates (the JAX models'
    ``_enc_early_*`` / ``_dec_*`` attributes)."""
    n_early = max(len(encoder_rates) - 1, 0)
    enc_ratio = math.prod(encoder_rates[:n_early])
    rf_early = conv_stack_receptive_field(7, list(encoder_rates[:n_early]), last_kernel=None)
    return CodecStages(
        hop=math.prod(encoder_rates), enc_split=1 + n_early, enc_ratio=enc_ratio,
        enc_halo=-(-rf_early // enc_ratio) + 2,
        dec_head_ratio=decoder_rates[0] if decoder_rates else 1,
        dec_tail_halo=decoder_receptive_field_frames(list(decoder_rates[1:]),
                                                     include_input_conv=False))
