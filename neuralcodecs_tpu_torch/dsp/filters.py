"""Recursive (IIR) and FIR filter primitives (counterpart of
neuralcodecs_tpu.dsp.filters).

Every function takes [..., T] and works on the rows of its [N, T] flattening.
``biquad`` and ``one_pole_follower`` are the two recurrences with a TPU
kernel in the JAX package; here they go to the CUDA kernels of
``ops/kernels`` (``biquad_df2t``, ``envelope_follow``), which run their plain
loops on CPU tensors. ``biquad_cascade`` runs 1 or 2 biquads back to back in
one kernel call (the K-weighting's two). On the card the envelope follower
is bit-exact against its loop; the biquad kernel is a chunked scan, as
accurate as its loop against the exact filter but not bit-equal to it past
one chunk (see ops/kernels/biquad.py). ``comb_filter``, ``allpass_filter``
and ``variable_delay_line`` had no kernel in JAX and are plain PyTorch loops
over T, with the scan's expressions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Direct-form-II-transposed biquad over the last axis; b: 3 numerator
    and a: 3 denominator coefficients, a[0] == 1."""
    return biquad_cascade(x, [(b, a)])


def biquad_cascade(x: torch.Tensor, sections) -> torch.Tensor:
    """The biquads ``sections`` = [(b, a), ...] (1 or 2) one after the other
    over the last axis, in one kernel call."""
    return biquad_df2t(_rows(x), sections).reshape(x.shape)


def fir_filter(x: torch.Tensor, h, padding: int | None = None) -> torch.Tensor:
    """FIR filtering of [..., T] by convolution with h (symmetric zero
    padding, taps // 2 unless given)."""
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    pad = h.shape[0] // 2 if padding is None else padding
    y = F.conv1d(_rows(x)[:, None, :], h.flip(0)[None, None, :], padding=pad)[:, 0]
    return y.reshape(*x.shape[:-1], -1)


def one_pole_follower(x: torch.Tensor, attack_gain: float, release_gain: float) -> torch.Tensor:
    """Envelope follower over |x|: level += g·(|x| − level), g the attack or
    release gain as |x| rises above the level or not; level starts at 0."""
    return envelope_follow(_rows(x), attack_gain, release_gain).reshape(x.shape)


def comb_filter(x: torch.Tensor, delay: int, feedback: float,
                damping: float = 0.0) -> torch.Tensor:
    """Feedback comb filter with a one-pole damping low-pass in the loop
    (Schroeder reverberator comb); circular buffer of ``delay`` samples."""
    xt = _rows(x).t()  # [T, N]
    buf = xt.new_zeros(delay, xt.shape[1])
    last = xt.new_zeros(xt.shape[1])
    ys = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        ptr = t % delay
        out = buf[ptr] * (1.0 - damping) + last * damping
        buf[ptr] = xt[t] + out * feedback
        ys[t] = last = out
    return ys.t().reshape(x.shape)


def allpass_filter(x: torch.Tensor, delay: int, feedback: float = 0.5) -> torch.Tensor:
    """Schroeder allpass: y[n] = −g·x[n] + d[n] + g·d[n], the buffer fed with
    x[n] + g·y[n]."""
    xt = _rows(x).t()
    buf = xt.new_zeros(delay, xt.shape[1])
    ys = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        ptr = t % delay
        delayed = buf[ptr]
        out = -feedback * xt[t] + delayed + feedback * delayed
        buf[ptr] = xt[t] + feedback * out
        ys[t] = out
    return ys.t().reshape(x.shape)


def variable_delay_line(x: torch.Tensor, delays: torch.Tensor, max_delay: int,
                        feedback: float) -> torch.Tensor:
    """Time-varying fractional delay with feedback (flanger core): linear
    interpolation between integer taps of a circular buffer. delays [T]."""
    xt = _rows(x).t()
    size = max_delay + 2
    d = torch.as_tensor(delays, dtype=torch.float32, device=x.device)
    d_floor = torch.floor(d)
    frac = d - d_floor
    keep = 1 - frac
    taps = d_floor.to(torch.int64).tolist()
    buf = xt.new_zeros(size, xt.shape[1])
    ys = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        delayed = buf[(t - taps[t]) % size] * keep[t] + buf[(t - taps[t] - 1) % size] * frac[t]
        buf[t % size] = xt[t] + delayed * feedback
        ys[t] = delayed
    return ys.t().reshape(x.shape)
