"""Biquad (direct form II transposed): the CUDA kernel csrc/biquad.cu and its
plain version.

Replaces neuralcodecs_tpu/ops/pallas/biquad.py:biquad_pallas, which the
BS.1770 K-weighting runs twice per loudness measurement. On the H100 the
recurrence is bound by the serial latency of a step: the plain loop pays
ten launches per sample, the kernel a chain of four dependent f32 ops (see
the header of csrc/biquad.cu). Both round every op on its own, so the
kernel is bit-exact against the plain version.

The coefficients ``b`` = (b0, b1, b2) and ``a`` = (a0, a1, a2) are rounded to
f32 once, as the JAX function's ``jnp.asarray(b, jnp.float32)`` does; a0 is
taken as 1 and not read, as in the Pallas kernel.

``biquad_df2t`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, or an error. ``biquad_df2t.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from neuralcodecs_tpu_torch.ops.kernels.build import (
    check, check_rows, device_and_stream, load_library)


def _coefs(b, a) -> list[float]:
    """(b0, b1, b2, a1, a2), each rounded to f32."""
    b = np.asarray(torch.as_tensor(b).cpu(), dtype=np.float32)
    a = np.asarray(torch.as_tensor(a).cpu(), dtype=np.float32)
    return [float(v) for v in (b[0], b[1], b[2], a[1], a[2])]


def biquad_df2t_plain(x: torch.Tensor, b: Sequence[float], a: Sequence[float]) -> torch.Tensor:
    """x [N, T] f32 -> y [N, T]: for each row, z1 = z2 = 0, then per sample
    y = b0 x + z1, z1 = b1 x - a1 y + z2, z2 = b2 x - a2 y; the step of the
    JAX scan (neuralcodecs_tpu/dsp/filters.py, biquad)."""
    b0, b1, b2, a1, a2 = (torch.tensor(np.float32(c), device=x.device) for c in _coefs(b, a))
    xt = x.t().contiguous()  # [T, N]: one contiguous row per step
    z1 = xt.new_zeros(xt.shape[1])
    z2 = xt.new_zeros(xt.shape[1])
    ys = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        x_t = xt[t]
        y = b0 * x_t + z1
        z1_new = b1 * x_t - a1 * y + z2
        z2 = b2 * x_t - a2 * y
        z1 = z1_new
        ys[t] = y
    return ys.t().contiguous()


def biquad_df2t(x: torch.Tensor, b: Sequence[float], a: Sequence[float]) -> torch.Tensor:
    """DF2T biquad along each row of x [N, T] f32 (see biquad_df2t_plain)."""
    if x.device.type == "cpu":
        return biquad_df2t_plain(x, b, a)
    check_rows(x, "biquad_df2t")
    lib = load_library()
    n, t = x.shape
    y = torch.empty_like(x)
    rc = lib.nc_biquad_f32(x.data_ptr(), y.data_ptr(), n, t, *_coefs(b, a),
                           *device_and_stream(x))
    check(rc, "nc_biquad_f32")
    biquad_df2t.launches += 1
    return y


biquad_df2t.launches = 0
