"""Biquad cascade (direct form II transposed): the CUDA kernel csrc/biquad.cu
and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/biquad.py:biquad_pallas. The BS.1770
K-weighting runs two biquads back to back; the wrapper takes a list of 1 or 2
sections and runs them in cascade in one call.

The recurrence is linear, so the kernel cuts time into chunks of ``CHUNK``
samples and runs them in parallel (see the header of csrc/biquad.cu):
(1) every chunk but the last of a row runs the cascade from zero state in
f64 and keeps its end state; (2) per row, serially over the chunks, the
state at each chunk start is carried as s_{k+1} = Phi s_k + e_k in f64, with
Phi the cascade's state transition over ``CHUNK`` steps (``cascade_phi``,
built here in f64 from the f32 coefficients); (3) every chunk re-runs the
cascade from its start state rounded to f32 with the plain loop's own f32
step, each op rounded on its own, and writes y. So within a chunk the
arithmetic is the loop's and only the start state differs, by the rounding
the loop itself accumulates: the kernel is as accurate as the loop against
the exact (f64) filter, not bit-equal to it, except where T <= CHUNK (one
chunk, zero start: the loop bit for bit). ``biquad_cascade_chunked`` is
that arithmetic in PyTorch on the CPU, for the tests; nothing on the main
path calls it.

The coefficients ``b`` = (b0, b1, b2) and ``a`` = (a0, a1, a2) are rounded to
f32 once, as the JAX function's ``jnp.asarray(b, jnp.float32)`` does; a0 is
taken as 1 and not read, as in the Pallas kernel.

``biquad_df2t`` is the wrapper: the plain cascade for CPU tensors, the
kernel for CUDA tensors, or an error. ``biquad_df2t.launches`` counts
wrapper calls that launched the kernel (three CUDA launches, one where
T <= CHUNK). The kernel has no backward: on a CUDA tensor that requires
grad, in grad mode, the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from neuralcodecs_tpu_torch.ops.kernels.build import (
    check, check_rows, device_and_stream, load_library, refuse_grad)

CHUNK = 1024        # samples a chunk (a multiple of the kernel's 128-sample tile)
MAX_SECTIONS = 2

Section = tuple[Sequence[float], Sequence[float]]


def _coefs(b, a) -> tuple[float, ...]:
    """(b0, b1, b2, a1, a2), each rounded to f32."""
    b, a = (np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, dtype=np.float32)
            for v in (b, a))
    return tuple(float(v) for v in (b[0], b[1], b[2], a[1], a[2]))


def section_coefs(sections: Sequence[Section]) -> tuple[tuple[float, ...], ...]:
    """(b0, b1, b2, a1, a2) of each of 1 to MAX_SECTIONS sections, in f32."""
    if not 1 <= len(sections) <= MAX_SECTIONS:
        raise ValueError(f"biquad cascade: 1 to {MAX_SECTIONS} sections, got {len(sections)}")
    return tuple(_coefs(b, a) for b, a in sections)


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


def biquad_cascade_plain(x: torch.Tensor, sections: Sequence[Section]) -> torch.Tensor:
    """The sections' plain loops, one after the other."""
    section_coefs(sections)
    for b, a in sections:
        x = biquad_df2t_plain(x, b, a)
    return x


# --------------------------------------------------- the chunked arithmetic


def cascade_step_matrix(sections: Sequence[Section]) -> np.ndarray:
    """A [2S, 2S] f64: the cascade's state (z1, z2 of each section, in
    order) one step on with zero input. A section's own block is
    [[-a1, 1], [-a2, 0]]; its input is the previous section's y = z1 of that
    section, which enters through (b1 - a1 b0, b2 - a2 b0)."""
    coefs = section_coefs(sections)
    n = 2 * len(coefs)
    m = np.zeros((n, n))
    for i, (b0, b1, b2, a1, a2) in enumerate(coefs):
        r = 2 * i
        m[r:r + 2, r:r + 2] = [[-a1, 1.0], [-a2, 0.0]]
        if i:
            m[r:r + 2, r - 2] = [b1 - a1 * b0, b2 - a2 * b0]
    return m


@functools.lru_cache(maxsize=64)
def _phi(coefs: tuple, chunk: int) -> np.ndarray:
    sections = [((c[0], c[1], c[2]), (1.0, c[3], c[4])) for c in coefs]
    return np.linalg.matrix_power(cascade_step_matrix(sections), chunk)


def cascade_phi(sections: Sequence[Section], chunk: int = CHUNK) -> np.ndarray:
    """Phi [2S, 2S] f64: the cascade's state transition over ``chunk``
    zero-input steps, A^chunk."""
    return _phi(section_coefs(sections), chunk)


def chunk_end_states(x: torch.Tensor, sections: Sequence[Section],
                     chunk: int = CHUNK) -> torch.Tensor:
    """Phase 1: e [N, C - 1, 2S] f64, the end state of each chunk but the
    last of every row when the cascade runs it from zero state."""
    n, t = x.shape
    c = -(-t // chunk)
    coefs = section_coefs(sections)
    xs = x[:, :(c - 1) * chunk].to(torch.float64).reshape(n * (c - 1), chunk)
    state = []
    u = xs
    for b0, b1, b2, a1, a2 in coefs:
        z1 = xs.new_zeros(xs.shape[0])
        z2 = xs.new_zeros(xs.shape[0])
        ys = torch.empty_like(u)
        for i in range(chunk):
            y = b0 * u[:, i] + z1
            z1, z2 = b1 * u[:, i] - a1 * y + z2, b2 * u[:, i] - a2 * y
            ys[:, i] = y
        state += [z1, z2]
        u = ys
    return torch.stack(state, -1).reshape(n, c - 1, 2 * len(coefs))


def carry_states(e: torch.Tensor, phi: np.ndarray) -> torch.Tensor:
    """Phase 2: s [N, C, 2S] f32, the state at each chunk start (s_0 = 0,
    s_{k+1} = Phi s_k + e_k, in f64) rounded to f32."""
    n, c1, d = e.shape
    p = torch.as_tensor(phi, dtype=torch.float64, device=e.device)
    s = torch.zeros(n, c1 + 1, d, dtype=torch.float64, device=e.device)
    for k in range(c1):
        s[:, k + 1] = s[:, k] @ p.t() + e[:, k]
    return s.to(torch.float32)


def run_chunks(x: torch.Tensor, sections: Sequence[Section], starts: torch.Tensor,
               chunk: int = CHUNK) -> torch.Tensor:
    """Phase 3: y [N, T], every chunk of every row run by the cascade from
    its start state ``starts`` [N, C, 2S] f32 with the plain loop's f32 step
    (each op rounded on its own)."""
    n, t = x.shape
    c = -(-t // chunk)
    u = torch.nn.functional.pad(x, (0, c * chunk - t)).reshape(n * c, chunk).t().contiguous()
    s = starts.reshape(n * c, -1)
    for i, coefs in enumerate(section_coefs(sections)):
        b0, b1, b2, a1, a2 = (torch.tensor(np.float32(v)) for v in coefs)
        z1, z2 = s[:, 2 * i].clone(), s[:, 2 * i + 1].clone()
        ys = torch.empty_like(u)
        for j in range(chunk):
            x_j = u[j]
            y = b0 * x_j + z1
            z1_new = b1 * x_j - a1 * y + z2
            z2 = b2 * x_j - a2 * y
            z1 = z1_new
            ys[j] = y
        u = ys
    return u.t().reshape(n, c * chunk)[:, :t].contiguous()


def biquad_cascade_chunked(x: torch.Tensor, sections: Sequence[Section],
                           chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's three phases on CPU tensors: what the kernel computes,
    up to the order of its f64 sums."""
    e = chunk_end_states(x, sections, chunk)
    return run_chunks(x, sections, carry_states(e, cascade_phi(sections, chunk)), chunk)


# ------------------------------------------------------------------ wrapper


@functools.lru_cache(maxsize=64)
def _launch_constants(coefs: tuple) -> tuple:
    """The C entry's host arrays for these sections: their coefficients and
    Phi over CHUNK steps."""
    flat = [v for sec in coefs for v in sec]
    return ((ctypes.c_float * len(flat))(*flat),
            (ctypes.c_double * (4 * len(coefs) ** 2))(*_phi(coefs, CHUNK).ravel()))


def biquad_df2t(x: torch.Tensor, sections: Sequence[Section]) -> torch.Tensor:
    """The cascade of 1 or 2 DF2T biquads ``sections`` = [(b, a), ...] along
    each row of x [N, T] f32 (see biquad_df2t_plain)."""
    coefs = section_coefs(sections)
    if x.device.type == "cpu":
        return biquad_cascade_plain(x, sections)
    check_rows(x, "biquad_df2t")
    refuse_grad("biquad_df2t", x)
    lib = load_library()
    n, t = x.shape
    c = -(-t // CHUNK)
    d = 2 * len(coefs)
    y = torch.empty_like(x)
    # scratch: the chunks' zero-start end states (f64) and start states (f32)
    e = torch.empty(max(n * (c - 1) * d, 1), dtype=torch.float64, device=x.device)
    s = torch.empty(n * c * d, dtype=torch.float32, device=x.device)
    rc = lib.nc_biquad_cascade_f32(x.data_ptr(), y.data_ptr(), e.data_ptr(), s.data_ptr(),
                                   n, t, CHUNK, len(coefs), *_launch_constants(coefs),
                                   *device_and_stream(x))
    check(rc, "nc_biquad_cascade_f32")
    biquad_df2t.launches += 1
    return y


biquad_df2t.launches = 0
