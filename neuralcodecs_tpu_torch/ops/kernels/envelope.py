"""Envelope follower: the CUDA kernel csrc/envelope.cu and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/envelope.py:envelope_pallas, the
attack/release one-pole follower over |x| at the core of the compressor.
The gain switches on the level, so the recurrence is not linear and stays
one serial chain a row: on the H100 it is bound by the latency of a step.
The plain loop pays six launches per sample; the kernel computes both
candidate levels and selects last, so its chain is four dependent f32 ops
with the compare beside them, and is fed by TMA (see the header of
csrc/envelope.cu). Both round every op on its own, so the kernel is
bit-exact against the plain version.

The gains are rounded to f32 once, as the JAX scan's ``jnp.where`` does with
its Python floats. The JAX package's dispatch gate and compile probe
(``envelope_pallas_supported`` / ``_compiles``) work around TPU compiles and
have no counterpart: on a CUDA tensor the kernel runs at any N and T.

``envelope_follow`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, or an error. ``envelope_follow.launches`` counts
kernel launches. The kernel has no backward: on a CUDA tensor that
requires grad, in grad mode, the wrapper raises.
"""

from __future__ import annotations

import numpy as np
import torch

from neuralcodecs_tpu_torch.ops.kernels.build import (
    check, check_rows, device_and_stream, load_library, refuse_grad)


def envelope_follow_plain(x: torch.Tensor, attack_gain: float,
                          release_gain: float) -> torch.Tensor:
    """x [N, T] f32 -> envelope [N, T]: for each row, level = 0, then per
    sample a = |x|, gain = attack if a > level else release,
    level = level + gain * (a - level); the step of the JAX scan
    (neuralcodecs_tpu/dsp/filters.py, one_pole_follower)."""
    xt = x.abs().t().contiguous()  # [T, N]: one contiguous row per step
    attack = torch.tensor(np.float32(attack_gain), device=x.device)
    release = torch.tensor(np.float32(release_gain), device=x.device)
    level = xt.new_zeros(xt.shape[1])
    env = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        x_t = xt[t]
        gain = torch.where(x_t > level, attack, release)
        level = level + gain * (x_t - level)
        env[t] = level
    return env.t().contiguous()


def envelope_follow(x: torch.Tensor, attack_gain: float, release_gain: float) -> torch.Tensor:
    """Envelope [N, T] of |x| for x [N, T] f32 (see envelope_follow_plain)."""
    if x.device.type == "cpu":
        return envelope_follow_plain(x, attack_gain, release_gain)
    check_rows(x, "envelope_follow")
    refuse_grad("envelope_follow", x)
    if x.data_ptr() % 16:  # the kernel's bulk copies want 16-byte aligned rows
        x = x.clone()
    lib = load_library()
    n, t = x.shape
    env = torch.empty_like(x)
    rc = lib.nc_envelope_f32(x.data_ptr(), env.data_ptr(), n, t,
                             float(np.float32(attack_gain)), float(np.float32(release_gain)),
                             *device_and_stream(x))
    check(rc, "nc_envelope_f32")
    envelope_follow.launches += 1
    return env


envelope_follow.launches = 0
