"""Fused residual unit: the CUDA kernel csrc/resunit.cu and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/resunit.py:fused_residual_unit
(depthwise form). One SNAC ResidualUnit is

    out = x + b1 + W1 · snake(bd + dilconv_k7(snake(x, α1)), α2)

On the H100 the pointwise C×C product makes it bound by f32 operations;
the plain chain adds five full [B, C, T] round trips through device memory.
The kernel keeps every intermediate on chip (see the header of
csrc/resunit.cu).

``fused_residual_unit`` is the wrapper: the plain version for CPU tensors,
the kernel for CUDA tensors with the depthwise weights, or an error.
``fused_residual_unit.launches`` counts kernel launches. The dense
(groups = 1) form of the kernel is still to be ported; until then
``residual_unit_plain`` computes that form.
"""

from __future__ import annotations

import torch

from neuralcodecs_tpu_torch.ops.conv import conv1d
from neuralcodecs_tpu_torch.ops.kernels.build import check, device_and_stream, load_library
from neuralcodecs_tpu_torch.ops.snake import snake

KERNEL = 7


def residual_unit_plain(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                        b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                        b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """The composed snake / conv1d chain. x: [B, C, T]; w_dil [C, C/g, 7];
    w_pw [C, C, 1]; alphas [1, C, 1]; biases [C]. Returns x + unit(x)."""
    groups = x.shape[1] // w_dil.shape[1]
    h = snake(x, alpha1)
    h = conv1d(h, w_dil, b_dil, padding=(KERNEL - 1) * dilation // 2,
               dilation=dilation, groups=groups)
    h = snake(h, alpha2)
    return x + conv1d(h, w_pw, b_pw)


def _check_inputs(x: torch.Tensor, tensors: dict[str, torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"fused_residual_unit: x must be [B, C, T], got {tuple(x.shape)}")
    c = x.shape[1]
    shapes = {"alpha1": (c,), "alpha2": (c,), "b_dil": (c,), "b_pw": (c,),
              "w_dil": (c, 1, KERNEL), "w_pw": (c, c, 1)}
    for name, t in {"x": x, **tensors}.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"fused_residual_unit: {name} on {t.device}, want {x.device} (cuda)")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_residual_unit: {name} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"fused_residual_unit: {name} is not contiguous")
        if name in shapes:
            want = shapes[name]
            got = tuple(t.shape) if len(want) > 1 else (t.numel(),)
            if got != want:
                raise ValueError(f"fused_residual_unit: {name} shape {tuple(t.shape)}, "
                                 f"want {want} (the kernel takes the depthwise form)")


def fused_residual_unit(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                        b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                        b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """x + unit(x) for x [B, C, T] f32; arguments as in residual_unit_plain."""
    args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
    if x.device.type == "cpu" and all(t.device.type == "cpu" for t in args):
        return residual_unit_plain(x, *args, dilation=dilation)
    _check_inputs(x, dict(zip(("alpha1", "w_dil", "b_dil", "alpha2", "w_pw", "b_pw"), args)))
    lib = load_library()
    b, c, t = x.shape
    out = torch.empty_like(x)
    rc = lib.nc_resunit_depthwise_f32(
        x.data_ptr(), alpha1.data_ptr(), w_dil.data_ptr(), b_dil.data_ptr(),
        alpha2.data_ptr(), w_pw.data_ptr(), b_pw.data_ptr(), out.data_ptr(),
        b, c, t, dilation, *device_and_stream(x))
    check(rc, "nc_resunit_depthwise_f32")
    fused_residual_unit.launches += 1
    return out


fused_residual_unit.launches = 0
