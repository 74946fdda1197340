"""Fused residual unit: the CUDA kernels csrc/resunit.cu and csrc/resunit_dense.cu
and their plain version.

Replaces neuralcodecs_tpu/ops/pallas/resunit.py:fused_residual_unit, both
forms. One ResidualUnit is

    out = x + b1 + W1 · snake(bd + dilconv_k7(snake(x, α1); Wd), α2)

with a depthwise Wd [C, 1, 7] (SNAC) or a dense Wd [C, C, 7] (DAC). On the
H100 the C×C products make it bound by operations; the plain chain adds
five full [B, C, T] round trips through device memory. The depthwise
kernel keeps every intermediate on chip with f32 FMAs (csrc/resunit.cu).
The dense form runs on the tensor cores in 3xTF32 (csrc/resunit_dense.cu):
three launches a unit, snake(x, α1), the dilated conv into a scratch y, then
the pointwise product with bias and residual.

``fused_residual_unit`` is the wrapper: the plain version for CPU tensors,
the depthwise or the dense kernel for CUDA tensors by the shape of Wd, or an
error. ``fused_residual_unit.launches`` counts depthwise launches and
``fused_residual_unit_dense.launches`` dense units (one a call, though a
call makes three launches). The dense kernels read Wd re-laid to
[7, Cout, Cin] and W1 [Cout, Cin], each split into its TF32 part and the
rest (``pack_dense_weights``, on every call: its time at C = 768 is in
PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.ops.conv import conv1d
from neuralcodecs_tpu_torch.ops.kernels.build import check, device_and_stream, load_library
from neuralcodecs_tpu_torch.ops.snake import snake

KERNEL = 7
_NAMES = ("alpha1", "w_dil", "b_dil", "alpha2", "w_pw", "b_pw")


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


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) for f32 ``w``: big is w rounded to TF32 (10 mantissa
    bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    does), small = w - big, exact in f32, so big + small == w."""
    bits = w.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, w - big


def pack_dense_weights(w_dil: torch.Tensor, w_pw: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The dense kernels' weights: Wd [C, C, 7] re-laid to [7, Cout, Cin]
    and W1 [C, C, 1] to [Cout, Cin], Cin zero-padded to a multiple of 4 (TMA
    rows are whole 16-byte units), each split by ``tf32_split``. Returns
    (wd_big, wd_small, w1_big, w1_small)."""
    c = w_dil.shape[0]
    pad = (0, -c % 4)
    wd = F.pad(w_dil.permute(2, 0, 1), pad).contiguous()
    w1 = F.pad(w_pw[:, :, 0], pad).contiguous()
    return (*tf32_split(wd), *tf32_split(w1))


def _check_inputs(x: torch.Tensor, args: tuple, *, dense: bool) -> None:
    name = "fused_residual_unit_dense" if dense else "fused_residual_unit"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got {tuple(x.shape)}")
    c = x.shape[1]
    shapes = {"alpha1": (c,), "alpha2": (c,), "b_dil": (c,), "b_pw": (c,),
              "w_dil": (c, c if dense else 1, KERNEL), "w_pw": (c, c, 1)}
    for key, t in {"x": x, **dict(zip(_NAMES, args))}.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} on {t.device}, want {x.device} (cuda)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if key in shapes:
            want = shapes[key]
            got = tuple(t.shape) if len(want) > 1 else (t.numel(),)
            if got != want:
                raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, want {want}")


def _launch(entry: str, x: torch.Tensor, args: tuple, dilation: int) -> torch.Tensor:
    b, c, t = x.shape
    out = torch.empty_like(x)
    rc = getattr(load_library(), entry)(
        x.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
        b, c, t, dilation, *device_and_stream(x))
    check(rc, entry)
    return out


def _on_cpu(x: torch.Tensor, args: tuple) -> bool:
    return x.device.type == "cpu" and all(t.device.type == "cpu" for t in args)


def fused_residual_unit(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                        b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                        b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """x + unit(x) for x [B, C, T] f32; arguments as in residual_unit_plain.
    A dense Wd [C, C, 7] (C > 1) goes to ``fused_residual_unit_dense``."""
    args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
    if _on_cpu(x, args):
        return residual_unit_plain(x, *args, dilation=dilation)
    if w_dil.dim() == 3 and w_dil.shape[1] != 1:
        return fused_residual_unit_dense(x, *args, dilation=dilation)
    _check_inputs(x, args, dense=False)
    out = _launch("nc_resunit_depthwise_f32", x, args, dilation)
    fused_residual_unit.launches += 1
    return out


def fused_residual_unit_dense(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                              b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                              b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """The dense form (Wd [C, C, 7]) of fused_residual_unit."""
    args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
    if _on_cpu(x, args):
        return residual_unit_plain(x, *args, dilation=dilation)
    _check_inputs(x, args, dense=True)
    wd_big, wd_small, w1_big, w1_small = pack_dense_weights(w_dil, w_pw)
    y = torch.empty_like(x)  # the dilated conv's output, read by the pointwise launch
    out = _launch("nc_resunit_dense_f32", x,
                  (alpha1, wd_big, wd_small, b_dil, alpha2, w1_big, w1_small, b_pw, y),
                  dilation)
    fused_residual_unit_dense.launches += 1
    return out


fused_residual_unit.launches = 0
fused_residual_unit_dense.launches = 0
