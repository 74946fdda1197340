"""Residual unit: the CUDA kernels of csrc/resunit.cu and their plain version.

Replaces neuralcodecs_tpu/ops/pallas/resunit.py:fused_residual_unit, both
forms. One ResidualUnit is

    out = x + b1 + W1 · snake(bd + dilconv_k7(snake(x, α1); Wd), α2)

with a depthwise Wd [C, 1, 7] (SNAC) or a dense Wd [C, C, 7] (DAC). On the
H100 the C×C products make it bound by operations; the plain chain adds
five full [B, C, T] round trips through device memory. Both forms run their
C×C products on the tensor cores in 3xTF32 (csrc/resunit.cu), with y
through device memory as a scratch [B, C, T]:
- depthwise, two launches a unit: y = snake(bd + depthwise conv of
  snake(x, α1), α2) with f32 taps, then out = x + b1 + W1 y;
- dense, three: snake(x, α1), the dilated conv into y, then the same
  pointwise launch.

``fused_residual_unit`` is the wrapper: the plain version for CPU tensors,
the depthwise or the dense kernels for CUDA tensors by the shape of Wd, or
an error. ``fused_residual_unit.launches`` counts depthwise units and
``fused_residual_unit_dense.launches`` dense units (one a call, though a
call makes two or three launches). The kernels read W1 as [Cout, Cin] and
the dense Wd re-laid to [7, Cout, Cin], each split into its TF32 part and
the rest (``pack_pointwise_weights``, ``pack_conv_weights``), once for each
weight tensor and kept on it until it changes.

Training (the dense form only). In grad mode, where an input requires
grad, the dense wrapper runs ``DenseResidualUnitFn``: its forward launches
the training form of the same three launches (``nc_resunit_dense_train_f32``),
which also keeps h = snake(x, α1) in a buffer of its own and stores the
conv's pre-activation z = bd + Wd ⊛ h beside y = snake(z, α2); its backward
is written out from (x, h, z, y) and the weights with stock ops (the 1×1
products by cuBLAS, the dilated conv's two gradients by cuDNN, TF32 off),
without running the unit again. ``residual_unit_train_plain`` is the
training form's plain version: the Function runs it in place of the launch
on CPU tensors, which is how the CPU tests reach its backward. The
depthwise kernel has no backward: in grad mode, on CUDA tensors of which
one requires grad, its wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.ops.conv import conv1d
from neuralcodecs_tpu_torch.ops.kernels.build import (check, device_and_stream, load_library,
                                                      refuse_grad)
from neuralcodecs_tpu_torch.ops.snake import snake

KERNEL = 7
_NAMES = ("alpha1", "w_dil", "b_dil", "alpha2", "w_pw", "b_pw")


def residual_unit_train_plain(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                              b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                              b_pw: torch.Tensor, *, dilation: int
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The composed snake / conv1d chain and what its backward reads:
    (out, h, z, y) with h = snake(x, α1), z = bd + dilconv(h; Wd),
    y = snake(z, α2) and out = x + b1 + W1 y. Arguments as in
    residual_unit_plain."""
    groups = x.shape[1] // w_dil.shape[1]
    h = snake(x, alpha1)
    z = conv1d(h, w_dil, b_dil, padding=(KERNEL - 1) * dilation // 2,
               dilation=dilation, groups=groups)
    y = snake(z, alpha2)
    return x + conv1d(y, w_pw, b_pw), h, z, y


def residual_unit_plain(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                        b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                        b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """The composed snake / conv1d chain. x: [B, C, T]; w_dil [C, C/g, 7];
    w_pw [C, C, 1]; alphas [1, C, 1]; biases [C]. Returns x + unit(x)."""
    return residual_unit_train_plain(x, alpha1, w_dil, b_dil, alpha2, w_pw, b_pw,
                                     dilation=dilation)[0]


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) for f32 ``w``: big is w rounded to TF32 (10 mantissa
    bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    does), small = w - big, exact in f32, so big + small == w."""
    bits = w.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, w - big


def pack_pointwise_weights(w_pw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pointwise launch's weights: W1 [C, C, 1] as [Cout, Cin], Cin
    zero-padded to a multiple of 4 (TMA rows are whole 16-byte units), split
    by ``tf32_split``. Returns (w1_big, w1_small)."""
    c = w_pw.shape[0]
    return tf32_split(F.pad(w_pw[:, :, 0], (0, -c % 4)).contiguous())


def pack_conv_weights(w_dil: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense conv launch's weights: Wd [C, C, 7] re-laid to [7, Cout,
    Cin], Cin zero-padded to a multiple of 4, split by ``tf32_split``.
    Returns (wd_big, wd_small)."""
    c = w_dil.shape[0]
    return tf32_split(F.pad(w_dil.permute(2, 0, 1), (0, -c % 4)).contiguous())


def pack_dense_weights(w_dil: torch.Tensor, w_pw: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The dense kernels' weights: (wd_big, wd_small, w1_big, w1_small) from
    ``pack_conv_weights`` and ``pack_pointwise_weights``."""
    return (*pack_conv_weights(w_dil), *pack_pointwise_weights(w_pw))


def _packed(w: torch.Tensor, pack) -> tuple[torch.Tensor, torch.Tensor]:
    """pack(w), kept on ``w`` itself until w's storage or its in-place
    version changes (``load_state_dict`` and optimizer steps change the
    version; a write through ``w.data`` is not seen): a unit's weights stay
    the same from one forward to the next, and splitting them costs about
    five small launches a unit. Made from ``w.detach()``: the split is
    constant data for the kernel, outside autograd."""
    key = (w.data_ptr(), w._version)
    cached = getattr(w, "_nc_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, pack(w.detach()))
        w._nc_packed = cached
    return cached[1]


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


def _needs_grad(x: torch.Tensor, args: tuple) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in (x, *args))


def _dense_weights(w_dil: torch.Tensor, w_pw: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return (*_packed(w_dil, pack_conv_weights), *_packed(w_pw, pack_pointwise_weights))


def _dense_train_forward(x: torch.Tensor, args: tuple, dilation: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, h, z, y) of the dense unit: the training form's launches on
    CUDA tensors, ``residual_unit_train_plain`` on CPU tensors."""
    if _on_cpu(x, args):
        return residual_unit_train_plain(x, *args, dilation=dilation)
    _check_inputs(x, args, dense=True)
    alpha1, w_dil, b_dil, alpha2, w_pw, b_pw = args
    wd_big, wd_small, w1_big, w1_small = _dense_weights(w_dil, w_pw)
    h, z, y = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    out = _launch("nc_resunit_dense_train_f32", x,
                  (alpha1, wd_big, wd_small, b_dil, alpha2, w1_big, w1_small, b_pw, h, z, y),
                  dilation)
    fused_residual_unit_dense.launches += 1
    return out, h, z, y


def _snake_backward(g: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dα) of snake(x, α) = x + sin²(αx)/α for the cotangent g:
    dx = g (1 + sin 2αx), dα = Σ g (x sin 2αx / α − sin²αx / α²). Where
    α == 0 snake is the identity (ops/snake.py's ``where``): dx = g and
    dα = 0, as JAX's autodiff of that ``where`` gives, with no NaN."""
    a = alpha.reshape(1, -1, 1)
    safe = torch.where(a == 0, torch.ones_like(a), a)
    sin2 = torch.sin(2.0 * a * x)   # 0 where α == 0
    sin = torch.sin(a * x)
    dx = g * (1.0 + sin2)
    da = torch.sum(g * (x * sin2 / safe - sin * sin / (safe * safe)), dim=(0, 2))
    return dx, da.reshape(alpha.shape)


class DenseResidualUnitFn(torch.autograd.Function):
    """The dense unit with a written-out backward. The forward is the
    training form (``_dense_train_forward``); the backward reads its saved
    (x, h, z, y) and the weights:

        db1 = Σ g;  dW1 = g yᵀ;  dy = W1ᵀ g;  dz, dα2 = snake'(z, α2)·dy;
        dbd = Σ dz;  dWd, dh = the conv's weight and input gradients of dz;
        dx = g + snake'(x, α1)·dh, with dα1.
    """

    @staticmethod
    def forward(ctx, x, alpha1, w_dil, b_dil, alpha2, w_pw, b_pw, dilation: int):
        args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
        out, h, z, y = _dense_train_forward(x, args, dilation)
        ctx.save_for_backward(x, h, z, y, alpha1, w_dil, alpha2, w_pw)
        ctx.dilation = dilation
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, z, y, alpha1, w_dil, alpha2, w_pw = ctx.saved_tensors
        d = ctx.dilation
        pad = (KERNEL - 1) * d // 2
        db1 = g.sum(dim=(0, 2))
        dw1 = torch.einsum("bot,bit->oi", g, y).unsqueeze(-1)
        dy = torch.einsum("oi,bot->bit", w_pw[:, :, 0], g)
        dz, da2 = _snake_backward(dy, z, alpha2)
        dbd = dz.sum(dim=(0, 2))
        dwd = torch.nn.grad.conv1d_weight(h, w_dil.shape, dz, padding=pad, dilation=d)
        dh = torch.nn.grad.conv1d_input(x.shape, w_dil, dz, padding=pad, dilation=d)
        dx, da1 = _snake_backward(dh, x, alpha1)
        return g + dx, da1, dwd, dbd, da2, dw1, db1, None


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
    refuse_grad("fused_residual_unit", x, *args)
    _check_inputs(x, args, dense=False)
    w1_big, w1_small = _packed(w_pw, pack_pointwise_weights)
    y = torch.empty_like(x)  # the depthwise launch's output, read by the pointwise launch
    out = _launch("nc_resunit_depthwise_f32", x,
                  (alpha1, w_dil, b_dil, alpha2, w1_big, w1_small, b_pw, y), dilation)
    fused_residual_unit.launches += 1
    return out


def fused_residual_unit_dense(x: torch.Tensor, alpha1: torch.Tensor, w_dil: torch.Tensor,
                              b_dil: torch.Tensor, alpha2: torch.Tensor, w_pw: torch.Tensor,
                              b_pw: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """The dense form (Wd [C, C, 7]) of fused_residual_unit; in grad mode,
    where an input requires grad, ``DenseResidualUnitFn``."""
    args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
    if _on_cpu(x, args):
        return residual_unit_plain(x, *args, dilation=dilation)
    if _needs_grad(x, args):
        return DenseResidualUnitFn.apply(x, *args, dilation)
    _check_inputs(x, args, dense=True)
    wd_big, wd_small, w1_big, w1_small = _dense_weights(w_dil, w_pw)
    y = torch.empty_like(x)  # the dilated conv's output, read by the pointwise launch
    out = _launch("nc_resunit_dense_f32", x,
                  (alpha1, wd_big, wd_small, b_dil, alpha2, w1_big, w1_small, b_pw, y),
                  dilation)
    fused_residual_unit_dense.launches += 1
    return out


fused_residual_unit.launches = 0
fused_residual_unit_dense.launches = 0
