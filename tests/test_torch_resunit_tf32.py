"""The arithmetic of the residual-unit kernels (csrc/resunit.cu).

The kernels run the f32 products of a residual unit on the tensor cores as
three TF32 passes (both products of a dense DAC unit, the pointwise product
of a depthwise SNAC unit, whose taps stay f32 FMAs): a = a_big + a_small with a_big rounded to TF32 (10
mantissa bits, to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds),
and a·b ≈ a_small·b_big + a_big·b_small + a_big·b_big. The tensor cores
read only the top 19 bits (sign, exponent, 10 mantissa bits) of each
operand, so a_small enters truncated to TF32. The kernels cannot run here;
these tests pin that arithmetic: the wrapper's weight split and re-layout,
and an emulation of the 3-pass product (products exact, sums in float64)
held against the plain f32 chain and against the JAX package's Pallas kernel
in interpret mode.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.core.weights import from_jax_params
from neuralcodecs_tpu_torch.ops.kernels.resunit import (
    KERNEL,
    pack_dense_weights,
    pack_pointwise_weights,
    residual_unit_plain,
    tf32_split,
)
from neuralcodecs_tpu_torch.ops.snake import snake

# max abs err of the TPU kernel's 3-pass bf16 split against the f32 chain
# (tests/test_torch_ops.py, test_resunit_dense_plain_matches_pallas_interpret)
TPU_SPLIT_ERR = 6.3e-5


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _rna_tf32_reference(w: np.ndarray) -> np.ndarray:
    """Round normal f32 values to 10 mantissa bits, ties away from zero, in
    float64: |w| / ulp rounded half up, times ulp."""
    w64 = w.astype(np.float64)
    mag = np.abs(w64)
    ulp = np.exp2(np.floor(np.log2(mag)) - 10)
    return (np.sign(w64) * np.floor(mag / ulp + 0.5) * ulp).astype(np.float32)


def _tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


ONE = 1.0
TIE = np.float32(1 + 2.0 ** -11)  # exactly half a TF32 ulp above 1


@pytest.mark.parametrize("value,want", [
    (TIE, 1 + 2.0 ** -10),                                  # tie: away from zero
    (-TIE, -(1 + 2.0 ** -10)),
    (np.float32(1 + 2.0 ** -11 + 2.0 ** -23), 1 + 2.0 ** -10),  # above the tie
    (np.float32(1 + 2.0 ** -11 - 2.0 ** -23), ONE),           # below it
    (np.float32(1 + 3 * 2.0 ** -11), 1 + 2 * 2.0 ** -10),    # tie, odd neighbour
    (np.float32(2 - 2.0 ** -23), 2.0),                        # carries into the exponent
    (np.float32(0.0), 0.0),
    (np.float32(-0.0), -0.0),
])
def test_tf32_split_crafted(value, want):
    w = torch.tensor([value], dtype=torch.float32)
    big, small = tf32_split(w)
    assert float(big[0]) == want
    assert np.signbit(float(big[0])) == np.signbit(want)
    assert torch.equal(big + small, w)
    assert (_bits(big) & 0x1FFF == 0).all()


def test_tf32_split_random(rng):
    w = np.concatenate([
        rng.standard_normal(20000).astype(np.float32),
        (rng.standard_normal(5000) * 1e-30).astype(np.float32),
        (rng.standard_normal(5000) * 1e30).astype(np.float32),
        np.float32(1e-40) * rng.standard_normal(100).astype(np.float32),  # subnormals
    ])
    t = torch.from_numpy(w)
    big, small = tf32_split(t)
    assert torch.equal(big + small, t)                        # exact in f32
    assert (_bits(big) & 0x1FFF == 0).all()                   # low 13 bits clear
    normal = np.abs(w) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(big.numpy()[normal], _rna_tf32_reference(w[normal]))
    # |small| is at most half a TF32 ulp of |w|
    assert (np.abs(small.numpy()[normal]) <= np.abs(w[normal]) * 2.0 ** -11).all()


@pytest.mark.parametrize("c", [8, 10, 96])
def test_pack_dense_weights_maps_back(rng, c):
    w_dil = torch.from_numpy(rng.standard_normal((c, c, KERNEL)).astype(np.float32))
    w_pw = torch.from_numpy(rng.standard_normal((c, c, 1)).astype(np.float32))
    wd_big, wd_small, w1_big, w1_small = pack_dense_weights(w_dil, w_pw)
    cp = -(-c // 4) * 4
    assert tuple(wd_big.shape) == tuple(wd_small.shape) == (KERNEL, c, cp)
    assert tuple(w1_big.shape) == tuple(w1_small.shape) == (c, cp)
    for t in (wd_big, wd_small, w1_big, w1_small):
        assert t.is_contiguous() and t.dtype == torch.float32
    wd = wd_big + wd_small
    for k in range(KERNEL):  # [tap, Cout, Cin] -> Wd[Cout, Cin, tap]
        assert torch.equal(wd[k, :, :c], w_dil[:, :, k])
    assert torch.equal(wd[:, :, c:], torch.zeros(KERNEL, c, cp - c))
    assert torch.equal((w1_big + w1_small)[:, :c], w_pw[:, :, 0])
    assert torch.equal(w1_big[:, c:], torch.zeros(c, cp - c))
    assert torch.equal(w1_small[:, c:], torch.zeros(c, cp - c))


def _conv_3pass(h: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """conv1d (zero padding (k - 1) d / 2) of f32 h and w as the kernels
    compute it: small·big + big·small + big·big, each operand split by
    tf32_split with its small part truncated to TF32; the products are exact
    and summed in float64 here."""
    h_big, h_small = tf32_split(h)
    w_big, w_small = tf32_split(w)
    h_small, w_small = _tf32_truncate(h_small), _tf32_truncate(w_small)
    pad = (w.shape[-1] - 1) * dilation // 2

    def conv(a, b):
        return F.conv1d(a.double(), b.double(), padding=pad, dilation=dilation)

    return conv(h_small, w_big) + conv(h_big, w_small) + conv(h_big, w_big)


def _unit_3pass(x, alpha1, w_dil, b_dil, alpha2, w_pw, b_pw, *, dilation: int):
    """One dense residual unit as the three launches compute it: h =
    snake(x, α1); y = snake(bd + conv(h), α2) in f32; out = x + (b1 + W1 y)."""
    h = snake(x, alpha1)
    y = snake((_conv_3pass(h, w_dil, dilation) + b_dil[None, :, None].double()).float(), alpha2)
    return x + (_conv_3pass(y, w_pw, 1) + b_pw[None, :, None].double()).float()


def _dense_args(rng, c: int):
    """Port-layout parameters of a dense unit at DAC-like scales."""
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(1 + 0.3 * rng.standard_normal((1, c, 1))),
            t(rng.standard_normal((c, c, KERNEL)) * (KERNEL * c) ** -0.5),
            t(0.1 * rng.standard_normal(c)),
            t(1 + 0.3 * rng.standard_normal((1, c, 1))),
            t(rng.standard_normal((c, c, 1)) * c ** -0.5),
            t(0.1 * rng.standard_normal(c)))


def test_3pass_unit_matches_plain_chain_at_full_width(rng):
    """A full-width DAC decoder unit (C = 768, d = 9) at T = 256: the 3-pass
    product stays within the kernel phase's rtol 1e-4 / atol 1e-5 of the
    f32 chain, at least 10x closer than the TPU kernel's bf16 split."""
    c, d, t = 768, 9, 256
    args = _dense_args(rng, c)
    x = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    want = residual_unit_plain(x, *args, dilation=d)
    got = _unit_3pass(x, *args, dilation=d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert float((got - want).abs().max()) <= TPU_SPLIT_ERR / 10


def test_3pass_unit_matches_pallas_interpret(rng):
    """The 3-pass emulation against the JAX package's dense Pallas kernel
    (its own 3-pass bf16 split) in interpret mode, at C = 128, d = 3, within
    the 1e-4 / 1e-4 that test_torch_ops.py holds the f32 chain to."""
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.resunit import fused_residual_unit as jfused

    t, c, d = 256, 128, 3
    x = (0.5 * rng.standard_normal((1, c, t))).astype(np.float32)
    p = {"alpha1": rng.standard_normal(c).astype(np.float32),
         "alpha2": rng.standard_normal(c).astype(np.float32),
         "wd": (0.1 * rng.standard_normal((KERNEL, c, c))).astype(np.float32),
         "bd": (0.1 * rng.standard_normal(c)).astype(np.float32),
         "w1": (0.1 * rng.standard_normal((1, c, c))).astype(np.float32),
         "b1": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused(np.ascontiguousarray(x.transpose(0, 2, 1)), p["alpha1"],
                                 p["wd"], p["bd"], p["alpha2"], p["w1"], p["b1"], k=KERNEL,
                                 dilation=d, depthwise=False)).transpose(0, 2, 1)
    sd = from_jax_params({"a.alpha": p["alpha1"], "b.alpha": p["alpha2"], "wd": p["wd"],
                          "w1": p["w1"]})
    args = (sd["a.alpha"], sd["wd"], torch.from_numpy(p["bd"]), sd["b.alpha"], sd["w1"],
            torch.from_numpy(p["b1"]))
    got = _unit_3pass(torch.from_numpy(x), *args, dilation=d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _depthwise_unit_3pass(x, alpha1, w_dil, b_dil, alpha2, w_pw, b_pw, *, dilation: int):
    """One depthwise residual unit as its two launches compute it: y =
    snake(bd + depthwise conv of snake(x, α1), α2) in f32 (the taps stay f32
    FMAs); out = x + (b1 + W1 y) with the 3-pass product."""
    c = x.shape[1]
    h = snake(x, alpha1)
    y = snake(F.conv1d(h, w_dil, b_dil, padding=(KERNEL - 1) * dilation // 2,
                       dilation=dilation, groups=c), alpha2)
    return x + (_conv_3pass(y, w_pw, 1) + b_pw[None, :, None].double()).float()


def test_3pass_depthwise_unit_matches_plain_chain_at_full_width(rng):
    """SNAC's widest depthwise unit (C = 512) at d = 9, T = 256: the f32
    taps and the 3-pass pointwise product stay within the kernel phase's
    rtol 1e-4 / atol 1e-5 of the f32 chain."""
    c, d, t = 512, 9, 256
    alpha1, _, b_dil, alpha2, w_pw, b_pw = _dense_args(rng, c)
    w_dil = torch.from_numpy((rng.standard_normal((c, 1, KERNEL)) * KERNEL ** -0.5)
                             .astype(np.float32))
    args = (alpha1, w_dil, b_dil, alpha2, w_pw, b_pw)
    x = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    want = residual_unit_plain(x, *args, dilation=d)
    got = _depthwise_unit_3pass(x, *args, dilation=d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_3pass_depthwise_unit_matches_pallas_interpret(rng):
    """The depthwise emulation against the JAX package's Pallas kernel
    (depthwise=True) in interpret mode, at C = 128, d = 3, within the
    rtol 1e-4 / atol 1e-5 that test_torch_ops.py holds the f32 chain to."""
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.resunit import fused_residual_unit as jfused

    t, c, d = 256, 128, 3
    x = (0.5 * rng.standard_normal((1, c, t))).astype(np.float32)
    p = {"alpha1": rng.standard_normal(c).astype(np.float32),
         "alpha2": rng.standard_normal(c).astype(np.float32),
         "wd": (0.1 * rng.standard_normal((KERNEL, 1, c))).astype(np.float32),
         "bd": (0.1 * rng.standard_normal(c)).astype(np.float32),
         "w1": (0.1 * rng.standard_normal((1, c, c))).astype(np.float32),
         "b1": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused(np.ascontiguousarray(x.transpose(0, 2, 1)), p["alpha1"],
                                 p["wd"], p["bd"], p["alpha2"], p["w1"], p["b1"], k=KERNEL,
                                 dilation=d, depthwise=True)).transpose(0, 2, 1)
    sd = from_jax_params({"a.alpha": p["alpha1"], "b.alpha": p["alpha2"], "wd": p["wd"],
                          "w1": p["w1"]})
    args = (sd["a.alpha"], sd["wd"], torch.from_numpy(p["bd"]), sd["b.alpha"], sd["w1"],
            torch.from_numpy(p["b1"]))
    got = _depthwise_unit_3pass(torch.from_numpy(x), *args, dilation=d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [48, 10])
def test_pack_pointwise_weights_maps_back(rng, c):
    w_pw = torch.from_numpy(rng.standard_normal((c, c, 1)).astype(np.float32))
    w1_big, w1_small = pack_pointwise_weights(w_pw)
    cp = -(-c // 4) * 4
    assert tuple(w1_big.shape) == tuple(w1_small.shape) == (c, cp)
    assert w1_big.is_contiguous() and w1_small.is_contiguous()
    assert torch.equal((w1_big + w1_small)[:, :c], w_pw[:, :, 0])
    assert torch.equal(w1_big[:, c:], torch.zeros(c, cp - c))


def test_packed_weights_follow_in_place_changes(rng):
    """The wrapper keeps a weight's split on the weight until the weight
    changes in place (load_state_dict, an optimizer step)."""
    from neuralcodecs_tpu_torch.ops.kernels.resunit import _packed

    w = torch.from_numpy(rng.standard_normal((12, 12, 1)).astype(np.float32))
    first = _packed(w, pack_pointwise_weights)
    assert _packed(w, pack_pointwise_weights)[0] is first[0]
    with torch.no_grad():
        w.mul_(2.0)
    again = _packed(w, pack_pointwise_weights)
    assert again[0] is not first[0]
    for got, want in zip(again, pack_pointwise_weights(w)):
        assert torch.equal(got, want)
