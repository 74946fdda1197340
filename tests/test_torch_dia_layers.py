"""The PyTorch port's Dia building blocks against the JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through both. Float results agree
within rtol 1e-5 / atol 1e-6 (the two frameworks sum in other orders);
quantized bytes and scales, delay patterns and text tokens are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.dia import layers as jl
from neuralcodecs_tpu.models.dia import Dia as JDia
from neuralcodecs_tpu.models.dia.audio_delay import apply_audio_delay as j_apply
from neuralcodecs_tpu.models.dia.audio_delay import revert_audio_delay as j_revert
from neuralcodecs_tpu_torch.models.dia import layers as tl
from neuralcodecs_tpu_torch.models.dia.audio_delay import apply_audio_delay, revert_audio_delay
from test_dia import tiny_config

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rms_norm_and_rope():
    x, w = _rand(0, 2, 5, 3, 16), _rand(1, 16)
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(w))),
                               _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    ts = jl.rope_timescale(16, 1.0, 10000.0)
    np.testing.assert_array_equal(tl.rope_timescale(16, 1.0, 10000.0), ts)
    pos = np.arange(5, dtype=np.int32)[None, :] + 7
    np.testing.assert_allclose(
        _np(tl.apply_rope(_t(x), _t(pos), _t(ts))),
        _np(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ts))), **TOL)


@pytest.mark.parametrize("masked", ["none", "causal", "fully-masked-row"])
def test_sdpa_gqa(masked):
    b, t, s, nq, nkv, dh = 2, 4, 6, 4, 2, 8
    q, k, v = _rand(0, b, t, nq, dh), _rand(1, b, s, nkv, dh), _rand(2, b, s, nkv, dh)
    mask = None
    if masked != "none":
        mask = np.broadcast_to(np.arange(s)[None, :] <= np.arange(t)[:, None] + 2, (b, t, s)).copy()
        if masked == "fully-masked-row":
            mask[0] = False       # every row of item 0: the CFG batch's unconditional rows
            mask[1, 2] = False
    got = _np(tl.sdpa_gqa(_t(q), _t(k), _t(v), None if mask is None else _t(mask)))
    want = _np(jl.sdpa_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None if mask is None else jnp.asarray(mask)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if masked == "fully-masked-row":
        assert not got[0].any() and not got[1, 2].any()


def _dense_pair(in_shapes, out_features, seed=0):
    w = _rand(seed, *in_shapes, *out_features)
    jd = jl.DenseGeneral("d", in_shapes, out_features)
    td = tl.DenseGeneral(in_shapes, out_features, torch.device("cpu"))
    td.load_state_dict({"weight": _t(w)})
    return jd, {"d.weight": jnp.asarray(w)}, td


@pytest.mark.parametrize("form", ["f32", "int8", "int4", "int4-one-group", "int4-odd-in"])
@pytest.mark.parametrize("shapes", [((32,), (2, 24)), ((4, 8), (16,))])
def test_dense_general(form, shapes):
    in_shapes, out_features = shapes
    if form == "int4-odd-in":
        in_shapes = (5,)
    jd, params, td = _dense_pair(in_shapes, out_features)
    group = 7 if form == "int4-one-group" else 8
    if form == "int8":
        jd.quantize_params(params)
        td.quantize_int8()
    elif form.startswith("int4"):
        jd.quantize_params_int4(params, group)
        td.quantize_int4(group)
    sd = td.state_dict()
    assert sorted("d." + k for k in sd) == sorted(params)
    for key, value in sd.items():   # quantized bytes and scales equal
        want = np.asarray(params["d." + key])
        assert value.dtype == _t(want).dtype, key
        np.testing.assert_array_equal(value.numpy(), want, err_msg=key)
    x = _rand(3, 3, 2, *in_shapes)
    np.testing.assert_allclose(_np(td(_t(x))), _np(jd(params, jnp.asarray(x))), **TOL)


def test_mlp_block():
    jm = jl.MlpBlock("m", 16, 32)
    params = {}
    jm.init(jax.random.key(0), params)
    tm = tl.MlpBlock(16, 32, torch.device("cpu"))
    tm.load_state_dict({k[2:]: _t(np.asarray(v)) for k, v in params.items()})
    x = _rand(1, 2, 3, 16)
    np.testing.assert_allclose(_np(tm(_t(x))), _np(jm(params, jnp.asarray(x))), **TOL)


def test_quantize_kv_codes_equal():
    x = _rand(0, 2, 5, 3, 16)
    x[0, 1, 2] = 0.0  # a zero vector: scale floor
    qj, sj = jl._quantize_kv(jnp.asarray(x))
    qt, st = tl._quantize_kv(_t(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _caches(quantized: bool, b=2, max_t=64, nkv=2, dh=32):
    k, v = _rand(0, b, max_t, nkv, dh), _rand(1, b, max_t, nkv, dh)
    jc = jl.KVCacheSlot.zeros(b, max_t, nkv, dh, quantized=quantized)
    jc = jc.prefill_write(jnp.asarray(k), jnp.asarray(v))
    tc = tl.KVCacheSlot.zeros(b, max_t, nkv, dh, quantized=quantized)
    tc.prefill_write(_t(k), _t(v))
    return jc, tc


# (query heads, K/V heads): Dia's group of 2 at these widths (the cases'
# first shape, unnamed in their ids), a group of 4 over one K/V head (Dia's
# 16 / 4 under tp = 4) and groups of 1 (cross)
HEADS = {(4, 2): "", (4, 1): "-gqa4-nkv1", (2, 2): "-mha"}


@pytest.mark.parametrize("read,heads", [pytest.param(read, heads, id=read + name)
                                        for heads, name in HEADS.items()
                                        for read in ("f32", "int8-dequant", "int8-dot")])
def test_blocked_decode_attn(read, heads):
    """The three reads against the JAX function at steps across block
    edges, to the buffer's end, and (f32 / dequant) against the port's own
    read of the slots. q carries the 1/sqrt(Dh) that Dia's q projection
    folds in (attention runs at scale 1.0)."""
    block = 16
    nq, nkv = heads
    jc, tc = _caches(read != "f32", nkv=nkv)
    for key in ("k", "v", "k_scale", "v_scale"):
        if getattr(jc, key) is not None:
            np.testing.assert_array_equal(getattr(tc, key).numpy(), np.asarray(getattr(jc, key)))
    q = _rand(2, 2, 1, nq, 32) / np.float32(np.sqrt(32))
    dot = read == "int8-dot"
    for step in (0, 15, 16, 17, 40, 63):
        got = tl._blocked_decode_attn(_t(q), tc, step, block, int8_dot=dot)
        want = jl._blocked_decode_attn(jnp.asarray(q), jc, jnp.int32(step), block, int8_dot=dot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")
        if not dot:
            ck, cv = tc.kv(torch.float32, step + 1)
            np.testing.assert_allclose(got.numpy(), tl.sdpa_gqa(_t(q), ck, cv, None).numpy(),
                                       **TOL)
    with pytest.raises(AssertionError):
        tl._blocked_decode_attn(_t(q), _caches(True, max_t=2048)[1], 0, 2048, int8_dot=True)


@pytest.mark.parametrize("kv_block,quantized,heads", [
    pytest.param(kv_block, quantized, heads, id=f"{kv_block}-{quantized}{name}")
    for heads, name in HEADS.items() for kv_block in (0, 4) for quantized in (False, True)])
def test_step_attn_writes_cache_in_place(quantized, kv_block, heads):
    """Every step of a 12-slot buffer (block edges at 4 and 8, its end at
    11) against JAX's step, the step's slot written in place as JAX writes
    it. A float cache goes through ``decode_self_attn`` (its plain version
    on the CPU), an int8 one through ``decode_self_attn_plain``."""
    b, max_t = 2, 12
    nq, nkv = heads
    ja = jl.Attention("a", 32, 32, nq, nkv, 8, 32)
    params = {}
    ja.init(jax.random.key(0), params)
    ta = tl.Attention(32, 32, nq, nkv, 8, 32, device=torch.device("cpu"))
    ta.load_state_dict({k[2:]: _t(np.asarray(v)) for k, v in params.items()})
    x = _rand(1, b, max_t, 32)
    jc = jl.KVCacheSlot.zeros(b, max_t, nkv, 8, quantized=quantized)
    tc = tl.KVCacheSlot.zeros(b, max_t, nkv, 8, quantized=quantized)
    storage = tc.k.data_ptr()
    for t in range(max_t):
        pos = np.full((b, 1), t, np.int32)
        mask = np.broadcast_to((np.arange(max_t) <= t)[None, None, :], (b, 1, max_t))
        want, jc = ja.step_attn(params, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos), jc, t,
                                jnp.asarray(mask), kv_block=kv_block)
        got = ta.step_attn(_t(x[:, t:t + 1]), _t(pos), tc, t, kv_block=kv_block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(tc.k[:, t].numpy().astype(np.float32),
                                   np.asarray(jc.k[:, t]).astype(np.float32), **TOL,
                                   err_msg=f"slot {t}")
        assert not tc.k[:, t + 1:].any() and not tc.v[:, t + 1:].any()
    assert tc.k.data_ptr() == storage
    np.testing.assert_allclose(tc.k.numpy().astype(np.float32),
                               np.asarray(jc.k).astype(np.float32), **TOL)


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa2"])
@pytest.mark.parametrize("positions", [3, 1], ids=["prefill", "step"])
def test_cross_cache_zeroes_padded_keys(positions, heads):
    """The cross cache against JAX's (padded keys zeroed), and cross
    attention over it: a block of positions (the prefill) and one position
    (a decode step, ``decode_cross_attn``'s plain version on the CPU), with
    real padding in row 0 and every key masked in row 1, whose output is
    exactly zero."""
    nq, nkv = heads
    ja = jl.Attention("a", 32, 16, nq, nkv, 16, 32)
    params = {}
    ja.init(jax.random.key(1), params)
    ta = tl.Attention(32, 16, nq, nkv, 16, 32, device=torch.device("cpu"))
    ta.load_state_dict({k[2:]: _t(np.asarray(v)) for k, v in params.items()})
    enc = _rand(0, 2, 6, 16)
    pad = np.array([[True] * 4 + [False] * 2, [False] * 6])
    pos = np.arange(6, dtype=np.int32)[None]
    jc = ja.precompute_cross_cache(params, jnp.asarray(enc), jnp.asarray(pos), jnp.asarray(pad))
    tc = ta.precompute_cross_cache(_t(enc), _t(pos), _t(pad))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    assert not tc.k[1].any() and not tc.k[0, 4:].any()
    x = _rand(2, 2, positions, 32)
    xpos = np.arange(positions, dtype=np.int32)[None] + (5 if positions == 1 else 0)
    mask = np.broadcast_to(pad[:, None, :], (2, positions, 6))
    got = ta.cross_attn(_t(x), _t(xpos), tc, _t(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ja.cross_attn(params, jnp.asarray(x), jnp.asarray(xpos), jc,
                                      jnp.asarray(mask))), **TOL)
    assert np.isfinite(got).all() and not got[1].any() and got[0].any()


@pytest.mark.parametrize("delay", [[0, 1, 2], [0, 2, 3], [0, 8, 9, 10, 11, 12, 13, 14, 15]])
def test_audio_delay_exact(delay):
    codes = np.random.default_rng(0).integers(-1, 100, size=(2, 19, len(delay)))
    got = apply_audio_delay(_t(codes), -2, -3, delay)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_apply(jnp.asarray(codes), -2, -3,
                                                                  delay)))
    for original_t in (None, 12):
        np.testing.assert_array_equal(
            revert_audio_delay(got, -2, delay, original_t).numpy(),
            np.asarray(j_revert(jnp.asarray(got.numpy()), -2, delay, original_t)))


def test_encode_and_pad_text_exact():
    from neuralcodecs_tpu_torch.models.dia import Dia
    from test_torch_dia import port_config

    jdia = JDia(tiny_config(), params={})
    dia = Dia(port_config(), device="cpu")
    texts = ["[S1]hi[S2]yo", "[S2]" + "x" * 40, "", "héllo [S1]"]
    for t in texts:
        np.testing.assert_array_equal(dia.encode_text(t), jdia.encode_text(t))
    tokens = [dia.encode_text(t) for t in texts]
    for pad_to in (None, 4, 13, 64, 1000):
        np.testing.assert_array_equal(dia._pad_text(tokens, pad_to), jdia._pad_text(tokens, pad_to))
