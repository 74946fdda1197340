"""Encodec's quantizer training half and the conv initialisers, port against
the JAX package, on the CPU.

The EMA update, ``expire_codes`` and ``kmeans`` are held to JAX within
rtol 1e-6 / atol 1e-6 (JAX's own bar for its dp psum against one device,
tests/test_parallel.py), with JAX's random draws replayed into the port's
``draw_sample_indices`` / ``draw_kmeans_init``: ``torch.Generator`` cannot
give ``jax.random``'s numbers. The dp=4 EMA step runs in 4 gloo CPU ranks
(``torch_parallel_workers.ema_check``). The training forwards
(``VectorQuantizer.forward``, the RVQ's ``forward`` and
``quantize_with_bandwidth``) match in values within rtol 1e-6 / atol 1e-7
and codes exactly, and their gradients within rtol 1e-5 / atol 1e-6 of
``jax.grad``'s.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.encodec import quantize as jq
from neuralcodecs_tpu.ops import conv as jconv
from neuralcodecs_tpu_torch.models.encodec import quantize as q
from neuralcodecs_tpu_torch.ops.conv import conv_bias_init, kaiming_uniform_conv_init
from neuralcodecs_tpu_torch.parallel.launch import run_local
import torch_parallel_workers as workers

EMA_TOL = dict(rtol=1e-6, atol=1e-6)
VAL_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _codebook_pair(dim: int = 8, size: int = 16, seed: int = 0):
    jcb = jq.EuclideanCodebook("vq", dim=dim, codebook_size=size)
    params = {}
    jcb.init(jax.random.key(seed), params)
    return jcb, params, q.EuclideanCodebook(dim, size)


def _state(jstate) -> q.CodebookState:
    return q.CodebookState(*(torch.from_numpy(np.array(v)) for v in jstate))


def _assert_state(got: q.CodebookState, want, **tol) -> None:
    for name, g, w in zip(q.CodebookState._fields, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=name, **tol)


def _ema_data(seed: int = 0, rows: int = 8 * 24, dim: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, dim)).astype(np.float32)


# ------------------------------------------------------------------- the EMA


def test_ema_update_matches_jax_over_three_steps():
    jcb, params, cb = _codebook_pair()
    jstate = jcb.state_from_params(params)
    state = _state(jstate)
    for step in range(3):
        x = _ema_data(step)
        jcodes = jcb.quantize({"vq.embed": jstate.embed}, jnp.asarray(x))
        codes = q.l2_argmin_codes(torch.from_numpy(x), state.embed)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        jstate = jcb.ema_update(jstate, jnp.asarray(x), jcodes)
        state = cb.ema_update(state, torch.from_numpy(x), codes)
        _assert_state(state, jstate, **EMA_TOL)


def test_ema_update_dp4_matches_jax_single_device():
    """The dp=4 update (each rank a quarter of the rows, the statistics
    summed over dp) equals JAX's one-device update of the whole batch, on
    every rank."""
    jcb, params, _ = _codebook_pair()
    jstate = jcb.state_from_params(params)
    x = _ema_data(1)
    codes = np.asarray(jcb.quantize(params, jnp.asarray(x)))
    want = jcb.ema_update(jstate, jnp.asarray(x), jnp.asarray(codes))
    inputs = {**{k: np.array(v) for k, v in jstate._asdict().items()}, "flat_x": x,
              "codes": codes}
    for got in run_local(workers.ema_check, 4, (inputs,), timeout=200):
        _assert_state(q.CodebookState(**got), want, **EMA_TOL)


def test_state_round_trips_through_the_buffers():
    _, params, cb = _codebook_pair()
    state = cb.state_from_params()
    assert state.embed is cb.embed and state.inited is cb.inited
    new = cb.ema_update(state, torch.from_numpy(_ema_data()), cb.quantize(
        torch.from_numpy(_ema_data())))
    cb.state_to_params(new)
    for name, value in new._asdict().items():
        assert torch.equal(getattr(cb, name), value), name


# -------------------------------------------------------- draws from JAX


def test_expire_codes_with_jax_draws(monkeypatch):
    jcb, params, cb = _codebook_pair()
    rng = np.random.default_rng(3)
    cluster = rng.uniform(0, 4, 16).astype(np.float32)  # about half below threshold 2
    jstate = jcb.state_from_params(params)._replace(cluster_size=jnp.asarray(cluster))
    samples = rng.standard_normal((4, 25, 8)).astype(np.float32)
    key = jax.random.key(7)
    want = jcb.expire_codes(key, jstate, jnp.asarray(samples))
    idx = np.array(jax.random.randint(key, (16,), 0, 100))  # sample_vectors' draw
    monkeypatch.setattr(q, "draw_sample_indices", lambda g, n, num: torch.from_numpy(idx))
    got = cb.expire_codes(None, _state(jstate), torch.from_numpy(samples))
    expired = cluster < 2
    assert 0 < expired.sum() < 16
    _assert_state(got, want, rtol=0, atol=0)
    assert not torch.equal(got.embed, _state(jstate).embed)


def test_expire_codes_draws_its_own_rows():
    _, _, cb = _codebook_pair()
    state = cb.state_from_params()  # cluster_size 0: every code expired
    samples = torch.arange(40, dtype=torch.float32).reshape(5, 8)
    got = cb.expire_codes(torch.Generator().manual_seed(0), state, samples)
    assert all(any(torch.equal(row, s) for s in samples) for row in got.embed)
    again = cb.expire_codes(torch.Generator().manual_seed(0), state, samples)
    assert torch.equal(got.embed, again.embed)
    cb.threshold = 0
    assert cb.expire_codes(None, state, samples) is state


@pytest.mark.parametrize("n, d, k", [(512, 8, 16), (1500, 128, 256)])
def test_kmeans_with_jax_draws(monkeypatch, n, d, k):
    x = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    key = jax.random.key(11)
    want_means, want_bins = jax.jit(jq.kmeans, static_argnums=(2, 3))(key, jnp.asarray(x), k,
                                                                       10)
    idx = np.array(jax.random.permutation(key, n)[:k])
    monkeypatch.setattr(q, "draw_kmeans_init", lambda g, n_, k_: torch.from_numpy(idx))
    means, bins = q.kmeans(None, torch.from_numpy(x), k, num_iters=10)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means), **EMA_TOL)


def test_kmeans_draws_distinct_rows():
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    idx = q.draw_kmeans_init(torch.Generator().manual_seed(1), 64, 16)
    assert len(set(idx.tolist())) == 16
    means, bins = q.kmeans(torch.Generator().manual_seed(1), x, 16, num_iters=3)
    assert means.shape == (16, 4) and int(bins.sum()) == 64


def test_uniform_init_bounds():
    w = q.uniform_init(torch.Generator().manual_seed(0), (64, 8))
    assert w.shape == (64, 8) and float(w.abs().max()) <= 1 / 8
    w = q.uniform_init(None, (10, 3), scale=0.01)
    assert float(w.abs().max()) <= 0.01


# ------------------------------------------------------- training forwards


def _vq_pair(codebook_dim: int | None, seed: int = 0):
    jvq = jq.VectorQuantizer("vq", dim=8, codebook_size=16, codebook_dim=codebook_dim,
                             commitment_weight=0.5)
    params = {}
    jvq.init(jax.random.key(seed), params)
    vq = q.VectorQuantizer(8, 16, codebook_dim, commitment_weight=0.5)
    vq.load_state_dict({k[len("vq."):]: torch.from_numpy(np.array(v))
                        for k, v in params.items()})
    return jvq, params, vq


@pytest.mark.parametrize("codebook_dim", [None, 4], ids=["no_projection", "projection"])
def test_vector_quantizer_forward_and_grads_match_jax(codebook_dim):
    jvq, params, vq = _vq_pair(codebook_dim)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 8)).astype(np.float32)

    def jloss(p, xx):
        quantized, codes, commit = jvq.forward(p, xx)
        return jnp.sum(quantized * cot) + commit, (quantized, codes, commit)

    (jval, (jquant, jcodes, jcommit)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    quantized, codes, commit = vq(xt)
    loss = torch.sum(quantized * torch.from_numpy(cot)) + commit
    loss.backward()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(quantized.detach().numpy(), np.asarray(jquant), **VAL_TOL)
    np.testing.assert_allclose(commit.item(), float(jcommit), **VAL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    grads = {k: p.grad for k, p in vq.named_parameters()}
    assert set(grads) == ({"project_in.weight", "project_in.bias", "project_out.weight",
                           "project_out.bias"} if codebook_dim else set())
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[f"vq.{key}"]), **GRAD_TOL,
                                   err_msg=key)


def _rvq_pair(seed: int = 0):
    jrvq = jq.ResidualVectorQuantizer("rvq", dim=8, num_quantizers=3, codebook_size=16)
    params = {}
    jrvq.init(jax.random.key(seed), params)
    rvq = q.ResidualVectorQuantizer(8, 3, 16)
    rvq.load_state_dict({k[len("rvq."):]: torch.from_numpy(np.array(v))
                         for k, v in params.items()})
    return jrvq, params, rvq


@pytest.mark.parametrize("n_q", [None, 2])
def test_rvq_forward_and_grads_match_jax(n_q):
    jrvq, params, rvq = _rvq_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)          # JAX's [B, T, D]
    cot = rng.standard_normal((2, 10, 8)).astype(np.float32)

    def jloss(xx):
        quantized, codes, losses = jrvq.forward(params, xx, n_q)
        return jnp.sum(quantized * cot) + jnp.sum(losses), (quantized, codes, losses)

    (jval, (jquant, jcodes, jlosses)), jgx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()   # [B, D, T]
    quantized, codes, losses = rvq(xt, n_q)
    loss = torch.sum(quantized.transpose(1, 2) * torch.from_numpy(cot)) + losses.sum()
    loss.backward()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(quantized.detach().numpy().transpose(0, 2, 1),
                               np.asarray(jquant), **VAL_TOL)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses), **VAL_TOL)
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1), np.asarray(jgx),
                               **GRAD_TOL)
    # the inference encode gives the training forward's codes
    np.testing.assert_array_equal(rvq.encode(xt.detach(), n_q).numpy(), codes.numpy())


@pytest.mark.parametrize("bandwidth", [None, 0.3, 0.9, 100.0])
def test_quantize_with_bandwidth_matches_jax(bandwidth):
    jrvq, params, rvq = _rvq_pair(1)
    x = np.random.default_rng(6).standard_normal((3, 7, 8)).astype(np.float32)
    want = jrvq.quantize_with_bandwidth(params, jnp.asarray(x), frame_rate=75.0,
                                        bandwidth=bandwidth)
    got = rvq.quantize_with_bandwidth(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                                      frame_rate=75.0, bandwidth=bandwidth)
    assert isinstance(got, q.QuantizedResult)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_allclose(got.quantized.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want.quantized), **VAL_TOL)
    np.testing.assert_array_equal(got.bandwidth.numpy(), np.asarray(want.bandwidth))
    np.testing.assert_allclose(got.penalty.item(), float(want.penalty), **VAL_TOL)


# ----------------------------------------------------------- initialisers


@pytest.mark.parametrize("k, cin_g, cout", [(7, 16, 32), (1, 512, 64), (16, 3, 5)])
def test_kaiming_uniform_conv_init_bounds_match_jax(k, cin_g, cout):
    fan_in = cin_g * k
    jax_bound = np.sqrt(2.0 / (1.0 + 5.0)) * np.sqrt(3.0 / fan_in)   # ops/conv.py's formula
    jw = np.asarray(jconv.kaiming_uniform_conv_init(jax.random.key(0), k, cin_g, cout))
    w = kaiming_uniform_conv_init(torch.Generator().manual_seed(0), k, cin_g, cout)
    assert jw.shape == (k, cin_g, cout) and w.shape == (cout, cin_g, k)
    assert float(w.abs().max()) <= jax_bound and np.abs(jw).max() <= jax_bound
    assert float(w.abs().max()) > 0.9 * jax_bound or w.numel() < 100
    # torch's own Conv1d init draws from the same U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    assert math.isclose(jax_bound, 1 / math.sqrt(fan_in), rel_tol=1e-12)
    again = kaiming_uniform_conv_init(torch.Generator().manual_seed(0), k, cin_g, cout)
    assert torch.equal(w, again)


@pytest.mark.parametrize("fan_in", [0, 7, 4096])
def test_conv_bias_init_bounds_match_jax(fan_in):
    jb = np.asarray(jconv.conv_bias_init(jax.random.key(1), fan_in, 300))
    b = conv_bias_init(torch.Generator().manual_seed(1), fan_in, 300)
    bound = 1 / np.sqrt(fan_in) if fan_in else 0.0
    assert b.shape == jb.shape == (300,)
    assert float(b.abs().max()) <= bound and np.abs(jb).max() <= bound
    if fan_in == 0:
        assert not b.any() and not jb.any()
    else:
        assert float(b.abs().max()) > 0.9 * bound
