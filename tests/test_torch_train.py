"""The port's DAC training path against the JAX package's, on the CPU.

Tiny configs (tests/test_export_train.py's DAC: encoder_dim 8, rates
[2, 2], decoder_dim 32, codebooks of 16 x 4; the discriminator with periods
(2, 3) and one 128-point MRD), seeded JAX weights carried into the port by
``from_jax_params``, inputs from numpy seeds. Forward values within rtol
1e-4 / atol 1e-5; gradients per tensor within ``GRAD_BAR`` =
‖g_port − g_jax‖ / ‖g_jax‖ <= 1e-3. One SGD step (``optax.sgd`` against
``torch.optim.SGD``) moves each tensor by lr · g, so the step is held to the
same bar on the parameters' change. AdamW against ``optax.adamw`` fed the
same gradients within 1e-6.

The mel loss's gradient is ill-conditioned where the decoder's output has
mel bins near FFT rounding (clamp_eps 1e-5 < mel << the DC's rounding):
there d log10(mel²) = 2 / (mel ln 10) turns the f32 rounding of either FFT
into O(1) differences. At the JAX package's seed 0 the reference's own
gradient moves by 5% when its input moves by one ulp, so no port can meet
the bar there. The loss and step tests use seed ``WELL_CONDITIONED`` and
first assert that the reference is stable there (a one-ulp move changes its
mel gradient by < 1e-4); ``test_mel_gradient_conditioning`` shows both.

Also here: the straight-through repair (the gradient reaches the encoder, as
``jax.grad`` says it does), quantizer dropout under the JAX mask, remat, the
checkpoint round trip, the data pipeline's crops, and the dense
residual-unit ``Function``'s written-out backward (gradcheck in f64, with
its plain training form in place of the launch).
"""

import functools
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu.losses.audio import mel_spectrogram_loss as jmel_loss
from neuralcodecs_tpu.models.dac.discriminator import DACDiscriminator as JDisc
from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
from neuralcodecs_tpu.parallel import data as jdata
from neuralcodecs_tpu.parallel import train as jtrain
from neuralcodecs_tpu.parallel.mesh import make_mesh
from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from neuralcodecs_tpu_torch.ops.kernels.build import refuse_grad
from neuralcodecs_tpu_torch.ops.kernels.resunit import (
    DenseResidualUnitFn,
    residual_unit_plain,
    residual_unit_train_plain,
)
from neuralcodecs_tpu_torch.parallel import (
    AudioCropDataset,
    adamw,
    dac_generator_loss,
    make_gan_train_step,
    make_train_step,
    prefetch,
    restore_train_state,
    save_train_state,
)

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_BAR = 1e-3
SR = 16000
SAMPLES = 1024  # > 2 x 256: torch.stft's reflect pad of the 512-point mel scale
WELL_CONDITIONED = 9  # a JAX seed where the mel gradient is stable (module docstring)


def dac_kwargs(**over) -> dict:
    base = dict(sample_rate=SR, encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32,
                decoder_rates=[2, 2], n_codebooks=2, codebook_size=16, codebook_dim=4)
    base.update(over)
    return base


def carry(jparams, module) -> dict:
    return from_jax_params({k: np.asarray(v) for k, v in jparams.items()},
                           transposed_groups(module))


def dac_pair(seed: int = 0, **over) -> tuple[JDAC, DAC]:
    jmodel = JDAC(JDACConfig(**dac_kwargs(**over)), seed=seed)
    port = DAC(DACConfig(**dac_kwargs(**over)), device="cpu")
    port.load_state_dict(carry(jmodel.params, port), strict=True)
    return jmodel, port


def disc_pair(seed: int = 1) -> tuple[JDisc, DACDiscriminator]:
    jdisc = JDisc(periods=(2, 3), fft_sizes=(128,), seed=seed)
    port = DACDiscriminator(periods=(2, 3), fft_sizes=(128,), device="cpu")
    port.load_state_dict(carry(jdisc.params, port), strict=True)
    return jdisc, port


def audio_batch(b: int = 2, t: int = SAMPLES, seed: int = 0) -> np.ndarray:
    """[B, T, 1] f32, the JAX package's training layout."""
    return (0.1 * np.random.default_rng(seed).standard_normal((b, t, 1))).astype(np.float32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm > 0 else float(np.abs(got).max())


def assert_grads_close(port_grads: dict, jax_grads: dict, module, bar: float = GRAD_BAR
                       ) -> float:
    """Per tensor ‖g_port − g_jax‖ / ‖g_jax‖ <= bar (a tensor JAX gives a
    zero gradient must get none or zeros); returns the worst ratio."""
    want = carry(jax_grads, module)
    assert set(port_grads) == set(want)
    worst = 0.0
    for key, w in want.items():
        g = port_grads[key]
        g = torch.zeros_like(w) if g is None else g
        err = rel_err(g.detach().numpy(), w.numpy())
        assert err <= bar, (key, err, float(w.abs().max()))
        worst = max(worst, err)
    return worst


def port_grads(module) -> dict:
    return {k: p.grad for k, p in module.named_parameters()}


# ----------------------------------------------------- straight-through repair


def test_dac_gradient_reaches_the_encoder_as_in_jax():
    """The gradient of mean(audio²) + both VQ losses through _forward_fn, for
    every parameter: the straight-through estimator passes the decoder's
    gradient to the encoder (without the repair it is exactly 0 there), the
    commitment loss reaches the encoder and the codebook loss the codebook."""
    jmodel, port = dac_pair(encoder_dim=16, encoder_rates=[2, 4], decoder_dim=64,
                            decoder_rates=[4, 2], n_codebooks=3, codebook_size=32)
    audio = audio_batch(2, 4096)

    def jloss(params):
        out = jmodel._forward_fn(params, jnp.asarray(audio), None)
        return (jnp.mean(out["audio"] ** 2) + out["vq/commitment_loss"]
                + out["vq/codebook_loss"])

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jmodel.params)
    out = port._forward_fn(torch.from_numpy(audio).transpose(1, 2), None)
    loss = torch.mean(out["audio"] ** 2) + out["vq/commitment_loss"] + out["vq/codebook_loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **TOL)
    assert float(port.encoder.block[0].weight.grad.abs().max()) > 0
    assert_grads_close(port_grads(port), jgrads, port)


def test_snac_gradient_reaches_the_encoder_as_in_jax():
    """SNAC, noise off: the gradient of mean(audio²) for every parameter;
    the codebooks get none (SNAC has no VQ losses), in both packages."""
    kwargs = dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 4], decoder_dim=64,
                  decoder_rates=[4, 2], attn_window_size=None, codebook_size=64,
                  codebook_dim=8, vq_strides=[2, 1], noise=False, depthwise=False)
    jmodel = JSNAC(JSNACConfig(**kwargs), seed=0)
    port = SNAC(SNACConfig(**kwargs), device="cpu")
    port.load_state_dict(carry(jmodel.params, port), strict=True)
    audio = audio_batch(2, 8 * 64)
    padded, _ = jmodel._prepare(audio[..., 0])

    def jloss(params):
        return jnp.mean(jmodel._forward_fn(params, padded, None)[0] ** 2)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jmodel.params)
    out, _ = port._forward_fn(torch.tensor(np.asarray(padded)).transpose(1, 2), None)
    loss = torch.mean(out ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **TOL)
    assert float(port.encoder.block[0].weight.grad.abs().max()) > 0
    assert all(vq.codebook.weight.grad is None for vq in port.quantizer.quantizers)
    assert_grads_close(port_grads(port), jgrads, port)


# ------------------------------------------------------------ forward_train


def _jax_mask(jmodel: JDAC, b: int, key) -> np.ndarray:
    """The mask JAX's forward_train draws from ``key`` (model.py:270-276)."""
    n = len(jmodel.quantizers)
    mask = jnp.full((b,), n + 1, jnp.int32)
    counts = jax.random.randint(key, (b,), 1, n + 1)
    mask = jnp.where(jnp.arange(b) < int(b * jmodel.config.quantizer_dropout), counts, mask)
    return np.asarray(mask)


def test_forward_train_under_the_jax_mask():
    jmodel, port = dac_pair(n_codebooks=4, quantizer_dropout=0.5)
    audio = audio_batch(4, 512, seed=3)
    key = jax.random.key(5)
    mask = _jax_mask(jmodel, 4, key)
    assert (mask[:2] <= 4).all() and (mask[2:] == 5).all() and len(set(mask[:2])) > 0

    def jloss(params):
        out = jmodel.forward_train(params, jnp.asarray(audio), key)
        return (jnp.mean(out["audio"] ** 2) + out["vq/commitment_loss"]
                + out["vq/codebook_loss"]), out

    (jval, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jmodel.params)
    port.draw_dropout_mask = lambda b, generator: torch.tensor(mask)  # JAX's draw, replayed
    out = port.forward_train(torch.from_numpy(audio).transpose(1, 2))
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_allclose(out["audio"].detach().numpy(),
                               np.asarray(jout["audio"]).transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(out["z"].detach().numpy(),
                               np.asarray(jout["z"]).transpose(0, 2, 1), **TOL)
    for k in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), **TOL, err_msg=k)
    loss = torch.mean(out["audio"] ** 2) + out["vq/commitment_loss"] + out["vq/codebook_loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **TOL)
    assert_grads_close(port_grads(port), jgrads, port)


def test_forward_train_draws_the_first_rows_mask():
    _, port = dac_pair(n_codebooks=4, quantizer_dropout=0.5)
    mask = port.draw_dropout_mask(8, torch.Generator().manual_seed(0))
    assert mask.shape == (8,) and ((mask[:4] >= 1) & (mask[:4] <= 4)).all()
    assert (mask[4:] == 5).all()
    again = port.draw_dropout_mask(8, torch.Generator().manual_seed(0))
    assert torch.equal(mask, again)
    _, port0 = dac_pair(n_codebooks=4)  # quantizer_dropout 0: every stage active
    assert (port0.draw_dropout_mask(3) == 5).all()


def test_quantize_st_matches_jax():
    from neuralcodecs_tpu.ops.vq import quantize_st as jquantize_st
    from neuralcodecs_tpu_torch.ops.vq import quantize_st

    rng = np.random.default_rng(4)
    latents = rng.standard_normal((2, 5, 4)).astype(np.float32)
    codebook = rng.standard_normal((16, 4)).astype(np.float32)
    cot = rng.standard_normal(latents.shape).astype(np.float32)
    (jq, jcodes), vjp = jax.vjp(lambda x: jquantize_st(x, jnp.asarray(codebook)),
                                jnp.asarray(latents))
    x = torch.from_numpy(latents.copy()).requires_grad_()
    q, codes = quantize_st(x, torch.from_numpy(codebook))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(jq))
    (g,) = torch.autograd.grad(q, x, torch.from_numpy(cot))
    (jg,) = vjp((jnp.asarray(cot), np.zeros(jcodes.shape, jax.dtypes.float0)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))  # the identity: straight through


# ---------------------------------------------------------------- the losses


def mel_sensitivity(jmodel: JDAC, audio: np.ndarray) -> float:
    """‖Δg‖ / ‖g‖ of the JAX mel loss's gradient at the model's output when
    that output moves by one ulp: the reference's own noise floor there."""
    x = jax.jit(jmodel._forward_fn, static_argnums=2)(
        jmodel.params, jnp.asarray(audio), None)["audio"][..., 0]
    grad = jax.jit(jax.grad(lambda a: jmel_loss(a, jnp.asarray(audio[..., 0]), SR,
                                                 n_mels=(80, 20), window_lengths=(512, 128))))
    g = np.asarray(grad(x))
    g_ulp = np.asarray(grad(jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf)))))
    return rel_err(g_ulp, g)


def test_mel_gradient_conditioning():
    audio = audio_batch()
    assert mel_sensitivity(dac_pair(seed=0)[0], audio) > 1e-2
    assert mel_sensitivity(dac_pair(seed=WELL_CONDITIONED)[0], audio) < 1e-4


def test_dac_generator_loss_value_and_gradients():
    jmodel, port = dac_pair(seed=WELL_CONDITIONED)
    audio = audio_batch()
    assert mel_sensitivity(jmodel, audio) < 1e-4
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.dac_generator_loss(jmodel, p, jnp.asarray(audio), SR)))(jmodel.params)
    loss = dac_generator_loss(port, torch.from_numpy(audio), SR)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **TOL)
    assert_grads_close(port_grads(port), jgrads, port)


# ----------------------------------------------------------------- the steps


def _one_device_mesh():
    return make_mesh(dp=1, devices=jax.devices()[:1])


def _assert_step_moved_alike(before: dict, port_after: dict, jax_after: dict, module) -> None:
    """The change of each tensor, port against JAX, within GRAD_BAR."""
    want = carry(jax_after, module)
    for key, w in want.items():
        delta_port = port_after[key].detach().double() - before[key].double()
        delta_jax = w.double() - before[key].double()
        assert rel_err(delta_port.numpy(), delta_jax.numpy()) <= GRAD_BAR, key


def test_train_step_sgd_matches_jax():
    jmodel, port = dac_pair(seed=WELL_CONDITIONED)
    audio = audio_batch()
    assert mel_sensitivity(jmodel, audio) < 1e-4
    lr = 0.5
    j_init, j_step = jtrain.make_train_step(jmodel, _one_device_mesh(), optax.sgd(lr),
                                            sample_rate=SR)
    jstate, jloss = j_step(j_init(jmodel.params), jnp.asarray(audio))
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    init_fn, step_fn = make_train_step(port, None, functools.partial(torch.optim.SGD, lr=lr))
    state, loss = step_fn(init_fn(), torch.from_numpy(audio))
    assert state.step == 1 and int(jstate.step) == 1
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_step_moved_alike(before, state.params, jstate.params, port)


def test_gan_train_step_sgd_matches_jax():
    jmodel, port = dac_pair(seed=WELL_CONDITIONED)
    jdisc, disc = disc_pair()
    audio = audio_batch()
    assert mel_sensitivity(jmodel, audio) < 1e-4
    lr = 0.5
    j_init, j_step = jtrain.make_gan_train_step(
        jmodel, jdisc, _one_device_mesh(), gen_optimizer=optax.sgd(lr),
        disc_optimizer=optax.sgd(lr), sample_rate=SR)
    (jg, jd), jmetrics = j_step(j_init(), jnp.asarray(audio))
    g_before = {k: p.detach().clone() for k, p in port.named_parameters()}
    d_before = {k: p.detach().clone() for k, p in disc.named_parameters()}
    sgd = functools.partial(torch.optim.SGD, lr=lr)
    init_fn, step_fn = make_gan_train_step(port, disc, None, sgd, sgd)
    (g, d), metrics = step_fn(init_fn(), torch.from_numpy(audio))
    assert set(metrics) == set(jmetrics) | {"disc/total"} == {
        "gen/total", "gen/mel", "gen/adv", "gen/feat", "gen/recon", "disc/total"}
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[key]), **TOL, err_msg=key)
    assert g.step == d.step == 1
    _assert_step_moved_alike(d_before, d.params, jd.params, disc)
    _assert_step_moved_alike(g_before, g.params, jg.params, port)
    # the generator's backward left the discriminator's own gradient alone
    assert all(p.grad is not None for p in disc.parameters())


@pytest.mark.parametrize("hyper", [dict(), dict(b1=0.8, b2=0.99)], ids=["train", "gan"])
def test_adamw_matches_optax_over_three_steps(hyper):
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = optax.adamw(1e-4, **hyper)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = adamw(**hyper)(tparams.values())
    for g in grads:
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_remat_gives_the_same_step():
    _, port_a = dac_pair()
    _, port_b = dac_pair()
    audio = torch.from_numpy(audio_batch())
    sgd = functools.partial(torch.optim.SGD, lr=0.5)
    init_a, step_a = make_train_step(port_a, None, sgd, remat=False)
    init_b, step_b = make_train_step(port_b, None, sgd, remat=True)
    _, loss_a = step_a(init_a(), audio)
    _, loss_b = step_b(init_b(), audio)
    assert float(loss_a) == float(loss_b)
    for (k, a), (_, b) in zip(port_a.named_parameters(), port_b.named_parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    _, port = dac_pair()
    audio = torch.from_numpy(audio_batch())
    init_fn, step_fn = make_train_step(port)
    state, _ = step_fn(init_fn(), audio)
    state, _ = step_fn(state, audio)
    save_train_state(state, tmp_path / "ckpt")
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    saved_opt = state.opt_state.state_dict()

    _, other = dac_pair(seed=9)
    o_init, o_step = make_train_step(other)
    restored = restore_train_state(tmp_path / "ckpt", o_init())
    assert restored.step == 2
    for k, v in saved.items():
        assert torch.equal(restored.params[k], v), k
    got_opt = restored.opt_state.state_dict()
    for i, entry in saved_opt["state"].items():
        for key, value in entry.items():
            assert torch.equal(got_opt["state"][i][key].cpu(), value.cpu()), (i, key)
    # training goes on from the restored state as from the saved one
    state, loss = step_fn(state, audio)
    restored, loss_r = o_step(restored, audio)
    assert float(loss) == float(loss_r) and restored.step == 3
    for (k, a), (_, b) in zip(port.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), k


def test_restore_refuses_another_models_state(tmp_path):
    _, port = dac_pair()
    init_fn, _ = make_train_step(port)
    save_train_state(init_fn(), tmp_path / "ckpt")
    _, bigger = dac_pair(n_codebooks=3)
    with pytest.raises(ValueError, match="template"):
        restore_train_state(tmp_path / "ckpt", make_train_step(bigger)[0]())


# ------------------------------------------------------------------- the data


def _write_wav(path, data: np.ndarray, sr: int) -> None:
    """data [T] or [T, C] in [-1, 1] as 16-bit PCM."""
    data = data.reshape(data.shape[0], -1)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(data.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("normalize_db", [None, -20.0])
def test_audio_crops_equal_jax(tmp_path, normalize_db):
    rng = np.random.default_rng(11)
    (tmp_path / "sub").mkdir()
    _write_wav(tmp_path / "a.wav", 0.3 * rng.standard_normal(3000), SR)
    _write_wav(tmp_path / "sub" / "b.wav", 0.3 * rng.standard_normal((5000, 2)), SR)
    _write_wav(tmp_path / "short.wav", 0.3 * rng.standard_normal(300), SR)
    (tmp_path / "notes.txt").write_text("not audio")
    kw = dict(crop_seconds=0.05, batch_size=4, seed=3, loop=True, normalize_db=normalize_db)
    want = jdata.AudioCropDataset(tmp_path, SR, **kw)
    got = AudioCropDataset(tmp_path, SR, **kw)
    assert [p.name for p in got.files] == [p.name for p in want.files] == [
        "a.wav", "short.wav", "b.wav"]
    for w, g, _ in zip(want, got, range(5)):
        assert g.shape == (4, 800, 1) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_prefetch_keeps_order_and_ends():
    items = [np.full(3, i) for i in range(7)]
    assert [int(x[0]) for x in prefetch(iter(items), depth=2)] == list(range(7))
    assert list(prefetch(iter([]))) == []


# ------------------------------------------- kernel 2b's written-out backward


def _unit_args(c: int, dtype, zero_alpha: bool, seed: int = 0) -> tuple:
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, dtype=dtype)).requires_grad_()

    a1 = torch.rand(1, c, 1, generator=g, dtype=dtype) + 0.5
    a2 = torch.rand(1, c, 1, generator=g, dtype=dtype) + 0.5
    if zero_alpha:  # snake is the identity there (ops/snake.py)
        a1[0, 1], a2[0, 2] = 0.0, 0.0
    return (a1.requires_grad_(), rand(c, c, 7, scale=0.3), rand(c, scale=0.1),
            a2.requires_grad_(), rand(c, c, 1, scale=0.3), rand(c, scale=0.1))


@pytest.mark.parametrize("dilation", [1, 3])
def test_dense_unit_backward_gradcheck_f64(dilation):
    """The Function's backward (with the plain training form in place of the
    launch) against finite differences. (At α = 0 snake is the identity by
    a ``where``, whose derivative in α is 0 in JAX and here, while a finite
    difference sees the limit x²: those channels are held to autograd in
    the next test.)"""
    args = _unit_args(4, torch.float64, zero_alpha=False)
    x = torch.randn(2, 4, 19, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *t: DenseResidualUnitFn.apply(*t, dilation), (x, *args), eps=1e-6,
        atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("zero_alpha", [False, True], ids=["alpha", "alpha0"])
def test_dense_unit_backward_equals_autograd_of_the_plain_chain(zero_alpha):
    args = _unit_args(6, torch.float32, zero_alpha)
    x = torch.randn(3, 6, 50, generator=torch.Generator().manual_seed(2)).requires_grad_()
    g = torch.randn(3, 6, 50, generator=torch.Generator().manual_seed(3))
    inputs = (x, *args)
    out = DenseResidualUnitFn.apply(*inputs, 3)
    got = torch.autograd.grad(out, inputs, g)
    want_out = residual_unit_plain(*inputs, dilation=3)
    want = torch.autograd.grad(want_out, inputs, g)
    assert torch.equal(out, want_out)
    for name, a, b in zip(("x", "alpha1", "w_dil", "b_dil", "alpha2", "w_pw", "b_pw"),
                          got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    if zero_alpha:
        assert float(got[1][0, 1, 0]) == 0.0 and float(got[4][0, 2, 0]) == 0.0


def test_dense_unit_training_form_keeps_what_the_backward_reads():
    args = _unit_args(5, torch.float32, zero_alpha=False)
    x = torch.randn(2, 5, 33)
    with torch.no_grad():
        out, h, z, y = residual_unit_train_plain(x, *args, dilation=9)
        assert torch.equal(out, residual_unit_plain(x, *args, dilation=9))
        from neuralcodecs_tpu_torch.ops.snake import snake

        assert torch.equal(h, snake(x, args[0])) and torch.equal(y, snake(z, args[3]))


def test_refuse_grad_raises_only_where_a_backward_is_needed():
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("lstm_scan", torch.ones(3), t)
    with torch.no_grad():
        refuse_grad("lstm_scan", t)
    refuse_grad("lstm_scan", torch.ones(3))
