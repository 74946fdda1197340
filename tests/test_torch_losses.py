"""The port's training losses against the JAX package's, on the CPU.

Each loss's value within rtol 1e-5 / atol 1e-6 and its gradient with
respect to its inputs within ‖g_port − g_jax‖ / ‖g_jax‖ <= 1e-4 (the
stft-based losses) or 1e-6 (the rest), on audio made from numpy seeds. The
GAN losses are held on the JAX discriminator's own outputs, carried across
(NHWC to the port's NCHW).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu import losses as jlosses
from neuralcodecs_tpu.models.dac.discriminator import DACDiscriminator as JDisc
from neuralcodecs_tpu_torch import losses

SR = 16000
VALUE = dict(rtol=1e-5, atol=1e-6)


def _pair(b: int = 2, t: int = 2048, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((b, t))).astype(np.float32)
    return x, (0.8 * x + 0.05 * rng.standard_normal((b, t))).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold(jfn, tfn, arrays: tuple, bar: float) -> None:
    """jfn(*arrays) against tfn(*tensors): value, and gradient in every input."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    val = tfn(*tensors)
    grads = torch.autograd.grad(val, tensors)
    np.testing.assert_allclose(val.item(), float(jval), **VALUE)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert _rel(g, jg) <= bar, (i, _rel(g, jg))


def test_l1_loss():
    _hold(jlosses.l1_loss, losses.l1_loss, _pair(), 1e-6)


MEL_CASES = {
    "defaults": dict(),  # (150, 80) mels at (2048, 512)
    "generator-loss": dict(n_mels=(80, 20), window_lengths=(512, 128)),
    "weights-pow": dict(n_mels=(40,), window_lengths=(256,), mag_weight=0.5, log_weight=2.0,
                        pow=1.0, clamp_eps=1e-4),
}


@pytest.mark.parametrize("name", list(MEL_CASES))
def test_mel_spectrogram_loss(name):
    kw = MEL_CASES[name]
    _hold(lambda x, y: jlosses.mel_spectrogram_loss(x, y, SR, **kw),
          lambda x, y: losses.mel_spectrogram_loss(x, y, SR, **kw), _pair(t=4096), 1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(window_lengths=(256, 64), mag_weight=0.5)],
                         ids=["defaults", "short"])
def test_multi_scale_stft_loss(kw):
    _hold(lambda x, y: jlosses.multi_scale_stft_loss(x, y, **kw),
          lambda x, y: losses.multi_scale_stft_loss(x, y, **kw), _pair(t=4096), 1e-3)


SISDR_CASES = {
    "defaults": dict(),
    "no-scaling": dict(scaling=False),
    "no-zero-mean": dict(zero_mean=False),
    "clip": dict(clip_min=-5.0),
    "sum": dict(reduction="sum"),
}


@pytest.mark.parametrize("name", list(SISDR_CASES))
def test_sisdr_loss(name):
    kw = SISDR_CASES[name]
    _hold(lambda x, y: jlosses.sisdr_loss(x, y, **kw),
          lambda x, y: losses.sisdr_loss(x, y, **kw), _pair(b=3, t=512), 1e-5)


def test_sisdr_loss_without_reduction():
    x, y = _pair(b=3, t=512)
    want = np.asarray(jlosses.sisdr_loss(jnp.asarray(x), jnp.asarray(y), reduction="none"))
    got = losses.sisdr_loss(torch.from_numpy(x), torch.from_numpy(y), reduction="none")
    np.testing.assert_allclose(got.numpy(), want, **VALUE)


@functools.lru_cache(maxsize=1)
def _disc_outputs():
    """The JAX discriminator's outputs on fake and real audio, each as
    numpy arrays in NCHW, with their nesting (per sub: n features + logits)."""
    disc = JDisc(periods=(2, 3), fft_sizes=(128,), seed=2)
    fake, real = _pair(t=1024, seed=4)
    to_nchw = lambda subs: [[np.asarray(o).transpose(0, 3, 1, 2) for o in s] for s in subs]
    run = jax.jit(disc.__call__)
    return to_nchw(run(disc.params, jnp.asarray(fake))), to_nchw(run(disc.params, jnp.asarray(real)))


def _flat(subs):
    return [o for s in subs for o in s], [len(s) for s in subs]


def _nest(flat, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(flat[i: i + n])
        i += n
    return out


@pytest.mark.parametrize("which", ["discriminator", "generator", "feature_matching"])
def test_gan_losses_on_the_jax_discriminators_outputs(which):
    fake, real = _disc_outputs()
    (fake_flat, sizes), (real_flat, _) = _flat(fake), _flat(real)
    n = len(fake_flat)
    jfn = {"discriminator": jlosses.discriminator_loss,
           "generator": lambda f, r: jlosses.generator_loss(f),
           "feature_matching": jlosses.feature_matching_loss}[which]
    tfn = {"discriminator": losses.discriminator_loss,
           "generator": lambda f, r: losses.generator_loss(f),
           "feature_matching": losses.feature_matching_loss}[which]

    def jloss(*arrays):  # NCHW -> the JAX package's NHWC
        nhwc = [a.transpose(0, 2, 3, 1) for a in arrays]
        return jfn(_nest(nhwc[:n], sizes), _nest(nhwc[n:], sizes))

    def tloss(*tensors):
        return tfn(_nest(list(tensors[:n]), sizes), _nest(list(tensors[n:]), sizes))

    arrays = (*fake_flat, *real_flat)
    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(len(arrays)))))(
        *(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    val = tloss(*tensors)
    grads = torch.autograd.grad(val, tensors, allow_unused=True)
    np.testing.assert_allclose(val.item(), float(jval), **VALUE)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        jg = np.asarray(jg)
        if not np.any(jg):  # the real side's features are detached, as stop_gradient does
            assert g is None or not torch.any(g), i
        else:
            assert _rel(g, jg) <= 1e-6, (i, _rel(g, jg))
