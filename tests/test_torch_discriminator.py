"""The port's DAC discriminator against the JAX package's, on the CPU.

Seeded JAX weights carried by ``from_jax_params`` (HWIO to torch's
[Cout, Cin, kh, kw]); audio from numpy seeds. Every sub-discriminator's
features and logits within rtol 1e-4 / atol 1e-5 (the JAX package's NHWC
transposed to the port's NCHW); gradients of a scalar of all outputs with
respect to the audio and to every weight within ‖Δg‖ / ‖g‖ <= 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.dac.discriminator import DACDiscriminator as JDisc
from neuralcodecs_tpu_torch.core.weights import from_jax_params, to_jax_params
from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator

TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {
    "tiny": dict(periods=(2, 3), fft_sizes=(128,)),
    "defaults-at-short-audio": dict(),  # (2, 3, 5, 7, 11), (2048, 1024, 512)
}
SAMPLES = {"tiny": 1000, "defaults-at-short-audio": 2200}  # ragged against every period


def _pair(name: str, seed: int = 3) -> tuple[JDisc, DACDiscriminator]:
    jdisc = JDisc(**CONFIGS[name], seed=seed)
    port = DACDiscriminator(**CONFIGS[name], device="cpu")
    port.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in jdisc.params.items()}),
                         strict=True)
    return jdisc, port


def _audio(name: str, b: int = 2) -> np.ndarray:
    t = SAMPLES[name]
    return (0.2 * np.random.default_rng(5).standard_normal((b, t))).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_parameter_names_are_the_jax_keys():
    jdisc, port = _pair("defaults-at-short-audio")
    assert set(port.state_dict()) == set(jdisc.params)
    for key, value in port.state_dict().items():
        want = np.asarray(jdisc.params[key])
        assert value.shape == (want.shape[::-1][:2] + want.shape[:2] if value.dim() == 4
                               else want.shape), key


def test_conv2d_weights_round_trip_through_the_jax_layout():
    _, port = _pair("tiny")
    native = to_jax_params(port.state_dict())
    back = from_jax_params(native)
    for key, value in port.state_dict().items():
        assert torch.equal(back[key], value), key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_output_matches_jax(name):
    jdisc, port = _pair(name)
    audio = _audio(name)
    want = jax.jit(jdisc.__call__)(jdisc.params, jnp.asarray(audio))
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
    assert len(got) == len(want) == len(CONFIGS[name].get("periods", (2, 3, 5, 7, 11))) + len(
        CONFIGS[name].get("fft_sizes", (2048, 1024, 512)))
    for i, (g_sub, w_sub) in enumerate(zip(got, want)):
        assert len(g_sub) == len(w_sub)
        for j, (g, w) in enumerate(zip(g_sub, w_sub)):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            assert tuple(g.shape) == w.shape, (i, j)
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"sub {i} output {j}")


def _scalar(outputs, weights):
    """Σ over every output of mean(output · its fixed random weight)."""
    flat = [o for sub in outputs for o in sub]
    return sum((o * w).mean() for o, w in zip(flat, weights))


def test_gradients_in_the_audio_and_the_weights_match_jax():
    jdisc, port = _pair("tiny")
    audio = _audio("tiny")
    shapes = [o.shape for sub in jax.eval_shape(jdisc.__call__, jdisc.params,
                                                jnp.asarray(audio)) for o in sub]
    rng = np.random.default_rng(8)
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]  # NHWC

    def jloss(params, x):
        return _scalar(jdisc(params, x), [jnp.asarray(w) for w in weights])

    jg_params, jg_audio = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jdisc.params,
                                                                  jnp.asarray(audio))
    x = torch.from_numpy(audio.copy()).requires_grad_()
    loss = _scalar(port(x), [torch.from_numpy(w.transpose(0, 3, 1, 2).copy()) for w in weights])
    loss.backward()
    assert _rel(x.grad.numpy(), jg_audio) <= 1e-4
    want = from_jax_params({k: np.asarray(v) for k, v in jg_params.items()})
    for key, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want[key].numpy()) <= 1e-4, key
