"""The PyTorch port's SNAC against the JAX package's SNAC, on the CPU.

Seeded JAX parameters are converted with ``from_jax_params`` and loaded into
the port with ``load_state_dict(strict=True)``; the same numpy audio goes
through both. The JAX side runs ``_forward_fn(params, padded, None)``: the
noise-free round trip, since torch cannot reproduce the JAX noise stream.
RVQ codes must match bit-exactly; audio within rtol 1e-4 / atol 1e-5 (the
two frameworks sum the convolutions in different orders), and the frozen
golden within its own bar (rtol 1e-3 / atol 1e-4, SNR > 55 dB).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

GOLDEN = Path(__file__).resolve().parent / "goldens" / "snac_golden.npz"


def tiny_kwargs(**over) -> dict:
    base = dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 4],
                decoder_dim=64, decoder_rates=[4, 2], attn_window_size=None,
                codebook_size=64, codebook_dim=8, vq_strides=[2, 1],
                noise=False, depthwise=False)
    base.update(over)
    return base


def build_pair(kwargs: dict, seed: int = 0) -> tuple[JSNAC, SNAC]:
    """A seeded JAX SNAC and the port loaded with the same weights."""
    jmodel = JSNAC(JSNACConfig(**kwargs), seed=seed)
    port = SNAC(SNACConfig(**kwargs), device="cpu")
    sd = from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                         transposed_groups(port))
    port.load_state_dict(sd, strict=True)
    return jmodel, port.eval()


def jax_roundtrip(jmodel: JSNAC, audio: np.ndarray):
    padded, length = jmodel._prepare(audio)
    out, codes = jax.jit(jmodel._forward_fn)(jmodel.params, padded, None)
    return np.asarray(out)[:, :length, 0], [np.asarray(c) for c in codes]


def port_roundtrip(port: SNAC, audio: np.ndarray):
    padded, length = port._prepare(audio)
    with torch.no_grad():
        out, codes = port._forward_fn(padded, None)
    return out[:, 0, :length].numpy(), [c.numpy() for c in codes]


def assert_codes_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stage {i} codes differ")


CONFIGS = {
    "plain": {},
    "depthwise-noise-weights": {"depthwise": True, "noise": True},
    "local-mha": {"attn_window_size": 8, "encoder_dim": 32, "decoder_dim": 128,
                  "depthwise": True},
    "stride3-decoder": {"encoder_rates": [2, 3], "decoder_rates": [3, 2],
                        "depthwise": True},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_snac_matches_jax(rng, name):
    kwargs = tiny_kwargs(**CONFIGS[name])
    jmodel, port = build_pair(kwargs)
    n = jmodel.config.pad_to * 3 + 17  # exercises pad and trim
    audio = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    want_audio, want_codes = jax_roundtrip(jmodel, audio)
    got_audio, got_codes = port_roundtrip(port, audio)
    assert_codes_equal(got_codes, want_codes)
    np.testing.assert_allclose(got_audio, want_audio, rtol=1e-4, atol=1e-5)


def test_state_dict_names_match_jax_params():
    jmodel = JSNAC(JSNACConfig.snac_24khz())
    port = SNAC(SNACConfig.snac_24khz(), device="cpu")
    assert set(port.state_dict()) == set(jmodel.params)
    assert len(port.state_dict()) == 198
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(v.shape)) for v in jmodel.params.values())


def test_chunked_jax_forward_codes_equal_unchunked_port(rng):
    """JAX's public forward runs the chunked path (8 chunks here); the port
    runs unchunked; the codes agree."""
    jmodel, port = build_pair(tiny_kwargs(depthwise=True))
    audio = (0.3 * rng.standard_normal(4096)).astype(np.float32)
    assert jmodel._auto_chunks(jmodel._prepare(audio)[0].shape[1]) > 1
    _, want = jmodel.forward(audio)
    _, got = port.forward(audio)
    assert_codes_equal([c.numpy() for c in got], [np.asarray(c) for c in want])


def test_encode_decode_agree_with_forward_and_jax(rng):
    jmodel, port = build_pair(tiny_kwargs(depthwise=True))
    audio = (0.3 * rng.standard_normal(port.config.pad_to * 4)).astype(np.float32)
    out, codes = port.forward(audio)
    enc = port.encode(audio)
    assert_codes_equal([c.numpy() for c in enc], [c.numpy() for c in codes])
    dec = port.decode(enc)
    assert tuple(dec.shape) == tuple(out.shape) == (1, audio.shape[0])
    # decode embeds the codes directly; forward adds z_e + (z_q - z_e), which
    # rounds differently in the last bits
    np.testing.assert_allclose(dec.numpy(), out.numpy(), rtol=1e-4, atol=1e-5)
    want = jax.jit(jmodel._decode_fn)(jmodel.params, [jnp.asarray(c.numpy()) for c in enc],
                                      None)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want)[:, :, 0], rtol=1e-4, atol=1e-5)


def test_process_audio_resamples_like_jax(rng):
    jmodel, port = build_pair(tiny_kwargs())
    audio = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    got = port.process_audio(audio, sample_rate=16000)
    want = jmodel.process_audio(audio, sample_rate=16000)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (12000,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_noise_is_seeded_by_the_generator(rng):
    port = SNAC(SNACConfig(**tiny_kwargs(noise=True)), device="cpu", seed=3).eval()
    audio = (0.3 * rng.standard_normal(port.config.pad_to)).astype(np.float32)
    a1, c1 = port.forward(audio)
    a2, _ = port.forward(audio)  # no generator: a fresh one seeded 0 each call
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    a3, c3 = port.forward(audio, torch.Generator().manual_seed(123))
    assert not torch.allclose(a1, a3)
    assert_codes_equal([c.numpy() for c in c3], [c.numpy() for c in c1])
    with torch.no_grad():  # no generator: the noise-free path
        a4, c4 = port._forward_fn(port._prepare(audio)[0], None)
    assert not torch.allclose(a1, a4[:, 0, :audio.shape[0]])
    assert_codes_equal([c.numpy() for c in c4], [c.numpy() for c in c1])


@pytest.mark.parametrize("preset", ["snac_24khz", "snac_32khz", "snac_44khz"])
def test_presets_match_jax(preset):
    port, ref = getattr(SNACConfig, preset)(), getattr(JSNACConfig, preset)()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.hop_length, port.pad_to) == (ref.hop_length, ref.pad_to)


def test_snac_golden_through_port():
    g = np.load(GOLDEN)
    cfg = SNACConfig(sampling_rate=44100, encoder_dim=8, encoder_rates=[2, 3, 8, 8],
                     decoder_dim=128, decoder_rates=[8, 8, 3, 2], attn_window_size=8,
                     codebook_size=4096, codebook_dim=8, vq_strides=[8, 4, 2, 1],
                     noise=False, depthwise=True)
    model = SNAC(cfg, device="cpu")
    model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                           if k.startswith("sd/")}, strict=True)
    audio_hat, codes = model.forward(g["audio"])
    assert len(codes) == 4
    for i, c in enumerate(codes):
        np.testing.assert_array_equal(c.numpy(), g[f"codes/{i}"].astype(np.int32),
                                      err_msg=f"stage {i} codes drifted")
    ref = g["decoded"][: g["audio"].shape[0]]
    got = audio_hat[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    snr = 10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-20))
    assert snr > 55.0


def test_snac_24khz_full_width_codes_match_jax():
    """Full-width SNAC-24k from seeded JAX parameters on 8192 samples."""
    kwargs = {k: v for k, v in dataclasses.asdict(SNACConfig.snac_24khz()).items()
              if k != "architecture"}
    jmodel, port = build_pair(kwargs, seed=20260816)
    audio = (0.3 * np.random.default_rng(20260816).standard_normal(8192)).astype(np.float32)
    want_audio, want_codes = jax_roundtrip(jmodel, audio)
    got_audio, got_codes = port_roundtrip(port, audio)
    assert_codes_equal(got_codes, want_codes)
    assert np.isfinite(got_audio).all()
    np.testing.assert_allclose(got_audio, want_audio, rtol=1e-4, atol=1e-5)
