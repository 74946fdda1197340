"""The PyTorch port's Encodec against the JAX package's Encodec, on the CPU.

Seeded JAX parameters are converted with ``from_jax_params`` and loaded into
the port with ``load_state_dict(strict=True)``; the same numpy audio goes
through both. The configurations are ``tests/test_encodec.py``'s
``tiny_config`` in the causal-mono form, the stereo / time_group_norm /
normalize form and a chunked 48 kHz-style form. RVQ codes must match
bit-exactly; audio within rtol 1e-4 / atol 1e-5 (the two frameworks sum the
convolutions and the LSTM products in different orders). The raw .ecdc
golden must be reproduced byte for byte.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.encodec import EncodecConfig as JEncodecConfig
from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from test_encodec import tiny_config

GOLDEN = Path(__file__).resolve().parent / "goldens" / "ecdc_golden.npz"


def port_config(jcfg: JEncodecConfig) -> EncodecConfig:
    return EncodecConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(EncodecConfig)
                            if f.name != "architecture"})


def build_pair(jcfg: JEncodecConfig, seed: int = 0) -> tuple[JEncodec, Encodec]:
    """A seeded JAX Encodec and the port loaded with the same weights."""
    jmodel = JEncodec(jcfg, seed=seed)
    port = Encodec(port_config(jcfg), device="cpu")
    sd = from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                         transposed_groups(port))
    port.load_state_dict(sd, strict=True)
    return jmodel, port.eval()


def _audio(channels: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((channels, n))).astype(np.float32)


CONFIGS = {
    "causal-mono": {},
    "stereo-groupnorm-normalize": {"use_causal_conv": False, "norm_type": "time_group_norm",
                                   "channels": 2, "normalize": True},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encodec_matches_jax(name):
    jmodel, port = build_pair(tiny_config(**CONFIGS[name]))
    audio = _audio(port.config.channels, 2000)  # not a hop multiple
    want = jmodel.encode(audio)
    got = port.encode(audio)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].codes.numpy(), np.asarray(want[0].codes),
                                  err_msg="RVQ codes must be bit-exact")
    if port.config.normalize:
        np.testing.assert_allclose(got[0].scale.numpy(), np.asarray(want[0].scale),
                                   rtol=1e-6, atol=0)
    want_audio = np.asarray(jmodel.decode(want))
    got_audio = port.decode(got).numpy()
    assert got_audio.shape == want_audio.shape
    np.testing.assert_allclose(got_audio, want_audio, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.forward(audio).numpy(),
                               np.asarray(jmodel.forward(audio)), rtol=1e-4, atol=1e-5)


def test_chunked_forward_matches_jax_and_frames_api():
    """48 kHz-style: stereo, non-causal, time_group_norm, normalize, chunks
    of 2000 samples with 1% overlap; 5000 samples give two full chunks and a
    tail. The port's chunked forward (full chunks as one batch, the tail as a
    second) against JAX's single-program forward (its ``_stream_roundtrip_fn``)
    and against the port's decode of the frames it encoded."""
    jcfg = tiny_config(chunk_length_s=0.125, overlap=0.01, use_causal_conv=False,
                       norm_type="time_group_norm", channels=2, normalize=True)
    jmodel, port = build_pair(jcfg, seed=3)
    audio = _audio(2, 5000, seed=3)
    frames = port.encode(audio)
    want_frames = jmodel.encode(audio)
    assert len(frames) == len(want_frames) == 3
    for f, w in zip(frames, want_frames):
        np.testing.assert_array_equal(f.codes.numpy(), np.asarray(w.codes))
    got = port.forward(audio).numpy()
    assert got.shape == (1, 2, 5000)
    np.testing.assert_allclose(got, np.asarray(jmodel.forward(audio)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, port.decode(frames)[..., :5000].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_from_jax_params_keeps_codebooks_and_transposes_lstm():
    """Encodec's codebooks [K, D] keep their layout; the LSTM weights, which
    the JAX package stores as [in, 4H], become torch's [4H, in]."""
    g = np.load(GOLDEN)
    params = {k[3:]: g[k] for k in g.files if k.startswith("sd/")}
    sd = from_jax_params(params)
    for i in range(4):
        for name in ("embed", "embed_avg"):
            key = f"quantizer.layers.{i}.codebook.{name}"
            assert tuple(sd[key].shape) == (32, 16)
            np.testing.assert_array_equal(sd[key].numpy(), params[key])
    for prefix in ("encoder.layers.7", "decoder.layers.1"):
        for name in ("weight_ih_l0", "weight_hh_l0", "weight_ih_l1", "weight_hh_l1"):
            key = f"{prefix}.lstm.{name}"
            assert tuple(sd[key].shape) == (128, 32)
            np.testing.assert_array_equal(sd[key].numpy(), params[key].T)


def test_vq_projections_match_jax(rng):
    """codebook_dim != dim brackets the codebook with torch-Linear
    projections, which the JAX package also stores as [out, in]."""
    from neuralcodecs_tpu.models.encodec.quantize import VectorQuantizer as JVectorQuantizer

    from neuralcodecs_tpu_torch.models.encodec.quantize import VectorQuantizer

    jvq = JVectorQuantizer("vq", dim=12, codebook_size=32, codebook_dim=6)
    params = {}
    jvq.init(jax.random.key(0), params)
    vq = VectorQuantizer(12, 32, 6)
    vq.load_state_dict(from_jax_params({k[3:]: np.asarray(v) for k, v in params.items()}),
                       strict=True)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    want = np.asarray(jvq.encode(params, x))
    with torch.no_grad():
        got = vq.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(vq.decode(got).numpy(),
                                   np.asarray(jvq.decode(params, want)), rtol=1e-5, atol=1e-6)


def _golden_port() -> tuple[Encodec, np.lib.npyio.NpzFile]:
    g = np.load(GOLDEN)
    model = Encodec(port_config(tiny_config()), device="cpu").eval()
    model.load_state_dict(from_jax_params({k[3:]: g[k] for k in g.files if k.startswith("sd/")},
                                          transposed_groups(model)), strict=True)
    return model, g


def test_ecdc_golden_blob_raw_through_port():
    model, g = _golden_port()
    audio = g["audio"]
    assert model.compress(audio, use_lm=False) == g["blob_raw"].tobytes()
    direct = model.decode(model.encode(audio))[..., : audio.shape[0]].numpy()
    out = model.decompress(g["blob_raw"].tobytes()).numpy()
    assert out.shape == (1, 1, audio.shape[0])
    np.testing.assert_allclose(out, direct, rtol=1e-5, atol=1e-6)


def test_process_audio_16k_to_24k_matches_jax():
    jmodel, port = build_pair(tiny_config(sampling_rate=24000), seed=5)
    audio = _audio(1, 2400, seed=5)[0]
    want = np.asarray(jmodel.process_audio(audio, 16000))
    got = port.process_audio(audio, 16000)
    assert got.shape == want.shape == (3600,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bandwidth_selects_nq():
    port = Encodec(port_config(tiny_config()), device="cpu")
    audio = _audio(1, 1600)[0]
    port.set_target_bandwidth(20.0)
    assert port.encode(audio)[0].codes.shape[1] == 2
    port.set_target_bandwidth(80.0)
    assert port.encode(audio)[0].codes.shape[1] == 4
    with pytest.raises(Exception):
        port.set_target_bandwidth(7.0)


@pytest.mark.parametrize("preset", ["encodec_24khz", "encodec_48khz"])
def test_full_width_state_dict_matches_jax(preset):
    jcfg = getattr(JEncodecConfig, preset)()
    assert port_config(jcfg) == getattr(EncodecConfig, preset)()
    jmodel = JEncodec(jcfg, params={})
    want = jax.eval_shape(lambda: jmodel.init_params(0))
    port = Encodec(getattr(EncodecConfig, preset)(), device="cpu")
    got = from_jax_params({k: np.zeros(v.shape, np.float32) for k, v in want.items()},
                          transposed_groups(port))
    sd = port.state_dict()
    assert sorted(sd) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in sd.items()}
    total = sum(int(np.prod(v.shape)) for v in want.values())
    assert sum(v.numel() for v in sd.values()) == total
    assert port.num_codebooks == jmodel.num_codebooks


def test_overlap_add_and_resample_poly_match_jax(rng):
    from neuralcodecs_tpu.dsp.overlap import linear_overlap_add as jola
    from neuralcodecs_tpu.dsp.resample import resample_poly as jresample

    from neuralcodecs_tpu_torch.dsp.overlap import linear_overlap_add
    from neuralcodecs_tpu_torch.dsp.resample import resample_poly

    frames = [(rng.standard_normal((1, 2, 100))).astype(np.float32) for _ in range(3)]
    frames.append(rng.standard_normal((1, 2, 70)).astype(np.float32))  # a partial tail
    want = np.asarray(jola(frames, stride=60))
    got = linear_overlap_add([torch.from_numpy(f) for f in frames], 60).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    for src, dst in ((16000, 24000), (44100, 24000), (24000, 48000)):
        want = np.asarray(jresample(x, src, dst))
        got = resample_poly(torch.from_numpy(x), src, dst).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [40, 442])
def test_resample_poly_short_clips_match_jax(rng, n):
    """44.1 -> 24 kHz at 40 samples (fewer than one phase's 49 taps) and
    at 3·147 + 1 samples: the edges of the polyphase form's padding."""
    from neuralcodecs_tpu.dsp.resample import resample_poly as jresample

    from neuralcodecs_tpu_torch.dsp.resample import resample_poly

    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jresample(x, 44100, 24000))
    got = resample_poly(torch.from_numpy(x), 44100, 24000).numpy()
    assert got.shape == want.shape == (2, int(n * 80 / 147))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------ HF transformers, independent

def _transformers_pair(seed: int, channels: int, **over):
    """A tiny transformers EncodecModel and the port, from one seeded
    state dict, loaded into the port through its upstream loader."""
    transformers = pytest.importorskip("transformers")
    from test_cross_transformers import ENCODEC_KW, _seeded_torch_sd

    kw = {**ENCODEC_KW, **over}
    tm = transformers.EncodecModel(transformers.EncodecConfig(audio_channels=channels, **kw))
    sd = _seeded_torch_sd(tm, seed)
    tm.load_state_dict(sd)
    port = Encodec(EncodecConfig(channels=channels, **kw), device="cpu")
    port.load_upstream_state_dict({k: v.numpy() for k, v in sd.items()})
    return tm.eval(), port.eval()


@pytest.mark.parametrize("case", ["causal-mono", "stereo-groupnorm-normalized"])
def test_encodec_cross_transformers(case):
    """The two tests/test_cross_transformers.py Encodec checks, on the port:
    codes bit-exact against the independent implementation, scales equal,
    audio within 1e-4, and its codes through the port's decoder."""
    from neuralcodecs_tpu_torch.models.encodec import EncodedFrame

    if case == "causal-mono":
        tm, port = _transformers_pair(7, 1, use_causal_conv=True, norm_type="weight_norm",
                                      normalize=False)
        x, bandwidth = 0.25 * torch.randn(1, 1, 960, generator=torch.Generator()
                                          .manual_seed(99)), 12.0
    else:
        tm, port = _transformers_pair(13, 2, use_causal_conv=False,
                                      norm_type="time_group_norm", normalize=True)
        x, bandwidth = 0.25 * torch.randn(1, 2, 800, generator=torch.Generator()
                                          .manual_seed(5)), 6.0
    normalize = port.config.normalize
    with torch.no_grad():
        enc = tm.encode(x, bandwidth=bandwidth)
        tcodes = enc.audio_codes[0]
        tout = tm.decode(enc.audio_codes, enc.audio_scales).audio_values.numpy()
    port.set_target_bandwidth(bandwidth)
    frames = port.encode(x[0].numpy())
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0].codes.numpy(), tcodes.numpy())
    if normalize:
        np.testing.assert_allclose(frames[0].scale.numpy().ravel(),
                                   enc.audio_scales[0].reshape(-1).numpy(),
                                   rtol=1e-5, atol=1e-6)
    t = x.shape[-1]
    assert np.abs(port.decode(frames)[..., :t].numpy()[0] - tout[0]).max() < 1e-4
    theirs = [EncodedFrame(tcodes, frames[0].scale if normalize else None)]
    assert np.abs(port.decode(theirs)[..., :t].numpy()[0] - tout[0]).max() < 1e-4
