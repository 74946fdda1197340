"""The PyTorch port's DAC against the JAX package's DAC, on the CPU.

Seeded JAX parameters are converted with ``from_jax_params`` and loaded into
the port with ``load_state_dict(strict=True)``; the same numpy audio goes
through both. The JAX side runs ``_forward_fn`` (the unchunked round trip).
RVQ codes must match bit-exactly; audio, ``z`` and ``latents`` within rtol
1e-4 / atol 1e-5 (the two frameworks sum the convolutions in different
orders), the loss values within 1e-5; the frozen golden within its own bar
(rtol 1e-3 / atol 1e-4, SNR > 55 dB); ``.dac`` bytes exactly.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu_torch.core.weights import (
    fold_weight_norm,
    from_jax_params,
    transposed_groups,
)
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dac import dacfile

HERE = Path(__file__).resolve().parent
GOLDEN = HERE / "goldens" / "dac_golden.npz"
KEYSET = HERE / "keysets" / "dac_44khz.json"
TOL = dict(rtol=1e-4, atol=1e-5)


def tiny_kwargs(**over) -> dict:
    """tests/test_dac.py's tiny_config: the 44k structure at small widths."""
    base = dict(sample_rate=16000, encoder_dim=16, encoder_rates=[2, 4], decoder_dim=64,
                decoder_rates=[4, 2], n_codebooks=3, codebook_size=32, codebook_dim=4)
    base.update(over)
    return base


def build_pair(kwargs: dict, seed: int = 0) -> tuple[JDAC, DAC]:
    """A seeded JAX DAC and the port loaded with the same weights."""
    jmodel = JDAC(JDACConfig(**kwargs), seed=seed)
    port = DAC(DACConfig(**kwargs), device="cpu")
    sd = from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                         transposed_groups(port))
    port.load_state_dict(sd, strict=True)
    return jmodel, port.eval()


def _audio(shape, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-20)))


CASES = {
    # (config overrides, samples, n_quantizers)
    "44k-structure": ({}, 8 * 10 + 5, None),
    # stride 5 without output_padding: the decoder returns 78 samples for
    # the padded 80, fewer than the 79 of the input
    "odd-stride-24k": ({"sample_rate": 24000, "encoder_rates": [2, 5],
                        "decoder_rates": [5, 2]}, 79, None),
    "n-quantizers-subset": ({}, 8 * 10 + 5, 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_dac_matches_jax(name):
    over, n, n_q = CASES[name]
    jmodel, port = build_pair(tiny_kwargs(**over))
    audio = _audio((2, n))
    padded, length = jmodel._prepare(audio)
    want = jax.jit(jmodel._forward_fn, static_argnums=2)(jmodel.params, padded, n_q)
    got = port.forward(audio, n_q)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert got["codes"].shape[1] == (n_q or 3)
    want_audio = np.asarray(want["audio"])[:, :length, 0]
    assert tuple(got["audio"].shape) == want_audio.shape
    np.testing.assert_allclose(got["audio"].numpy(), want_audio, **TOL)
    for key in ("z", "latents"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    for key in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_odd_stride_output_is_shorter_than_the_input():
    _, port = build_pair(tiny_kwargs(**CASES["odd-stride-24k"][0]))
    assert tuple(port.forward(_audio(79))["audio"].shape) == (1, 78)


def test_encode_decode_from_codes_from_latents_match_jax():
    jmodel, port = build_pair(tiny_kwargs())
    audio = _audio(8 * 12)
    z_q, codes, latents, commit, cb = port.encode(audio)
    padded, _ = jmodel._prepare(audio)
    jz, jcodes, jlatents, jcommit, jcb = jax.jit(jmodel._encode_fn, static_argnums=2)(
        jmodel.params, padded, None)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(z_q.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(latents.numpy(), np.asarray(jlatents), **TOL)
    np.testing.assert_allclose([float(commit), float(cb)], [float(jcommit), float(jcb)],
                               rtol=1e-5, atol=1e-5)

    decoded = port.decode(z_q.numpy())
    want = jax.jit(jmodel._decode_fn)(jmodel.params, jz)[:, :, 0]
    np.testing.assert_allclose(decoded.numpy(), np.asarray(want), **TOL)

    from_codes = port.from_codes(codes.numpy())
    jfrom = jax.jit(jmodel._decode_fn)(
        jmodel.params, jax.jit(jmodel._from_codes_fn)(jmodel.params, jcodes))[:, :, 0]
    np.testing.assert_allclose(from_codes.numpy(), np.asarray(jfrom), **TOL)
    assert tuple(from_codes.shape) == (1, audio.shape[0])

    from_latents = port.from_latents(latents.numpy())
    jz_lat, jcodes_lat = jax.jit(jmodel._from_latents_fn)(jmodel.params, jlatents)
    np.testing.assert_array_equal(np.asarray(jcodes_lat), np.asarray(jcodes))
    want_lat = jax.jit(jmodel._decode_fn)(jmodel.params, jz_lat)[:, :, 0]
    np.testing.assert_allclose(from_latents.numpy(), np.asarray(want_lat), **TOL)


def test_process_audio_48k_matches_jax():
    jmodel, port = build_pair(tiny_kwargs())
    audio = _audio(4800, seed=3)
    got = port.process_audio(audio, sample_rate=48000)
    want = np.asarray(jmodel.process_audio(audio, sample_rate=48000))
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (1600,)
    np.testing.assert_allclose(got, want, **TOL)


def test_dac_golden_through_port():
    from make_goldens import dac_golden_config

    g = np.load(GOLDEN)
    cfg = dac_golden_config()
    cfg = DACConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(DACConfig)})
    model = DAC(cfg, device="cpu")
    model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                           if k.startswith("sd/")}, strict=True)
    out = model.forward(g["audio"])
    assert tuple(out["codes"].shape) == (1, 9, 25)
    np.testing.assert_array_equal(out["codes"].numpy(), g["codes"].astype(np.int32))
    ref = g["decoded"][: g["audio"].shape[0]]
    got = out["audio"][0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    assert _snr_db(ref, got) > 55.0


@pytest.fixture(scope="module")
def dac_44khz_port():
    return DAC(DACConfig.dac_44khz(), device="cpu")


def test_state_dict_names_match_jax_params(dac_44khz_port):
    jmodel = JDAC(JDACConfig.dac_44khz(), params={})
    want = jax.eval_shape(lambda: jmodel.init_params(0))
    sd = dac_44khz_port.state_dict()
    assert sorted(sd) == sorted(want)
    assert len(sd) == 223
    got = from_jax_params({k: np.zeros(v.shape, np.float32) for k, v in want.items()},
                          transposed_groups(dac_44khz_port))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in sd.items()}
    total = sum(p.numel() for p in dac_44khz_port.parameters())
    assert total == sum(int(np.prod(v.shape)) for v in want.values())
    assert 76_000_000 < total < 77_000_000


def test_descript_keyset_loads_strict(dac_44khz_port):
    keys = json.loads(KEYSET.read_text())["keys"]
    assert len(keys) == 301
    with np.errstate(invalid="ignore"):  # zero weight_v: the folded norm is 0/0
        sd = fold_weight_norm({k: np.zeros(shape, np.float32) for k, shape in keys.items()})
    dac_44khz_port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


def test_dac_file_bytes_match_jax(tmp_path):
    from neuralcodecs_tpu.models.dac.dacfile import dac_file_bytes as jdac_file_bytes

    codes = np.random.default_rng(1).integers(0, 1024, (1, 9, 25)).astype(np.int32)
    for preset in ("dac_44khz", "dac_24khz"):
        want = jdac_file_bytes([codes], getattr(JDACConfig, preset)())
        got = dacfile.dac_file_bytes([codes], getattr(DACConfig, preset)())
        assert got == want
        back, cfg = dacfile.parse_dac_file(got)
        np.testing.assert_array_equal(back[0], codes)
        assert cfg == getattr(DACConfig, preset)()
    for cut in (3, 10, len(got) - 1):
        with pytest.raises(ValueError):
            dacfile.parse_dac_file(got[:cut])


def test_encode_to_file_round_trip(tmp_path):
    jmodel, port = build_pair(tiny_kwargs())
    audio = _audio(8 * 9, seed=2)
    path = tmp_path / "x.dac"
    port.encode_to_file(audio, path)
    jpath = tmp_path / "j.dac"
    jmodel.encode_to_file(audio, jpath)
    assert path.read_bytes() == jpath.read_bytes()
    codes = port.encode(audio)[1]
    torch.testing.assert_close(port.decode_from_file(path), port.from_codes(codes),
                               rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["dac_44khz", "dac_44khz_16kbps", "dac_24khz", "dac_16khz"])
def test_presets_match_jax(preset):
    port, ref = getattr(DACConfig, preset)(), getattr(JDACConfig, preset)()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.hop_length, port.resolved_latent_dim) == (ref.hop_length,
                                                           ref.resolved_latent_dim)
    assert port.to_dict() == ref.to_dict()
    assert DACConfig.from_dict(ref.to_dict()) == port


def test_config_json_round_trip(tmp_path):
    cfg = DACConfig.dac_24khz().replace(n_codebooks=7)
    cfg.to_json(tmp_path / "c.json")
    assert DACConfig.from_json(tmp_path / "c.json") == cfg
    assert JDACConfig.from_json(tmp_path / "c.json").to_dict() == cfg.to_dict()


def test_dac_cross_transformers():
    """tests/test_cross_transformers.py's DAC check on the port: codes
    bit-exact against the independent transformers DacModel, and its
    decode within the same self-calibrated envelope."""
    pytest.importorskip("transformers")
    from transformers.models.dac import DacConfig, DacModel

    from test_cross_transformers import _dac_rename, _seeded_torch_sd

    rates = [2, 4]
    tm = DacModel(DacConfig(encoder_hidden_size=8, downsampling_ratios=rates,
                            decoder_hidden_size=8, upsampling_ratios=rates[::-1],
                            n_codebooks=3, codebook_size=64, codebook_dim=4,
                            sampling_rate=1000)).eval()
    sd = _seeded_torch_sd(tm, seed=11)
    tm.load_state_dict(sd)
    tm.eval()
    port = DAC(DACConfig(sample_rate=1000, encoder_dim=8, encoder_rates=rates, decoder_dim=8,
                         decoder_rates=rates[::-1], n_codebooks=3, codebook_size=64,
                         codebook_dim=4), device="cpu")
    n = len(rates)
    folded = fold_weight_norm({_dac_rename(k, n, n): v.numpy() for k, v in sd.items()})
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in folded.items()},
                         strict=True)

    hop = int(np.prod(rates))
    g = torch.Generator().manual_seed(3)
    x = 0.25 * torch.randn(1, 1, 50 * hop, generator=g)
    with torch.no_grad():
        enc = tm.encode(x)
        tcodes = enc.audio_codes.numpy()
        tq = enc.quantized_representation
        tout = tm.decode(tq).audio_values.numpy().reshape(-1)
        jit = tq + 1e-4 * torch.randn(tq.shape, generator=g)
        envelope = float(np.abs(tm.decode(jit).audio_values.numpy().reshape(-1) - tout).max())

    codes = port.encode(x[0, 0].numpy())[1].numpy()
    assert codes.shape == tcodes.shape
    np.testing.assert_array_equal(codes, tcodes)
    t = x.shape[-1]
    out = port.from_codes(codes)[0, :t].numpy()
    diff = np.abs(out - tout[:t])
    assert float(diff.max()) < max(10.0 * envelope, 1e-4), (float(diff.max()), envelope)
    assert _snr_db(tout[:t], out) > 40.0


# ------------------------------------------------------ device repairs


def _model(name: str, **kw):
    """A tiny SNAC, Encodec or DAC (the configs of their CPU tests)."""
    from neuralcodecs_tpu_torch.models.encodec import Encodec
    from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

    from test_encodec import tiny_config as encodec_config
    from test_torch_encodec import port_config
    from test_torch_snac import tiny_kwargs as snac_kwargs

    if name == "snac":
        return SNAC(SNACConfig(**snac_kwargs()), **kw)
    if name == "encodec":
        return Encodec(port_config(encodec_config()), **kw)
    return DAC(DACConfig(**tiny_kwargs()), **kw)


@pytest.mark.parametrize("name", ["snac", "encodec", "dac"])
def test_constructor_defaults_to_cuda(name):
    """With no device the model goes to "cuda"; without a card that raises
    rather than landing on the CPU."""
    if torch.cuda.is_available():
        assert _model(name).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _model(name)
    assert _model(name, device="cpu").device.type == "cpu"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name,resampler", [("snac", "linear_resample"),
                                            ("encodec", "resample_poly"),
                                            ("dac", "resample_poly")])
def test_process_audio_resamples_on_the_model_device(monkeypatch, name, resampler):
    """The resampler gets the audio on the model's device (meta here, which
    no CPU default could pass for)."""
    module = {"snac": "neuralcodecs_tpu_torch.models.snac.model",
              "encodec": "neuralcodecs_tpu_torch.models.encodec.model",
              "dac": "neuralcodecs_tpu_torch.models.dac.model"}[name]
    seen = []

    def record(audio, src, dst):
        seen.append(audio.device)
        raise _Stop

    monkeypatch.setattr(f"{module}.{resampler}", record)
    model = _model(name, device="meta")
    with pytest.raises(_Stop):
        model.process_audio(np.zeros(480, np.float32), 12345)
    assert seen == [torch.device("meta")]


def test_audio_signal_default_device(tmp_path):
    """An array or a WAV file with no device goes to "cuda" (raising without
    a card); a tensor keeps its device."""
    from neuralcodecs_tpu_torch.dsp import AudioSignal

    x = _audio((1, 800))
    assert AudioSignal(torch.from_numpy(x), 8000).audio_data.device.type == "cpu"
    path = tmp_path / "x.wav"
    AudioSignal(x, 8000, device="cpu").write(path)
    if torch.cuda.is_available():
        assert AudioSignal(x, 8000).audio_data.device.type == "cuda"
        assert AudioSignal.load(path).audio_data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AudioSignal(x, 8000)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AudioSignal.load(path)
    assert AudioSignal.load(path, device="cpu").audio_data.device.type == "cpu"
