"""``save_pretrained`` / ``load_pretrained`` of the port, and exports
crossing between the port and the JAX package, on the CPU.

A directory the JAX package's ``save_pretrained`` writes (single file and
sharded) loads through the port's ``load_model`` for SNAC, DAC, Encodec and
the narrow Dia of ``make_keysets.dia_narrow_config``: the same audio gives
JAX's codes exactly, and audio within rtol 1e-3 / atol 1e-4 of JAX's
forward (Dia: JAX's greedy codes). A directory the port writes from a
JAX-seeded model loads through JAX's ``load_pretrained`` with the
parameters bit for bit, the same safetensors metadata and an equal
``config.json``. ``to_jax_params`` inverts ``from_jax_params`` on all four
families. Also the port's own export round trips, the model zoo, the
registry and ``Dia.load_dac_model``.

The JAX package's ``save_pretrained`` cannot serialise Dia's nested config
sections (``json.dumps`` without a default); the JAX Dia cases hand its
``json`` a default that writes dataclasses as dicts, as the port does.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax

import neuralcodecs_tpu
import neuralcodecs_tpu.core.export as jax_export
import neuralcodecs_tpu_torch
from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dia import Dia as JDia
from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.ops.conv import torch_conv_transpose_weight_to_hio
from neuralcodecs_tpu_torch.core.exceptions import ConfigurationError, LoadError
from neuralcodecs_tpu_torch.core.export import load_pretrained, save_pretrained
from neuralcodecs_tpu_torch.core.interfaces import NeuralCodec
from neuralcodecs_tpu_torch.core.loader import load_model
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.safetensors_io import load_safetensors, read_safetensors_metadata
from neuralcodecs_tpu_torch.core.weights import from_jax_params, to_jax_params, transposed_groups
from neuralcodecs_tpu_torch.core.zoo import load_zoo_model, zoo_models
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dia import Dia
from neuralcodecs_tpu_torch.models.encodec import Encodec
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from make_keysets import dia_narrow_config
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dac import JDACConfig
from test_torch_dac import tiny_kwargs as dac_tiny_kwargs
from test_torch_dia import port_config as dia_port_config
from test_torch_encodec import port_config as encodec_port_config
from test_torch_loader import assert_same_weights
from test_torch_loader import no_network  # noqa: F401  (autouse: no test reaches a network)
from test_torch_snac import JSNACConfig, jax_roundtrip, port_roundtrip
from test_torch_snac import tiny_kwargs as snac_tiny_kwargs

AUDIO_TOL = dict(rtol=1e-3, atol=1e-4)
DIA_TEXTS = ["[S1]hello there", "[S2]ok"]
DIA_GREEDY = dict(max_tokens=6, seed=3, temperature=0.0)

SNAC_KW = snac_tiny_kwargs(attn_window_size=8, encoder_dim=32, decoder_dim=128, depthwise=True)


def _jax_model(family: str):
    """A seeded JAX model of each family at test size."""
    if family == "snac":
        return JSNAC(JSNACConfig(**SNAC_KW), seed=3)
    if family == "dac":
        return JDAC(JDACConfig(**dac_tiny_kwargs()), seed=3)
    if family == "encodec":
        return JEncodec(encodec_tiny_config(use_causal_conv=False, norm_type="time_group_norm",
                                            channels=2, normalize=True), seed=3)
    return JDia(dia_narrow_config(), seed=3)


def _port_model(family: str, jmodel):
    """The port's model of the same config (seed 0, not JAX's weights)."""
    if family == "snac":
        return SNAC(SNACConfig(**SNAC_KW), device="cpu")
    if family == "dac":
        return DAC(DACConfig(**dac_tiny_kwargs()), device="cpu")
    if family == "encodec":
        return Encodec(encodec_port_config(jmodel.config), device="cpu")
    return Dia(dia_port_config(jmodel.config), device="cpu")


def _np(params) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in params.items()}


def _dump_dataclasses(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    raise TypeError(type(obj))


@pytest.fixture
def jax_json(monkeypatch):
    """The JAX export's json with a default for Dia's nested sections."""
    shim = types.SimpleNamespace(
        dumps=lambda obj, **kw: json.dumps(obj, default=_dump_dataclasses, **kw),
        loads=json.loads)
    monkeypatch.setattr(jax_export, "json", shim)


def _shard_bytes(model_params, sharded: bool) -> int | None:
    """A shard limit that splits the export into about three files."""
    if not sharded:
        return None
    return sum(np.asarray(v).nbytes for v in model_params.values()) // 3 + 1


def _outputs(family: str, model, audio: np.ndarray, jax_side: bool):
    """(codes, audio) of one round trip; Dia: (greedy codes, lengths)."""
    if family == "snac":
        out, codes = (jax_roundtrip if jax_side else port_roundtrip)(model, audio)
        return codes, out
    if family == "dac":
        if jax_side:
            padded, length = model._prepare(audio)
            want = jax.jit(model._forward_fn, static_argnums=2)(model.params, padded, None)
            return [np.asarray(want["codes"])], np.asarray(want["audio"])[:, :length, 0]
        got = model.forward(audio)
        return [got["codes"].numpy()], got["audio"].numpy()
    if family == "encodec":
        codes = model.encode(audio)[0].codes
        out = model.forward(audio)
        return [np.asarray(codes)], np.asarray(out)
    codes, lengths = model.generate_codes(DIA_TEXTS, **DIA_GREEDY)
    return [np.asarray(codes)], np.asarray(lengths)


def _audio(family: str, jmodel) -> np.ndarray:
    rng = np.random.default_rng(7)
    if family == "snac":
        return (0.3 * rng.standard_normal((2, jmodel.config.pad_to * 2 + 11))).astype(np.float32)
    if family == "dac":
        return (0.3 * rng.standard_normal((2, 8 * 10 + 5))).astype(np.float32)
    return (0.3 * rng.standard_normal((2, 2000))).astype(np.float32)


FAMILIES = ["snac", "dac", "encodec", "dia"]


# ------------------------------------------------------ layout conversion


@pytest.mark.parametrize("family", FAMILIES)
def test_to_jax_params_inverts_from_jax_params(family):
    """On a seeded JAX model: equal key sets, the port's state-dict keys,
    and every array back bit for bit."""
    jmodel = _jax_model(family)
    params = _np(jmodel.params)
    port = _port_model(family, jmodel)
    assert sorted(port.state_dict()) == sorted(params)
    groups = transposed_groups(port)
    back = to_jax_params(from_jax_params(params, groups), groups)
    assert sorted(back) == sorted(params)
    for key, value in params.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key].view(np.uint32), value.view(np.uint32),
                                      err_msg=key)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_transposed_conv_layout_matches_jax(groups):
    """A grouped ConvTranspose1d weight goes to the JAX package's HIO layout
    (``torch_conv_transpose_weight_to_hio``) and back."""
    w = np.random.default_rng(groups).standard_normal((8, 3, 5)).astype(np.float32)
    key = "up.weight"
    hio = to_jax_params({key: w}, {key: groups})[key]
    np.testing.assert_array_equal(hio, torch_conv_transpose_weight_to_hio(w, groups))
    np.testing.assert_array_equal(from_jax_params({key: hio}, {key: groups})[key].numpy(), w)


# ------------------------------------------------ exports across the packages


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("family", FAMILIES)
def test_jax_export_loads_into_port(tmp_path, jax_json, family, sharded):
    jmodel = _jax_model(family)
    directory = tmp_path / "jax_export"
    jax_export.save_pretrained(jmodel, directory,
                               max_shard_bytes=_shard_bytes(jmodel.params, sharded))
    assert (directory / "model.safetensors.index.json").is_file() == sharded
    port = load_model(family, str(directory), device="cpu")
    assert port.device.type == "cpu"
    native = port.native_state_dict()
    for key, value in _np(jmodel.params).items():
        np.testing.assert_array_equal(native[key], value, err_msg=key)
    audio = _audio(family, jmodel)
    want_codes, want_out = _outputs(family, jmodel, audio, jax_side=True)
    got_codes, got_out = _outputs(family, port.eval(), audio, jax_side=False)
    for got, want in zip(got_codes, want_codes, strict=True):
        np.testing.assert_array_equal(got, want)
    if family == "dia":
        np.testing.assert_array_equal(got_out, want_out)  # lengths
    else:
        assert got_out.shape == want_out.shape
        np.testing.assert_allclose(got_out, want_out, **AUDIO_TOL)


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("family", FAMILIES)
def test_port_export_loads_into_jax(tmp_path, jax_json, family, sharded):
    jmodel = _jax_model(family)
    port = _port_model(family, jmodel).load_native_state_dict(_np(jmodel.params))
    limit = _shard_bytes(jmodel.params, sharded)
    ours, theirs = tmp_path / "port_export", tmp_path / "jax_export"
    save_pretrained(port, ours, max_shard_bytes=limit)
    jax_export.save_pretrained(jmodel, theirs, max_shard_bytes=limit)
    loaded = jax_export.load_pretrained(ours)
    assert type(loaded).__name__ == type(jmodel).__name__
    assert sorted(loaded.params) == sorted(jmodel.params)
    for key, value in _np(jmodel.params).items():
        np.testing.assert_array_equal(np.asarray(loaded.params[key]), value, err_msg=key)
    files = sorted(p.name for p in ours.iterdir())
    assert files == sorted(p.name for p in theirs.iterdir())
    assert json.loads((ours / "config.json").read_text()) == \
        json.loads((theirs / "config.json").read_text())
    for name in files:
        if name.endswith(".safetensors"):
            assert read_safetensors_metadata(ours / name) == \
                read_safetensors_metadata(theirs / name) == {
                    "format": "neuralcodecs-tpu", "layout": "native",
                    "architecture": family}
            mine, jaxs = load_safetensors(ours / name), load_safetensors(theirs / name)
            assert sorted(mine) == sorted(jaxs)
            for key in mine:
                np.testing.assert_array_equal(mine[key], jaxs[key], err_msg=key)
        elif name.endswith(".index.json"):
            assert json.loads((ours / name).read_text()) == json.loads((theirs / name).read_text())


# ------------------------------------------------------- the port's exports


def _tiny_snac(seed: int) -> SNAC:
    cfg = SNACConfig(sampling_rate=16000, encoder_dim=8, encoder_rates=[2, 4], decoder_dim=32,
                     decoder_rates=[4, 2], attn_window_size=None, codebook_size=32,
                     codebook_dim=4, vq_strides=[2, 1], noise=False, depthwise=False)
    return SNAC(cfg, device="cpu", seed=seed)


def test_save_load_pretrained_roundtrip(tmp_path):
    model = _tiny_snac(3)
    save_pretrained(model, tmp_path / "snac")
    loaded = load_pretrained(tmp_path / "snac", device="cpu")
    assert type(loaded) is SNAC and loaded.config == model.config
    audio = np.random.default_rng(0).standard_normal((1, model.config.pad_to * 2))
    ref, ref_codes = model.forward(audio.astype(np.float32))
    got, got_codes = loaded.forward(audio.astype(np.float32))
    assert torch.equal(ref, got)
    for rc, gc in zip(ref_codes, got_codes, strict=True):
        assert torch.equal(rc, gc)


@pytest.mark.parametrize("entry", ["load_pretrained", "load_model"])
def test_save_pretrained_sharded_roundtrip(tmp_path, entry):
    """A sharded export loads back bit for bit, by load_pretrained and by
    the generic loader (the first shard's marks make it native)."""
    model = _tiny_snac(5)
    out = tmp_path / "sharded"
    save_pretrained(model, out, max_shard_bytes=64 * 1024)
    assert len(list(out.glob("model-*.safetensors"))) > 1
    assert (out / "model.safetensors.index.json").is_file()
    assert not (out / "model.safetensors").exists()
    loaded = (load_pretrained(out, device="cpu") if entry == "load_pretrained"
              else load_model("snac", str(out), device="cpu"))
    assert loaded.config.sampling_rate == 16000
    assert_same_weights(loaded, model)


def test_save_pretrained_removes_stale_layout(tmp_path):
    d = tmp_path / "m"
    save_pretrained(_tiny_snac(1), d, max_shard_bytes=64 * 1024)
    v2 = _tiny_snac(2)
    save_pretrained(v2, d)
    assert not (d / "model.safetensors.index.json").exists()
    assert not list(d.glob("model-*-of-*.safetensors"))
    assert_same_weights(load_pretrained(d, device="cpu"), v2)


@pytest.mark.parametrize("case", ["missing", "unexpected", "shape"])
def test_native_load_is_strict(tmp_path, case):
    """A native export must hold every tensor of the model, no other, at the
    model's shapes: anything else raises LoadError."""
    model = _tiny_snac(1)
    tensors = model.native_state_dict()
    if case == "missing":
        del tensors["decoder.model.0.weight"]
    elif case == "unexpected":
        tensors["decoder.extra"] = np.zeros(2, np.float32)
    else:
        tensors["decoder.model.0.bias"] = np.zeros(3, np.float32)
    with pytest.raises(LoadError, match="decoder"):
        _tiny_snac(2).load_native_state_dict(tensors)


def test_dia_native_export_and_quantized_refusal(tmp_path):
    """Dia's native layouts are its own; a quantized Dia has no export."""
    dia = Dia(dia_port_config(dia_narrow_config()), device="cpu", seed=4)
    save_pretrained(dia, tmp_path / "dia", max_shard_bytes=2 ** 20)
    loaded = load_model("dia", str(tmp_path / "dia"), device="cpu")
    assert_same_weights(loaded, dia)
    with pytest.raises(LoadError, match="lacks"):
        Dia(dia.config, device="cpu").load_native_state_dict(
            {k: v for k, v in dia.native_state_dict().items() if "logits" not in k})
    with pytest.raises(NotImplementedError, match="quantized"):
        save_pretrained(dia.quantize_int8(), tmp_path / "q8")


def test_dia_load_dac_model(tmp_path):
    """The vocoder comes from a save_pretrained directory, on Dia's device."""
    dac = DAC(DACConfig(**dac_tiny_kwargs()), device="cpu", seed=6)
    save_pretrained(dac, tmp_path / "dac")
    dia = Dia(dia_port_config(dia_narrow_config()), device="cpu")
    dia.load_dac_model(str(tmp_path / "dac"))
    assert isinstance(dia.dac, DAC) and dia.dac.device == dia.device
    assert_same_weights(dia.dac, dac)
    assert "dac.decoder.model.0.weight" not in dia.state_dict()
    with pytest.raises(LoadError, match="not found"):
        dia.load_dac_model(str(tmp_path / "absent.safetensors"))


# ------------------------------------------------------ zoo, registry, facade


def test_zoo_registry():
    names = zoo_models()
    assert names == neuralcodecs_tpu.zoo_models()
    assert "snac_24khz" in names and "encodec_48khz" in names and "dia_1.6b" in names
    with pytest.raises(ConfigurationError, match="Unknown zoo model"):
        load_zoo_model("nonexistent_model")


def test_zoo_model_loads_through_the_cache(tmp_path, monkeypatch):
    """A zoo id resolves to its repository and preset: here the cache holds
    the DAC-16k preset's export, so nothing is fetched."""
    monkeypatch.setenv("NEURALCODECS_CACHE", str(tmp_path / "cache"))
    from neuralcodecs_tpu_torch.core.cache import ModelCache

    model = DAC(DACConfig.dac_16khz(), device="cpu", seed=2)
    save_pretrained(model, tmp_path / "export")
    ModelCache().cache_model("descript/dac_16khz", "main", {
        n: tmp_path / "export" / n for n in ("model.safetensors", "config.json")})
    loaded = load_zoo_model("dac_16khz", device="cpu")
    assert loaded.config == DACConfig.dac_16khz()
    assert_same_weights(loaded, model)


@pytest.mark.parametrize("family", FAMILIES)
def test_registry_factories(family):
    """Each model registers at import; its factory takes device= and seed=."""
    entry = registry.get(family.upper())
    assert family in registry and entry.architecture == family
    jmodel = _jax_model(family)
    cfg = _port_model(family, jmodel).config
    a = registry.create(family, cfg, device="cpu", seed=7)
    b = entry.factory(cfg, device="cpu", seed=7)
    assert type(a).__name__.lower() == family and a.device.type == "cpu"
    assert_same_weights(a, b)
    # the codecs are NeuralCodecs; Dia, with no audio round trip, is not
    assert isinstance(a, NeuralCodec) == (family != "dia")


def test_facade_names_match_jax():
    assert sorted(neuralcodecs_tpu_torch.__all__) == sorted(neuralcodecs_tpu.__all__)
    for name in neuralcodecs_tpu_torch.__all__:
        assert getattr(neuralcodecs_tpu_torch, name) is not None
    assert neuralcodecs_tpu_torch.load_snac.__module__ == "neuralcodecs_tpu_torch.core.loader"
