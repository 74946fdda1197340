"""The port's loader, cache and repositories, on the CPU (no network).

Port counterparts of tests/test_loader.py, with remote repositories stubbed
the same way (monkeypatched ``_http_get`` / ``_download_file`` /
``_http_post_json``); on top of those, every remote fetch a test does not
stub fails (``no_network``), and the cache lives under the test's own
directory. Also here: the upstream key sets of tests/keysets/ pinned
through ``load_model`` on .pth and .safetensors files with their
weight-norm pairs folded, a cache the JAX package's ``ModelCache`` wrote
read as a hit by the port's, the pretrained Encodec LM through a stubbed
download against the JAX LM loaded from the same file (pdfs within rtol
1e-5 / atol 1e-7), and the validation gate.
"""

import email.message
import hashlib
import json
import shutil
import urllib.error
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.core.cache import ModelCache as JModelCache
from neuralcodecs_tpu.core.importer import import_checkpoint as jax_import_checkpoint
from neuralcodecs_tpu.models.encodec.lm import EncodecLanguageModel as JLM
from neuralcodecs_tpu.models.encodec.lm import EncodecLMConfig as JLMConfig
from neuralcodecs_tpu_torch.core import repos as repos_mod
from neuralcodecs_tpu_torch.core.cache import ModelCache
from neuralcodecs_tpu_torch.core.events import EventEmitter, LoadProgress
from neuralcodecs_tpu_torch.core.exceptions import (
    ConfigurationError,
    LoadError,
    RepositoryError,
    ValidationError,
)
from neuralcodecs_tpu_torch.core.export import save_pretrained
from neuralcodecs_tpu_torch.core.files import (
    ModelFileType,
    detect_file_type,
    detect_file_type_from_contents,
    wildcard_match,
)
from neuralcodecs_tpu_torch.core.loader import (
    LoadOptions,
    ModelLoader,
    load_encodec,
    load_model,
    load_snac,
)
from neuralcodecs_tpu_torch.core.repos import (
    GitHubRepository,
    is_lfs_pointer,
    parse_lfs_pointer,
    pick_config_file,
    pick_model_file,
    repository_for_source,
)
from neuralcodecs_tpu_torch.core.safetensors_io import save_safetensors
from neuralcodecs_tpu_torch.core.validation import validate_config, validate_model
from neuralcodecs_tpu_torch.core.weights import fold_weight_norm
from neuralcodecs_tpu_torch.models.dia import Dia
from neuralcodecs_tpu_torch.models.encodec import Encodec, EncodecConfig
from neuralcodecs_tpu_torch.models.encodec.lm import EncodecLanguageModel
from neuralcodecs_tpu_torch.models.encodec.model import normalize_source_names
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from make_keysets import dia_narrow_config
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dia import port_config as dia_port_config
from test_torch_encodec import port_config as encodec_port_config

KEYSET_DIR = Path(__file__).resolve().parent / "keysets"
PDF_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def no_network(monkeypatch, tmp_path):
    """Every remote fetch fails unless the test stubs it, and the default
    cache root is the test's own directory."""
    def refuse(*args, **kwargs):
        raise urllib.error.URLError("no network in the tests")

    for name in ("_http_get", "_http_post_json", "_download_file"):
        monkeypatch.setattr(repos_mod, name, refuse)
    monkeypatch.setenv("NEURALCODECS_CACHE", str(tmp_path / "default_cache"))


def tiny_snac_config(**over) -> SNACConfig:
    """tests/test_loader.py's tiny SNAC."""
    base = dict(sampling_rate=16000, encoder_dim=16, encoder_rates=[2, 3], decoder_dim=64,
                decoder_rates=[3, 2], attn_window_size=None, codebook_size=32,
                codebook_dim=8, vq_strides=[1], noise=False, depthwise=False)
    base.update(over)
    return SNACConfig(**base)


def _export_tiny_snac(directory: Path, seed: int = 0) -> SNAC:
    model = SNAC(tiny_snac_config(), device="cpu", seed=seed)
    save_pretrained(model, directory)
    return model


def assert_same_weights(a, b) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


# ------------------------------------------------- tests/test_loader.py cases


def test_detect_file_types(tmp_path):
    (tmp_path / "a.safetensors").write_bytes(b"\x08" + b"\x00" * 7 + b"{}")
    assert detect_file_type(tmp_path / "a.safetensors") == ModelFileType.SAFETENSORS
    (tmp_path / "b.pt").write_bytes(b"\x80\x02")
    assert detect_file_type(tmp_path / "b.pt") == ModelFileType.PYTORCH
    (tmp_path / "noext").write_bytes(b"PK\x03\x04" + b"\x00" * 16)
    assert detect_file_type_from_contents(tmp_path / "noext") == ModelFileType.PYTORCH
    assert wildcard_match("*.SafeTensors", "model.safetensors")


def test_pick_files_and_lfs(tmp_path):
    files = ["README.md", "nested/model.pt", "model.safetensors", "config.json"]
    assert pick_model_file(files) == "model.safetensors"
    assert pick_config_file(files) == "config.json"
    p = tmp_path / "weights.safetensors"
    p.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid sha256:abc\n")
    assert is_lfs_pointer(p)


def test_repository_dispatch():
    assert type(repository_for_source("owner/repo")).__name__ == "HuggingFaceRepository"
    assert type(repository_for_source("https://github.com/o/r")).__name__ == "GitHubRepository"
    assert type(repository_for_source("https://dl.example.com/m.pt")).__name__ == \
        "DirectUrlRepository"


def test_cache_roundtrip_and_invalidation(tmp_path):
    cache = ModelCache(tmp_path / "cache")
    src = tmp_path / "m.bin"
    src.write_bytes(b"weights" * 100)
    d = cache.cache_model("owner/repo", "main", {"m.bin": src})
    assert cache.get_cached_path("owner/repo", "main") == d
    (d / "m.bin").write_bytes(b"short")
    assert cache.get_cached_path("owner/repo", "main") is None


def test_loader_local_checkpoint_with_config(tmp_path):
    """Config discovery and the registry on a save_pretrained directory."""
    model = _export_tiny_snac(tmp_path / "exported")
    loader = ModelLoader()
    weights = loader.resolve(str(tmp_path / "exported"), LoadOptions())
    assert weights.name == "model.safetensors"
    config_path = loader.find_config(weights)
    assert config_path is not None
    assert json.loads(config_path.read_text())["sampling_rate"] == 16000
    loaded = loader.load("snac", str(tmp_path / "exported"), device="cpu")
    assert loaded.config.encoder_rates == [2, 3] and loaded.device.type == "cpu"
    assert_same_weights(loaded, model)


def test_loader_stub_remote_repository(tmp_path, monkeypatch):
    """Remote path end to end with a stub repository: downloaded into the
    cache, then served from it."""
    import neuralcodecs_tpu_torch.core.loader as loader_mod

    origin = tmp_path / "origin"
    model = _export_tiny_snac(origin, seed=4)
    downloads = []

    class StubRepo:
        def download_model(self, source, revision, dest, events=None):
            downloads.append(source)
            out = {}
            for name in ("model.safetensors", "config.json"):
                dest.mkdir(parents=True, exist_ok=True)
                shutil.copy2(origin / name, dest / name)
                out[name] = dest / name
            return out

    monkeypatch.setattr(loader_mod, "repository_for_source", lambda s: StubRepo())
    loader = ModelLoader(ModelCache(tmp_path / "cache"))
    loaded = loader.load("snac", "stub-owner/stub-model", device="cpu")
    assert loaded.config.encoder_rates == [2, 3]
    assert_same_weights(loaded, model)
    assert loader.cache.get_cached_path("stub-owner/stub-model", "main") is not None
    again = loader.load("snac", "stub-owner/stub-model", device="cpu")
    assert again.config.sampling_rate == 16000
    assert downloads == ["stub-owner/stub-model"]  # the second load is a cache hit


def test_progress_events():
    emitter = EventEmitter()
    seen = []
    emitter.on_progress(seen.append)
    emitter.emit_progress(LoadProgress("src", "download", 0.5))
    assert seen and seen[0].stage == "download"


def test_resolve_prefers_safetensors_in_directory(tmp_path):
    (tmp_path / "aaa.pt").write_bytes(b"PK\x03\x04" + b"0" * 100)
    header = json.dumps({"__metadata__": {}}).encode()
    (tmp_path / "zzz.safetensors").write_bytes(len(header).to_bytes(8, "little") + header)
    got = ModelLoader().resolve(str(tmp_path), LoadOptions())
    assert got.name == "zzz.safetensors"


def test_github_release_asset_fallback(tmp_path, monkeypatch):
    """No weights in the repository tree: the release's assets are fetched."""
    calls = []

    def fake_http_get(url, headers=None):
        calls.append(url)
        if "/contents" in url:
            return json.dumps([{"path": "README.md", "type": "file"}]).encode()
        if "/releases/" in url:
            return json.dumps({"assets": [
                {"name": "weights.pt", "browser_download_url": "https://example.com/weights.pt"},
                {"name": "config.json",
                 "browser_download_url": "https://example.com/config.json"},
            ]}).encode()
        raise AssertionError(url)

    def fake_download(url, dest, events=None, source=""):
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(b"PK\x03\x04" + b"0" * 64)
        return dest

    monkeypatch.setattr(repos_mod, "_http_get", fake_http_get)
    monkeypatch.setattr(repos_mod, "_download_file", fake_download)
    out = GitHubRepository().download_model("https://github.com/owner/repo", "v1.0", tmp_path)
    assert "weights.pt" in out and "config.json" in out
    assert any("/releases/tags/v1.0" in c for c in calls)


def _lfs_pointer_bytes(payload: bytes) -> bytes:
    oid = hashlib.sha256(payload).hexdigest()
    return (f"version https://git-lfs.github.com/spec/v1\n"
            f"oid sha256:{oid}\nsize {len(payload)}\n").encode()


def test_github_lfs_pointer_resolution(tmp_path, monkeypatch):
    """A raw download that lands an LFS pointer resolves through the git-lfs
    batch API into the media object, checked against the pointer's oid."""
    media = b"PK\x03\x04" + b"weights-bytes" * 10
    pointer = _lfs_pointer_bytes(media)
    batch_calls = []

    def fake_http_get(url, headers=None):
        if "/contents" in url:
            return json.dumps([{"path": "model.pt", "type": "file"}]).encode()
        raise AssertionError(url)

    def fake_download(url, dest, events=None, source=""):
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(media if "lfs-media" in url else pointer)
        return dest

    def fake_post_json(url, payload, headers=None):
        batch_calls.append((url, payload))
        assert url == "https://github.com/owner/repo.git/info/lfs/objects/batch"
        obj = payload["objects"][0]
        return {"objects": [{"oid": obj["oid"], "size": obj["size"],
                             "actions": {"download": {"href": "https://example.com/lfs-media"}}}]}

    monkeypatch.setattr(repos_mod, "_http_get", fake_http_get)
    monkeypatch.setattr(repos_mod, "_download_file", fake_download)
    monkeypatch.setattr(repos_mod, "_http_post_json", fake_post_json)
    out = GitHubRepository().download_model("https://github.com/owner/repo", "main", tmp_path)
    assert out["model.pt"].read_bytes() == media
    assert len(batch_calls) == 1


@pytest.mark.parametrize("case", ["tampered-media", "non-https-href"])
def test_github_lfs_media_refused(tmp_path, monkeypatch, case):
    """Media whose sha256 is not the pointer's oid is rejected and removed;
    a batch response pointing the href at file:// is rejected before any
    fetch."""
    media = b"real-weights" * 8
    pointer = _lfs_pointer_bytes(media)
    media_downloads = []
    href = "https://example.com/lfs-media" if case == "tampered-media" else \
        "file:///etc/lfs-media"

    def fake_download(url, dest, events=None, source=""):
        dest.parent.mkdir(parents=True, exist_ok=True)
        if "lfs-media" in url:
            media_downloads.append(url)
            dest.write_bytes(b"TAMPERED" + media)
        else:
            dest.write_bytes(pointer)
        return dest

    monkeypatch.setattr(repos_mod, "_download_file", fake_download)
    monkeypatch.setattr(repos_mod, "_http_post_json", lambda url, payload, headers=None: {
        "objects": [{"actions": {"download": {"href": href}}}]})
    match = "verification" if case == "tampered-media" else "not https"
    with pytest.raises(RepositoryError, match=match):
        GitHubRepository().download_model(
            "https://github.com/owner/repo/raw/main/model.pt", "main", tmp_path)
    assert not (tmp_path / "model.pt").exists() or case == "non-https-href"
    if case == "non-https-href":
        assert media_downloads == []


def test_parse_lfs_pointer_rejects_malformed(tmp_path):
    p = tmp_path / "bad.pt"
    p.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:xyz\n")
    with pytest.raises(RepositoryError, match="Malformed"):
        parse_lfs_pointer(p)
    p.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:" + "a" * 64 + "\n")
    with pytest.raises(RepositoryError, match="Malformed"):
        parse_lfs_pointer(p)


def test_github_rate_limit_error(monkeypatch):
    headers = email.message.Message()
    headers["x-ratelimit-remaining"] = "0"
    headers["x-ratelimit-reset"] = "12345"

    def fake_http_get(url, h=None):
        raise urllib.error.HTTPError(url, 403, "rate limited", headers, None)

    monkeypatch.setattr(repos_mod, "_http_get", fake_http_get)
    with pytest.raises(RepositoryError, match="rate limit"):
        GitHubRepository().get_model_info("https://github.com/owner/repo")


# ------------------------------------------------------------ the port's own


def test_remote_failure_raises_and_emits_error_event(tmp_path):
    """With the network refused, a remote source raises and the error event
    fires; try_load returns the failure instead."""
    loader = ModelLoader(ModelCache(tmp_path / "cache"))
    errors = []
    loader.on_error(errors.append)
    with pytest.raises(RepositoryError, match="HF Hub query failed"):
        loader.load("snac", "owner/missing-model", device="cpu")
    assert len(errors) == 1 and errors[0].fatal and errors[0].source == "owner/missing-model"
    result = loader.try_load("snac", "owner/missing-model", device="cpu")
    assert not result.success and result.result is None and result.message
    missing = tmp_path / "absent.safetensors"
    with pytest.raises(LoadError, match="not found"):
        load_snac(str(missing), device="cpu")
    with pytest.raises(ConfigurationError, match="No model registered"):
        load_model("no-such-family", str(tmp_path), device="cpu")


def test_try_load_success_and_progress(tmp_path):
    model = _export_tiny_snac(tmp_path / "m")
    loader = ModelLoader()
    stages = []
    loader.on_progress(lambda e: stages.append((e.stage, e.fraction)))
    result = loader.try_load("snac", str(tmp_path / "m"), device="cpu")
    assert result.success and result.error is None
    assert_same_weights(result.result, model)
    assert stages == [("weights", 0.0), ("weights", 1.0)]


def test_factory_kwargs_reach_the_model(tmp_path):
    """device= and seed= go to the factory; with no config.json the given
    config (a dict too) is used."""
    model = SNAC(tiny_snac_config(), device="cpu", seed=2)
    path = tmp_path / "weights.pth"
    torch.save({"state_dict": model.state_dict()}, path)
    cfg = tiny_snac_config().to_dict()
    loaded = load_snac(str(path), config=cfg, device="cpu", seed=9)
    assert loaded.device.type == "cpu"
    assert_same_weights(loaded, model)


def test_upstream_file_missing_tensor_raises(tmp_path):
    """A key the model needs and the checkpoint lacks raises LoadError; a key
    it has no slot for is dropped."""
    model = SNAC(tiny_snac_config(), device="cpu", seed=2)
    sd = dict(model.state_dict())
    sd["decoder.extra.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "extra.pth")
    assert_same_weights(load_snac(str(tmp_path / "extra.pth"), config=tiny_snac_config(),
                                   device="cpu"), model)
    del sd["quantizer.quantizers.0.codebook.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(LoadError, match="quantizer.quantizers.0.codebook.weight"):
        load_snac(str(tmp_path / "short.pth"), config=tiny_snac_config(), device="cpu")


def test_validate_option(tmp_path, monkeypatch):
    """LoadOptions(validate=True) runs validate_model on the loaded model;
    a round trip gone non-finite fails the load."""
    _export_tiny_snac(tmp_path / "m")
    model = load_snac(str(tmp_path / "m"), options=LoadOptions(validate=True), device="cpu")
    validate_model(model)
    validate_config(model.config)
    with pytest.raises(ValidationError, match="sample rate"):
        validate_config(tiny_snac_config(sampling_rate=100))
    monkeypatch.setattr(SNAC, "process_audio",
                        lambda self, audio, sr: np.full_like(audio, np.nan))
    with pytest.raises(ValidationError, match="non-finite"):
        load_snac(str(tmp_path / "m"), options=LoadOptions(validate=True), device="cpu")


def test_jax_cache_is_a_hit_for_the_port(tmp_path, monkeypatch):
    """With NEURALCODECS_CACHE set, a file the JAX package's cache stored is
    found by the port's loader, with no download."""
    monkeypatch.setenv("NEURALCODECS_CACHE", str(tmp_path / "shared"))
    origin = tmp_path / "origin"
    model = _export_tiny_snac(origin, seed=6)
    jcache = JModelCache()
    assert jcache.root == tmp_path / "shared"
    jcache.cache_model("owner/shared-snac", "main",
                       {n: origin / n for n in ("model.safetensors", "config.json")})
    cache = ModelCache()
    assert cache.root == jcache.root
    assert cache.get_cached_path("owner/shared-snac", "main") == \
        jcache.dir_for("owner/shared-snac", "main")
    assert_same_weights(load_snac("owner/shared-snac", device="cpu"), model)
    monkeypatch.delenv("NEURALCODECS_CACHE")
    assert ModelCache().root == Path.home() / ".cache" / "neural_codecs" / "torch"


# ---------------------------------------------------- upstream key sets


def _synthetic_sd(keys: dict, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in keys.items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.05
        if key.endswith(("original0", "weight_g", ".alpha", ".inited")):
            a = np.abs(a) + 0.5  # norms and scales are positive
        sd[key] = a
    return sd


def _keyset_case(name: str):
    """(architecture, port config, checkpoint dict, the folded dict the model
    must hold afterwards under its own names)."""
    if name == "dia":
        cfg = dia_port_config(dia_narrow_config())
        keys = json.loads((KEYSET_DIR / "dia.json").read_text())["keys"]
        own = Dia(cfg, device="cpu", seed=1).state_dict()
        assert sorted(own) == keys
        sd = {f"model.{k}": v.numpy() for k, v in own.items()}
        return "dia", cfg, sd, {k: v.numpy() for k, v in own.items()}
    fixture = json.loads((KEYSET_DIR / f"{name}.json").read_text())
    sd = _synthetic_sd(fixture["keys"])
    sd.update(_synthetic_sd(fixture["ignored"], seed=1))
    want = {k: v for k, v in fold_weight_norm(sd).items() if k not in fixture["ignored"]}
    if name.startswith("snac"):
        return "snac", getattr(SNACConfig, name)(), sd, want
    return "encodec", getattr(EncodecConfig, name)(), sd, normalize_source_names(want)


KEYSETS = ["snac_24khz", "snac_44khz", "encodec_24khz", "encodec_48khz", "dia"]


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
@pytest.mark.parametrize("name", KEYSETS)
def test_upstream_keyset_loads_through_load_model(tmp_path, name, fmt):
    """A checkpoint with exactly the published key set (weight-norm g / v
    pairs, SNAC-44k's rel_pos.inv_freq buffers, Dia's ``model.`` prefix)
    loads through load_model; every tensor the model holds is the folded
    checkpoint's."""
    arch, cfg, sd, want = _keyset_case(name)
    path = tmp_path / f"checkpoint.{fmt}"
    if fmt == "pth":
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    else:
        save_safetensors(path, sd)
    model = load_model(arch, str(path), config=cfg, device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


# ------------------------------------------------ the pretrained Encodec LM


def _lm_encodec() -> Encodec:
    return Encodec(encodec_port_config(encodec_tiny_config(
        sampling_rate=24000, upsampling_ratios=[8, 5, 4, 2])), device="cpu").eval()


def test_get_language_model_from_stubbed_download(tmp_path, monkeypatch):
    """The LM URL resolves through the loader's cache: a stubbed download
    the first time, the cache after. Its pdfs are the JAX LM's loaded from
    the same .th within rtol 1e-5 / atol 1e-7, and not the seeded LM's."""
    model = _lm_encodec()
    url = model._LM_CHECKPOINTS[24000]
    cfg = model.get_language_model(download=False).config
    source = EncodecLanguageModel(cfg, device="cpu", seed=5)
    th = tmp_path / "upstream.th"
    torch.save(source.state_dict(), th)
    fetched = []

    def fake_download(url_, dest, events=None, source=""):
        fetched.append(url_)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(th, dest)
        return dest

    monkeypatch.setattr(repos_mod, "_download_file", fake_download)
    lm = _lm_encodec().get_language_model()
    again = _lm_encodec().get_language_model()
    assert fetched == [url]
    assert lm.device == model.device
    jlm = JLM(JLMConfig.from_dict(cfg.to_dict()))
    jlm.load_state_dict(jax_import_checkpoint(th))
    codes = np.random.default_rng(0).integers(0, cfg.codebook_size + 1,
                                              size=(2, cfg.num_codebooks, 12))
    got = lm.forward_full(codes).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm.forward_full(jnp.asarray(codes))), **PDF_TOL)
    np.testing.assert_array_equal(again.forward_full(codes).numpy(), got)
    seeded = model.get_language_model(download=False).forward_full(codes).numpy()
    assert np.abs(got - seeded).max() > 1e-3


@pytest.mark.parametrize("case", ["no-network", "wrong-keys"])
def test_get_language_model_failure_raises(tmp_path, monkeypatch, case):
    """No network, or a file that is not the LM: LoadError, and no LM is
    set (no fallback to the untrained one)."""
    if case == "wrong-keys":
        th = tmp_path / "other.th"
        torch.save({"not_the_lm.weight": torch.zeros(3, 3)}, th)

        def fake_download(url_, dest, events=None, source=""):
            dest.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(th, dest)
            return dest

        monkeypatch.setattr(repos_mod, "_download_file", fake_download)
    model = _lm_encodec()
    with pytest.raises(LoadError, match="refusing"):
        model.get_language_model()
    assert model.__dict__.get("_lm") is None


def test_load_encodec_from_upstream_names(tmp_path):
    """An original-encodec checkpoint (SEANet names, weight_g / weight_v, EMA
    codebooks) through load_encodec gives the model it came from."""
    jcfg = encodec_tiny_config()
    model = Encodec(encodec_port_config(jcfg), device="cpu", seed=3)
    fixture_style = {}
    for key, value in model.state_dict().items():
        key = key.replace("encoder.layers.", "encoder.model.").replace(
            "decoder.layers.", "decoder.model.")
        key = key.replace("quantizer.layers.", "quantizer.vq.layers.").replace(
            ".codebook.", "._codebook.")
        fixture_style[key] = value
    path = tmp_path / "encodec.th"
    torch.save(fixture_style, path)
    loaded = load_encodec(str(path), config=encodec_port_config(jcfg), device="cpu")
    assert_same_weights(loaded, model)
