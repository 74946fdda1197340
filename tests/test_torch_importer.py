"""The port's checkpoint importer and its hardening, on the CPU.

Port counterparts of tests/test_importer.py (the restricted torch.save
reader, safetensors, weight-norm folding, sharded checkpoints, directory
resolution) and tests/test_security.py (unpickler stubs, ``safe_join``
traversal, cache integrity). Where the two packages read the same file,
the port's arrays must be the JAX package's, bit for bit.
"""

import io
import json
import os
import pickle
import pickletools
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralcodecs_tpu.core.importer import import_checkpoint as jax_import_checkpoint
from neuralcodecs_tpu.core.safetensors_io import load_safetensors as jax_load_safetensors
from neuralcodecs_tpu_torch.core import cache as cache_mod
from neuralcodecs_tpu_torch.core.cache import ModelCache
from neuralcodecs_tpu_torch.core.exceptions import CacheError, LoadError, RepositoryError
from neuralcodecs_tpu_torch.core.files import ModelFileType, detect_file_type
from neuralcodecs_tpu_torch.core.importer import (
    fold_weight_norm,
    import_checkpoint,
    load_state_dict,
    normalize_state_dict,
    strip_prefix,
)
from neuralcodecs_tpu_torch.core.loader import LoadOptions, ModelLoader
from neuralcodecs_tpu_torch.core.repos import pick_model_file, safe_join
from neuralcodecs_tpu_torch.core.safetensors_io import (
    load_safetensors,
    read_safetensors_metadata,
    save_safetensors,
)
from neuralcodecs_tpu_torch.core.torch_pickle import load_torch_checkpoint
from test_torch_loader import no_network  # noqa: F401  (autouse: no test reaches a network)


# ------------------------------------------------ tests/test_importer.py cases


def test_torch_zip_checkpoint_roundtrip(tmp_path):
    torch.manual_seed(0)
    sd = {
        "encoder.weight": torch.randn(8, 4, 7),
        "encoder.bias": torch.randn(8),
        "codebook.weight": torch.randn(64, 8).to(torch.float16),
        "alpha": torch.randn(1, 8, 1).to(torch.bfloat16),
        "step": torch.tensor(3, dtype=torch.int64),
    }
    path = tmp_path / "model.pt"
    torch.save(sd, path)
    got = load_state_dict(path)
    assert set(got) == set(sd)
    np.testing.assert_allclose(got["encoder.weight"], sd["encoder.weight"].numpy())
    np.testing.assert_allclose(got["codebook.weight"], sd["codebook.weight"].numpy())
    np.testing.assert_allclose(got["alpha"], sd["alpha"].float().numpy())
    assert got["step"] == 3


def test_torch_checkpoint_nested_state_dict(tmp_path):
    inner = {"layer.weight": torch.randn(4, 4)}
    torch.save({"metadata": {"kbps": 8.0}, "state_dict": inner}, tmp_path / "m.pth")
    got = load_state_dict(tmp_path / "m.pth")
    assert "layer.weight" in got
    np.testing.assert_allclose(got["layer.weight"], inner["layer.weight"].numpy())


def test_torch_checkpoint_noncontiguous_tensor(tmp_path):
    t = torch.randn(6, 8).t()  # transposed: non-trivial strides
    torch.save({"w": t}, tmp_path / "m.pt")
    got = load_state_dict(tmp_path / "m.pt")
    np.testing.assert_allclose(got["w"], t.numpy())


def test_legacy_torch_checkpoint(tmp_path):
    """A pre-ZIP torch.save file goes through torch.load(weights_only=True)."""
    sd = {"w": torch.randn(3, 5), "half": torch.randn(4).to(torch.bfloat16)}
    path = tmp_path / "legacy.pt"
    torch.save(sd, path, _use_new_zipfile_serialization=False)
    assert not zipfile.is_zipfile(path)
    got = load_state_dict(path)
    np.testing.assert_array_equal(got["w"], sd["w"].numpy())
    np.testing.assert_array_equal(got["half"], sd["half"].float().numpy())


def test_safetensors_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": (rng.standard_normal(7) * 10).astype(np.int64),
        "c": rng.standard_normal((2, 2)).astype(np.float16),
    }
    path = tmp_path / "m.safetensors"
    save_safetensors(path, tensors, metadata={"format": "pt"})
    assert detect_file_type(path) == ModelFileType.SAFETENSORS
    assert read_safetensors_metadata(path) == {"format": "pt"}
    for got in (load_safetensors(path), jax_load_safetensors(path)):
        for k in tensors:
            np.testing.assert_array_equal(got[k], tensors[k])


def test_fold_weight_norm_matches_torch_parametrization():
    torch.manual_seed(1)
    wn = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(6, 12, 5, bias=True))
    sd = {f"conv.{k}": v.detach().numpy() for k, v in wn.state_dict().items()}
    folded = fold_weight_norm(sd)
    assert "conv.weight" in folded
    assert not any("parametrizations" in k for k in folded)
    np.testing.assert_allclose(folded["conv.weight"], wn.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fold_weight_norm_legacy_names():
    torch.manual_seed(2)
    v = torch.randn(8, 4, 3)
    g = torch.randn(8, 1, 1).abs()
    sd = {"c.weight_v": v.numpy(), "c.weight_g": g.numpy(), "c.bias": np.zeros(8, np.float32)}
    folded = fold_weight_norm(sd)
    expected = (g * v / v.pow(2).sum((1, 2), keepdim=True).sqrt()).numpy()
    np.testing.assert_allclose(folded["c.weight"], expected, rtol=1e-6)
    assert "c.bias" in folded


def test_fold_weight_norm_transpose_conv():
    """ConvTranspose1d weight_norm (dim 0 = Cin) folds the same way."""
    torch.manual_seed(3)
    wn = torch.nn.utils.parametrizations.weight_norm(torch.nn.ConvTranspose1d(6, 12, 4, stride=2))
    sd = {f"ct.{k}": v.detach().numpy() for k, v in wn.state_dict().items()}
    folded = fold_weight_norm(sd)
    np.testing.assert_allclose(folded["ct.weight"], wn.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_strip_prefix():
    sd = {"module.a.w": np.zeros(1), "module.b.w": np.ones(1)}
    assert set(strip_prefix(sd)) == {"a.w", "b.w"}


def test_normalize_rejects_empty():
    with pytest.raises(LoadError):
        normalize_state_dict({"not_a_tensor": "hello"})


def test_import_checkpoint_end_to_end(tmp_path):
    """torch.save with weight-norm parameters -> a folded numpy dict, the
    JAX package's importer's bit for bit."""
    torch.manual_seed(4)
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(2, 4, 3))
    torch.save({f"module.enc.{k}": v for k, v in conv.state_dict().items()},
               tmp_path / "ckpt.pt")
    got = import_checkpoint(tmp_path / "ckpt.pt")
    np.testing.assert_allclose(got["enc.weight"], conv.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    want = jax_import_checkpoint(tmp_path / "ckpt.pt")
    assert set(got) == set(want) == {"enc.weight", "enc.bias"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_sharded_checkpoint_merge(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    c = rng.standard_normal((2, 2)).astype(np.float32)
    save_safetensors(tmp_path / "model-00001-of-00002.safetensors",
                     {"enc.weight": a, "enc.bias": b})
    save_safetensors(tmp_path / "model-00002-of-00002.safetensors", {"dec.weight": c})
    index = {"metadata": {"total_size": int(a.nbytes + b.nbytes + c.nbytes)},
             "weight_map": {"enc.weight": "model-00001-of-00002.safetensors",
                            "enc.bias": "model-00001-of-00002.safetensors",
                            "dec.weight": "model-00002-of-00002.safetensors"}}
    idx = tmp_path / "model.safetensors.index.json"
    idx.write_text(json.dumps(index))
    sd = import_checkpoint(idx)
    assert set(sd) == {"enc.weight", "enc.bias", "dec.weight"}
    np.testing.assert_array_equal(sd["enc.weight"], a)
    np.testing.assert_array_equal(sd["dec.weight"], c)


def test_sharded_checkpoint_resolve_prefers_index(tmp_path):
    save_safetensors(tmp_path / "model-00001-of-00001.safetensors",
                     {"w": np.zeros((2, 2), np.float32)})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"w": "model-00001-of-00001.safetensors"}}))
    got = ModelLoader().resolve(str(tmp_path), LoadOptions())
    assert got.name == "model.safetensors.index.json"


@pytest.mark.parametrize("case", ["missing-shard", "traversal", "absent-tensor"])
def test_sharded_checkpoint_errors(tmp_path, case):
    idx = tmp_path / "m.safetensors.index.json"
    save_safetensors(tmp_path / "s.safetensors", {"w": np.zeros(2, np.float32)})
    weight_map, match = {
        "missing-shard": ({"w": "gone.safetensors"}, "missing"),
        "traversal": ({"w": "../evil.safetensors"}, "Unsafe"),
        "absent-tensor": ({"w": "s.safetensors", "extra": "s.safetensors"}, "absent"),
    }[case]
    idx.write_text(json.dumps({"weight_map": weight_map}))
    with pytest.raises(LoadError, match=match):
        import_checkpoint(idx)


@pytest.mark.parametrize("names,want", [
    (["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
      "model.safetensors.index.json", "config.json"], "model.safetensors.index.json"),
    (["a.safetensors"], "a.safetensors"),
    # a complete single safetensors file beats a pickle shard index
    (["model.safetensors", "pytorch_model.bin.index.json",
      "pytorch_model-00001-of-00002.bin"], "model.safetensors"),
    (["model.safetensors", "model.safetensors.index.json", "pytorch_model.bin.index.json"],
     "model.safetensors.index.json"),
    # no safe format: the pickle shard index beats a loose pickle
    (["pytorch_model.bin.index.json", "other.bin"], "pytorch_model.bin.index.json"),
    # a safetensors shard piece without its index is not a checkpoint
    (["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
      "pytorch_model.bin.index.json"], "pytorch_model.bin.index.json"),
    # ... but an -of-00001 shard is
    (["model-00001-of-00001.safetensors", "config.json"], "model-00001-of-00001.safetensors"),
])
def test_pick_model_file_prefers_shard_index(names, want):
    assert pick_model_file(names) == want


def test_sharded_find_config_skips_index(tmp_path):
    idx = tmp_path / "model.safetensors.index.json"
    idx.write_text(json.dumps({"weight_map": {}}))
    (tmp_path / "config.json").write_text(json.dumps({"sampling_rate": 16000}))
    got = ModelLoader.find_config(idx)
    assert got is not None and got.name == "config.json"
    (tmp_path / "config.json").unlink()
    assert ModelLoader.find_config(idx) is None


@pytest.mark.parametrize("sharded", [False, True])
def test_is_native_export(tmp_path, sharded):
    """Only safetensors marked format neuralcodecs-tpu / layout native count
    as an export; for an index, its first shard's marks decide."""
    meta = {"format": "neuralcodecs-tpu", "layout": "native", "architecture": "snac"}
    w = {"w": np.zeros(2, np.float32)}
    if sharded:
        save_safetensors(tmp_path / "model-00001-of-00001.safetensors", w, metadata=meta)
        path = tmp_path / "model.safetensors.index.json"
        path.write_text(json.dumps({"weight_map": {"w": "model-00001-of-00001.safetensors"}}))
    else:
        path = tmp_path / "model.safetensors"
        save_safetensors(path, w, metadata=meta)
    assert ModelLoader._is_native_export(path)
    save_safetensors(tmp_path / "other.safetensors", w, metadata={"format": "pt"})
    assert not ModelLoader._is_native_export(tmp_path / "other.safetensors")
    torch.save({"w": torch.zeros(2)}, tmp_path / "m.pt")
    assert not ModelLoader._is_native_export(tmp_path / "m.pt")


# ---------------------------------------------- tests/test_security.py cases


def _make_zip_checkpoint(path: Path, payload: bytes) -> None:
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", payload)


class _Evil:
    def __reduce__(self):
        return (eval, ("__import__('os').getpid()",))


def test_unpickler_stubs_eval(tmp_path):
    """A REDUCE on builtins.eval comes back as an inert stub, not run."""
    path = tmp_path / "evil.pt"
    _make_zip_checkpoint(path, pickle.dumps(_Evil()))
    assert type(load_torch_checkpoint(path)).__name__ == "_Skipped"


def test_unpickler_stubs_arbitrary_numpy_attr(tmp_path):
    payload = b"\x80\x02cnumpy.testing\nassert_equal\nq\x00."
    pickletools.dis(payload, out=io.StringIO())  # a valid pickle
    path = tmp_path / "gadget.pt"
    _make_zip_checkpoint(path, payload)
    out = load_torch_checkpoint(path)
    assert getattr(out, "__name__", None) == "_Skipped" or type(out).__name__ == "_Skipped"


def test_unpickler_allows_benign_containers(tmp_path):
    path = tmp_path / "ok.pt"
    _make_zip_checkpoint(path, pickle.dumps({"a": [1, 2], "b": (3, 4), "c": {5, 6}}))
    assert load_torch_checkpoint(path) == {"a": [1, 2], "b": (3, 4), "c": {5, 6}}


def test_unsafe_checkpoint_through_the_loader(tmp_path):
    """A checkpoint whose pickle would run eval loads no weights: the stub
    holds no tensor, so the import refuses it."""
    path = tmp_path / "evil.pt"
    _make_zip_checkpoint(path, pickle.dumps({"state_dict": _Evil()}))
    with pytest.raises(LoadError, match="no tensors|state dict"):
        import_checkpoint(path)


@pytest.mark.parametrize("name", ["../../../escape.pt", "/abs/path.pt", "a/../../b.pt",
                                  "a\\b.pt", "", "."])
def test_safe_join_rejects_traversal(tmp_path, name):
    with pytest.raises(RepositoryError):
        safe_join(tmp_path, name)


def test_safe_join_allows_nested(tmp_path):
    assert safe_join(tmp_path, "sub/dir/model.safetensors") == \
        tmp_path / "sub/dir/model.safetensors"


def test_cache_model_rejects_traversal(tmp_path):
    cache = ModelCache(tmp_path / "cache")
    src = tmp_path / "w.bin"
    src.write_bytes(b"x" * 8)
    with pytest.raises(CacheError):
        cache.cache_model("owner/repo", "main", {"../../evil.bin": src})


def test_cache_detects_same_size_tampering(tmp_path):
    cache = ModelCache(tmp_path / "cache")
    src = tmp_path / "w.bin"
    src.write_bytes(b"A" * 16)
    d = cache.cache_model("owner/repo", "main", {"w.bin": src})
    (d / "w.bin").write_bytes(b"B" * 16)
    assert cache.get_cached_path("owner/repo", "main") is None


def test_cache_detects_mtime_preserving_tampering(tmp_path):
    """A tamper that restores size and mtime still fails the first load in a
    fresh process: the mtime fast path needs one full SHA-256 check first."""
    cache = ModelCache(tmp_path / "cache")
    src = tmp_path / "w.bin"
    src.write_bytes(b"A" * 16)
    d = cache.cache_model("owner/repo", "main", {"w.bin": src})
    st = (d / "w.bin").stat()
    (d / "w.bin").write_bytes(b"B" * 16)
    os.utime(d / "w.bin", (st.st_atime, st.st_mtime))
    cache_mod._verified_this_process.clear()  # a fresh process
    assert cache.get_cached_path("owner/repo", "main") is None


def test_cache_mtime_fast_path_after_verification(tmp_path, monkeypatch):
    cache = ModelCache(tmp_path / "cache")
    src = tmp_path / "w.bin"
    src.write_bytes(b"A" * 16)
    d = cache.cache_model("owner/repo", "main", {"w.bin": src})
    cache_mod._verified_this_process.clear()
    assert cache.get_cached_path("owner/repo", "main") == d  # pays the hash
    calls = []
    orig = cache_mod.file_sha256
    monkeypatch.setattr(cache_mod, "file_sha256", lambda p: calls.append(p) or orig(p))
    assert cache.get_cached_path("owner/repo", "main") == d
    assert calls == []  # no re-hash within the process


def test_cache_ttl_and_metadata(tmp_path):
    """An entry older than the TTL is a miss; cache_meta.json records the
    SHA-256 and size the JAX package's cache records."""
    src = tmp_path / "w.bin"
    src.write_bytes(b"C" * 32)
    d = ModelCache(tmp_path / "cache").cache_model("owner/repo", "rev", {"w.bin": src})
    meta = json.loads((d / "cache_meta.json").read_text())
    assert meta["model_id"] == "owner/repo" and meta["revision"] == "rev"
    import hashlib
    assert meta["files"][0]["sha256"] == hashlib.sha256(b"C" * 32).hexdigest()
    assert meta["files"][0]["size"] == 32
    assert ModelCache(tmp_path / "cache", ttl=1e-9).get_cached_path("owner/repo", "rev") is None
    assert ModelCache(tmp_path / "cache").get_cached_path("owner/repo", "rev") == d
