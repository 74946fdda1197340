"""Model export: a model's weights -> safetensors + config.json
(counterpart of neuralcodecs_tpu.core.export).

A model directory holds ``model.safetensors`` (or
``model-XXXXX-of-YYYYY.safetensors`` shards plus an HF
``model.safetensors.index.json``) in the JAX package's native layouts,
marked ``{"format": "neuralcodecs-tpu", "layout": "native"}``, and a
``config.json`` that names the architecture. The files hold what the JAX
package's ``save_pretrained`` writes, so a directory either package saves
loads into the other. Weights reach the files through the model's
``native_state_dict`` / ``load_native_state_dict`` hooks.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from neuralcodecs_tpu_torch.core.config import json_default
from neuralcodecs_tpu_torch.core.files import is_shard_index
from neuralcodecs_tpu_torch.core.importer import load_state_dict as load_merged
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.safetensors_io import load_safetensors, save_safetensors


def save_pretrained(model, directory: str | Path,
                    max_shard_bytes: int | None = None) -> Path:
    """Write ``model.safetensors`` (native-layout weights) + ``config.json``.

    With ``max_shard_bytes`` set (e.g. 2 GiB for the 6.4 GB Dia), the
    weights are split into ``model-XXXXX-of-YYYYY.safetensors`` shards plus
    a standard HF ``model.safetensors.index.json``. A previous export's
    files are removed first, so a re-save leaves no stale index or shard.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for old_file in [directory / "model.safetensors",
                     directory / "model.safetensors.index.json",
                     *directory.glob("model-*-of-*.safetensors")]:
        if old_file.is_file():
            old_file.unlink()
    tensors = model.native_state_dict()
    meta = {"format": "neuralcodecs-tpu", "layout": "native",
            "architecture": model.config.architecture}
    total = sum(t.nbytes for t in tensors.values())
    if max_shard_bytes is not None and total > max_shard_bytes:
        shards: list[dict[str, np.ndarray]] = [{}]
        used = 0
        for name, arr in tensors.items():
            if used and used + arr.nbytes > max_shard_bytes:
                shards.append({})
                used = 0
            shards[-1][name] = arr
            used += arr.nbytes
        n = len(shards)
        weight_map = {}
        for i, shard in enumerate(shards):
            shard_name = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            save_safetensors(directory / shard_name, shard, metadata=meta)
            weight_map.update({k: shard_name for k in shard})
        (directory / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map},
            indent=2))
    else:
        save_safetensors(directory / "model.safetensors", tensors, metadata=meta)
    config = dict(model.config.to_dict())
    config["architecture"] = model.config.architecture
    (directory / "config.json").write_text(
        json.dumps(config, indent=2, default=json_default))
    return directory


def read_native(weights_path: Path) -> dict[str, np.ndarray]:
    """The tensors of a native export: one file, or the shards an index names."""
    if is_shard_index(weights_path):
        return load_merged(weights_path)
    return load_safetensors(weights_path)


def load_pretrained(directory: str | Path, architecture: str | None = None,
                    device=None):
    """Load a save_pretrained directory (either package's) into a model on
    ``device`` ("cuda" when none is given). The native-layout tensors load
    strictly and bit for bit."""
    directory = Path(directory)
    config_data = json.loads((directory / "config.json").read_text())
    architecture = architecture or config_data.get("architecture", "")
    entry = registry.get(architecture)
    model = entry.factory(entry.config_cls.from_dict(config_data), device=device)
    index = directory / "model.safetensors.index.json"
    model.load_native_state_dict(
        read_native(index if index.is_file() else directory / "model.safetensors"))
    return model
