"""Checkpoint importer: any supported weight file -> flat numpy state dict
(copy of neuralcodecs_tpu.core.importer).

Handles safetensors, torch.save (through the restricted reader in
torch_pickle), .npz and HF sharded checkpoints; unwraps ``state_dict``
nesting and wrapper prefixes, and folds weight norm once, at import: every
conv of the port is then a plain conv.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from neuralcodecs_tpu_torch.core.exceptions import LoadError
from neuralcodecs_tpu_torch.core.files import (
    ModelFileType,
    detect_file_type,
    is_shard_index,
    safe_child_path,
)
from neuralcodecs_tpu_torch.core.safetensors_io import load_safetensors
from neuralcodecs_tpu_torch.core.torch_pickle import load_torch_checkpoint
from neuralcodecs_tpu_torch.core.weights import fold_weight_norm

StateDict = dict[str, np.ndarray]


def load_state_dict(path: str | Path) -> StateDict:
    """Load a weights file of any supported type into a flat state dict.

    Handles the nesting conventions the reference handles: top-level
    ``state_dict`` keys and DAC's ``{"metadata": ..., "state_dict": ...}``
    .pth layout (DACUnpickler.cs) — plus HF sharded checkpoints
    (``*.safetensors.index.json`` / ``*.bin.index.json``), which the
    reference predates: the index's weight_map names per-tensor shard
    files that are loaded and merged.
    """
    path = Path(path)
    if not path.is_file():
        raise LoadError(f"Weights file not found: {path}")
    if is_shard_index(path):
        return _load_sharded(path)
    ftype = detect_file_type(path)
    if ftype == ModelFileType.SAFETENSORS:
        sd: Any = load_safetensors(path)
    elif ftype in (ModelFileType.PYTORCH, ModelFileType.CHECKPOINT, ModelFileType.WEIGHTS):
        sd = load_torch_checkpoint(path)
    elif ftype == ModelFileType.NUMPY:
        with np.load(path) as npz:
            sd = {k: npz[k] for k in npz.files}
    else:
        raise LoadError(f"Unsupported weights file type {ftype} for {path}")
    return normalize_state_dict(sd)


def _load_sharded(index_path: Path) -> StateDict:
    """Merge an HF sharded checkpoint via its index's weight_map."""
    import json

    try:
        index = json.loads(index_path.read_text())
        weight_map: dict[str, str] = index["weight_map"]
    except (json.JSONDecodeError, KeyError, TypeError) as exc:
        raise LoadError(f"Malformed shard index {index_path}") from exc
    merged: StateDict = {}
    for shard_name in sorted(set(weight_map.values())):
        try:
            shard_path = safe_child_path(index_path.parent, shard_name)
        except ValueError as exc:
            raise LoadError(f"Unsafe shard name {shard_name!r} in "
                            f"{index_path.name}") from exc
        if not shard_path.is_file():
            raise LoadError(
                f"Shard {shard_name} referenced by {index_path.name} is "
                "missing (incomplete download?)")
        merged.update(load_state_dict(shard_path))
    missing = set(weight_map) - set(merged)
    if missing:
        raise LoadError(f"Shard index names tensors absent from the shards: "
                        f"{sorted(missing)[:5]}")
    return merged


def normalize_state_dict(obj: Any) -> StateDict:
    """Unwrap checkpoint nesting and flatten to {dotted_name: ndarray}."""
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "weights"):
            inner = obj.get(key)
            if isinstance(inner, dict) and _looks_like_state_dict(inner):
                obj = inner
                break
    if not isinstance(obj, dict):
        raise LoadError(f"Checkpoint does not contain a state dict (got {type(obj)})")
    flat: StateDict = {}
    _flatten(obj, "", flat)
    if not flat:
        raise LoadError("Checkpoint contained no tensors")
    return flat


def _looks_like_state_dict(d: dict) -> bool:
    arrays = sum(1 for v in d.values() if isinstance(v, np.ndarray))
    return arrays > 0 and arrays >= len(d) // 2


def _flatten(obj: Any, prefix: str, out: StateDict) -> None:
    if isinstance(obj, np.ndarray):
        out[prefix] = obj
    elif isinstance(obj, (float, int)) and prefix:
        out[prefix] = np.asarray(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if not isinstance(k, str):
                continue
            _flatten(v, f"{prefix}.{k}" if prefix else k, out)
    # other leaf types (strings, None, stubs) are dropped


def strip_prefix(sd: StateDict, prefixes: tuple[str, ...] = ("module.", "model.")) -> StateDict:
    """Remove wrapper prefixes (DataParallel 'module.', lightning 'model.')."""
    for prefix in prefixes:
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def import_checkpoint(path: str | Path) -> StateDict:
    """Full import pipeline: load -> unwrap -> fold weight norm."""
    return fold_weight_norm(strip_prefix(load_state_dict(path)))
