"""Model-file type sniffing and hashing (copy of neuralcodecs_tpu.core.files).

Detection by extension first, then by magic bytes (pickle 0x80, ZIP "PK"
for zipped PyTorch checkpoints), with safetensors/json short-circuits; the
path-traversal policy shared by the repositories and the cache.
"""

from __future__ import annotations

import enum
import hashlib
from pathlib import Path


class ModelFileType(enum.Enum):
    UNKNOWN = "unknown"
    PYTORCH = "pytorch"          # pickle-based .pt/.pth (zipped or legacy)
    SAFETENSORS = "safetensors"
    CHECKPOINT = "checkpoint"    # .ckpt (zipped pickle)
    WEIGHTS = "weights"          # raw .bin
    CONFIG = "config"            # .json
    NUMPY = "numpy"              # .npz (native artifact of this framework)
    ONNX = "onnx"


_EXTENSION_MAP = {
    ".pt": ModelFileType.PYTORCH,
    ".pth": ModelFileType.PYTORCH,
    ".ckpt": ModelFileType.CHECKPOINT,
    ".safetensors": ModelFileType.SAFETENSORS,
    ".bin": ModelFileType.WEIGHTS,
    ".json": ModelFileType.CONFIG,
    ".npz": ModelFileType.NUMPY,
    ".onnx": ModelFileType.ONNX,
}


def detect_file_type(path: str | Path) -> ModelFileType:
    """Detect model file type by extension, falling back to magic bytes."""
    path = Path(path)
    ext_type = _EXTENSION_MAP.get(path.suffix.lower())
    if ext_type is not None:
        return ext_type
    return detect_file_type_from_contents(path)


def detect_file_type_from_contents(path: str | Path) -> ModelFileType:
    """Sniff the file header: pickle protocol byte, ZIP magic, safetensors."""
    path = Path(path)
    if not path.is_file():
        return ModelFileType.UNKNOWN
    try:
        with open(path, "rb") as f:
            header = f.read(16)
    except OSError:
        return ModelFileType.UNKNOWN
    if len(header) < 8:
        return ModelFileType.UNKNOWN
    if header[0] == 0x80:  # pickle protocol marker
        return ModelFileType.PYTORCH
    if header[:2] == b"PK":  # ZIP container: zipped pickle (torch.save) or ckpt
        return (
            ModelFileType.CHECKPOINT
            if path.suffix.lower() == ".ckpt"
            else ModelFileType.PYTORCH
        )
    # safetensors: little-endian u64 header length followed by a JSON object
    header_len = int.from_bytes(header[:8], "little")
    if 0 < header_len < 100_000_000 and header[8:9] == b"{":
        return ModelFileType.SAFETENSORS
    return ModelFileType.UNKNOWN


def is_valid_model_file(path: str | Path) -> bool:
    if is_shard_index(path):
        return True
    return detect_file_type(path) in (
        ModelFileType.PYTORCH,
        ModelFileType.SAFETENSORS,
        ModelFileType.CHECKPOINT,
        ModelFileType.WEIGHTS,
        ModelFileType.NUMPY,
    )


def file_sha256(path: str | Path, chunk_size: int = 1 << 20) -> str:
    """Hex SHA-256 of a file (cache integrity metadata)."""
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            sha.update(chunk)
    return sha.hexdigest()


def wildcard_match(pattern: str, name: str) -> bool:
    """Case-insensitive * / ? wildcard matching
    (counterpart of Core/Utils/WildcardPattern.cs:9)."""
    import fnmatch

    return fnmatch.fnmatch(name.lower(), pattern.lower())


def safe_child_path(root: Path, name: str) -> Path:
    """Validate a remote-controlled file name and return ``root / name``.

    Single source of truth for the path-traversal policy:
    rejects backslashes, absolute paths, '.'/'..' components, empty names,
    and anything that resolves outside ``root``. Raises ValueError; callers
    wrap it in their domain exception (RepositoryError / CacheError).
    """
    if "\\" in name or name.startswith("/") or not name:
        raise ValueError(f"Unsafe remote file name {name!r}")
    parts = Path(name).parts
    if (not parts or any(p in ("..", ".") for p in parts)
            or Path(name).is_absolute()):
        raise ValueError(f"Unsafe remote file name {name!r}")
    root = Path(root)
    joined = (root / name).resolve()
    if not joined.is_relative_to(root.resolve()):
        raise ValueError(f"Unsafe remote file name {name!r}")
    return root / name


_SHARD_INDEX_SUFFIXES = (".safetensors.index.json", ".bin.index.json")


def is_shard_index(name: str | Path) -> bool:
    """True for a sharded-checkpoint index file
    (model.safetensors.index.json / pytorch_model.bin.index.json — the HF
    layout for models too large for one file, e.g. multi-GB Dia weights)."""
    return str(name).endswith(_SHARD_INDEX_SUFFIXES)

