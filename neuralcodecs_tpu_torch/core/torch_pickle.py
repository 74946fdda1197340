"""Restricted PyTorch checkpoint reader (copy of neuralcodecs_tpu.core.torch_pickle).

Reads the ZIP-archive torch.save format without running pickle globals: a
custom `pickle.Unpickler` whose `persistent_load` maps ``('storage',
storage_type, key, location, numel)`` records onto numpy buffers read from
``<prefix>/data/<key>`` inside the archive, and whose ``find_class``
reconstructs tensors with numpy strided views and resolves only an
allowlist of benign globals; anything else comes back as an inert stub.

Pre-ZIP (legacy) torch.save files go through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.exceptions import LoadError

# torch storage class name -> (numpy dtype, element size in bytes)
_STORAGE_DTYPES: dict[str, tuple[np.dtype, int]] = {
    "DoubleStorage": (np.dtype(np.float64), 8),
    "FloatStorage": (np.dtype(np.float32), 4),
    "HalfStorage": (np.dtype(np.float16), 2),
    "BFloat16Storage": (np.dtype(np.uint16), 2),  # upcast later
    "LongStorage": (np.dtype(np.int64), 8),
    "IntStorage": (np.dtype(np.int32), 4),
    "ShortStorage": (np.dtype(np.int16), 2),
    "CharStorage": (np.dtype(np.int8), 1),
    "ByteStorage": (np.dtype(np.uint8), 1),
    "BoolStorage": (np.dtype(np.bool_), 1),
    "ComplexFloatStorage": (np.dtype(np.complex64), 8),
    "ComplexDoubleStorage": (np.dtype(np.complex128), 16),
}

# torch.<dtype> names appearing as pickled globals (new-style TypedStorage)
_TORCH_DTYPE_NAMES: dict[str, np.dtype] = {
    "float64": np.dtype(np.float64),
    "float32": np.dtype(np.float32),
    "float16": np.dtype(np.float16),
    "bfloat16": np.dtype(np.uint16),
    "int64": np.dtype(np.int64),
    "int32": np.dtype(np.int32),
    "int16": np.dtype(np.int16),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "bool": np.dtype(np.bool_),
    "complex64": np.dtype(np.complex64),
    "complex128": np.dtype(np.complex128),
}


class _StorageStub:
    """Lazily-read storage blob from the checkpoint archive."""

    __slots__ = ("dtype", "data", "is_bf16")

    def __init__(self, dtype: np.dtype, data: bytes, is_bf16: bool):
        self.dtype = dtype
        self.data = data
        self.is_bf16 = is_bf16

    def as_array(self) -> np.ndarray:
        arr = np.frombuffer(self.data, dtype=self.dtype)
        if self.is_bf16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr


class _TorchDtypeStub:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def _rebuild_tensor_v2(storage: _StorageStub, storage_offset, size, stride, *args) -> np.ndarray:
    arr = storage.as_array()
    itemsize = arr.dtype.itemsize
    byte_strides = tuple(s * itemsize for s in stride)
    view = np.lib.stride_tricks.as_strided(
        arr[storage_offset:], shape=tuple(size), strides=byte_strides
    )
    return np.ascontiguousarray(view)


def _rebuild_parameter(data: np.ndarray, requires_grad=None, *args) -> np.ndarray:
    return data


class _Skipped:
    """Placeholder for unpicklable objects we don't care about (optimizers...)."""

    def __init__(self, *args: Any, **kwargs: Any):
        self.args = args

    def __call__(self, *args: Any, **kwargs: Any) -> "_Skipped":
        return _Skipped(*args)


# Exact names a checkpoint pickle may resolve; everything else is stubbed.
_SAFE_BUILTINS = frozenset({"list", "dict", "set", "tuple", "slice",
                            "frozenset", "bytearray", "complex"})
_SAFE_NUMPY_GLOBALS = frozenset({
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
})


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file: io.BufferedReader, read_record):
        super().__init__(file)
        self._read_record = read_record

    def find_class(self, module: str, name: str):  # noqa: D102
        if name in ("_rebuild_tensor_v2", "_rebuild_tensor"):
            return _rebuild_tensor_v2
        if name == "_rebuild_parameter":
            return _rebuild_parameter
        if module == "torch" and name in _STORAGE_DTYPES:
            return name  # storage tag consumed by persistent_load
        if module == "torch" and name in _TORCH_DTYPE_NAMES:
            return _TorchDtypeStub(name)
        if module == "torch.storage" and name == "_load_from_bytes":
            raise LoadError("Legacy inline-storage checkpoints are not supported")
        if module == "collections" and name == "OrderedDict":
            import collections

            return collections.OrderedDict
        # Strict allowlist: resolving arbitrary builtins or
        # numpy attributes hands eval/exec/__import__ to a malicious pickle.
        # Checkpoints only need benign containers + numpy array reconstruction.
        if module == "builtins" and name in _SAFE_BUILTINS:
            import builtins

            return getattr(builtins, name)
        if (module, name) in _SAFE_NUMPY_GLOBALS:
            import importlib

            return getattr(importlib.import_module(module), name)
        # Anything else (argparse.Namespace, omegaconf, model classes,
        # unlisted builtins/numpy callables...) is replaced by an inert stub —
        # checkpoints only need tensors + dicts.
        return _Skipped

    def persistent_load(self, saved_id: Any) -> _StorageStub:
        if not (isinstance(saved_id, tuple) and saved_id and saved_id[0] == "storage"):
            raise LoadError(f"Unexpected persistent id {saved_id!r}")
        _, storage_type, key, _location, numel = saved_id
        if isinstance(storage_type, _TorchDtypeStub):
            dtype = _TORCH_DTYPE_NAMES[storage_type.name]
            is_bf16 = storage_type.name == "bfloat16"
        elif isinstance(storage_type, str):
            dtype, _ = _STORAGE_DTYPES[storage_type]
            is_bf16 = storage_type == "BFloat16Storage"
        else:
            raise LoadError(f"Unknown storage type {storage_type!r}")
        data = self._read_record(key, numel * dtype.itemsize)
        return _StorageStub(dtype, data, is_bf16)


def load_torch_checkpoint(path: str | Path) -> Any:
    """Load a torch.save ZIP checkpoint into nested dicts of numpy arrays."""
    path = Path(path)
    try:
        zf = zipfile.ZipFile(path)
    except zipfile.BadZipFile:
        return _load_legacy(path)
    with zf:
        names = zf.namelist()
        pkl_names = [n for n in names if n.endswith("/data.pkl") or n == "data.pkl"]
        if not pkl_names:
            raise LoadError(f"No data.pkl found in checkpoint {path}")
        pkl_name = pkl_names[0]
        prefix = pkl_name[: -len("data.pkl")]

        def read_record(key: str, nbytes: int) -> bytes:
            with zf.open(f"{prefix}data/{key}") as f:
                return f.read(nbytes)

        with zf.open(pkl_name) as f:
            return _TorchUnpickler(io.BufferedReader(f), read_record).load()


def _load_legacy(path: Path) -> Any:
    """Pre-ZIP torch.save files go through torch.load."""
    # weights_only=True: the legacy path must not execute arbitrary pickle
    # globals either. Legacy files holding non-tensor payloads are rejected
    # rather than risked.
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return _tensors_to_numpy(obj)


def _tensors_to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _tensors_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors_to_numpy(v) for v in obj)
    return obj
