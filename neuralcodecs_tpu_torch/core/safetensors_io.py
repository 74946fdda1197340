"""Minimal safetensors reader/writer (copy of neuralcodecs_tpu.core.safetensors_io).

The safetensors container is: 8-byte little-endian header length N, then N
bytes of JSON mapping tensor names to {dtype, shape, data_offsets}, then the
raw tensor buffer. Parsed directly into numpy arrays, and written from them,
so a file either package writes holds the same bytes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from neuralcodecs_tpu_torch.core.exceptions import LoadError

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "U16": np.uint16,
    "U32": np.uint32,
    "U64": np.uint64,
}

_DTYPE_NAMES = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.bool_): "BOOL",
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """Upcast a uint16 view of bfloat16 data to float32."""
    u32 = raw.astype(np.uint32) << 16
    return u32.view(np.float32)


def read_safetensors_metadata(path: str | Path) -> dict[str, str]:
    """Read only the __metadata__ block of a safetensors file."""
    with open(path, "rb") as f:
        header_len_bytes = f.read(8)
        if len(header_len_bytes) != 8:
            return {}
        (header_len,) = struct.unpack("<Q", header_len_bytes)
        try:
            header = json.loads(f.read(header_len))
        except json.JSONDecodeError:
            return {}
    meta = header.get("__metadata__", {})
    return meta if isinstance(meta, dict) else {}


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Read all tensors from a .safetensors file as numpy arrays.

    bfloat16 tensors are upcast to float32 (numpy has no bf16 dtype; the
    importer re-casts to the model's compute dtype on device-put).
    """
    path = Path(path)
    with open(path, "rb") as f:
        header_len_bytes = f.read(8)
        if len(header_len_bytes) != 8:
            raise LoadError(f"Truncated safetensors file: {path}")
        (header_len,) = struct.unpack("<Q", header_len_bytes)
        header = json.loads(f.read(header_len))
        data_start = 8 + header_len
        out: dict[str, np.ndarray] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype_name = info["dtype"]
            shape = tuple(info["shape"])
            start, end = info["data_offsets"]
            f.seek(data_start + start)
            raw = f.read(end - start)
            if dtype_name == "BF16":
                arr = _bf16_to_f32(np.frombuffer(raw, dtype=np.uint16)).reshape(shape)
            else:
                np_dtype = _DTYPES.get(dtype_name)
                if np_dtype is None:
                    raise LoadError(f"Unsupported safetensors dtype {dtype_name} in {path}")
                arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
            out[name] = arr
    return out


def save_safetensors(
    path: str | Path, tensors: dict[str, np.ndarray], metadata: dict[str, str] | None = None
) -> None:
    """Write numpy arrays to a .safetensors file."""
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    ordered = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dtype_name = _DTYPE_NAMES.get(arr.dtype)
        if dtype_name is None:
            raise LoadError(f"Cannot serialize dtype {arr.dtype} for tensor {name}")
        nbytes = arr.nbytes
        header[name] = {
            "dtype": dtype_name,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        ordered.append(arr)
        offset += nbytes
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte alignment (spec recommendation)
    pad = (-len(header_bytes)) % 8
    header_bytes += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for arr in ordered:
            f.write(arr.tobytes())
