""".dac artifact: encoded DAC codes + config on disk or on the wire.

Copy of neuralcodecs_tpu.models.dac.dacfile over the port's DACConfig; the
two write the same bytes. Binary layout: ``b"DACF"`` magic, u32 version,
u32 config-JSON length, JSON, u32 tensor count, then per tensor: u32 ndim,
i64 dims, raw little-endian int32 data.

Parsing is hardened for untrusted input (files travel, and a server accepts
these bytes over HTTP): every length field is bounded before allocation and
a truncated payload raises ``ValueError`` instead of producing short arrays.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np

from neuralcodecs_tpu_torch.models.dac.config import DACConfig

_MAGIC = b"DACF"
_VERSION = 1

# untrusted-input bounds (generous: real artifacts are one [B, Nq, T]
# tensor with a ~1 KB config)
_MAX_CONFIG_BYTES = 1 << 20
_MAX_TENSORS = 1024
_MAX_NDIM = 8
_MAX_ELEMENTS = 1 << 31  # 8 GiB of int32 — far above any real artifact


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError("truncated .dac artifact")
    return data


def write_dac_stream(f, codes: list[np.ndarray], config: DACConfig) -> None:
    """Serialize codes + config to a binary stream."""
    config_json = json.dumps(config.to_dict()).encode("utf-8")
    f.write(_MAGIC)
    f.write(struct.pack("<I", _VERSION))
    f.write(struct.pack("<I", len(config_json)))
    f.write(config_json)
    f.write(struct.pack("<I", len(codes)))
    for code in codes:
        arr = np.ascontiguousarray(np.asarray(code), dtype=np.int32)
        f.write(struct.pack("<I", arr.ndim))
        for dim in arr.shape:
            f.write(struct.pack("<q", dim))
        f.write(arr.tobytes())


def read_dac_stream(f) -> tuple[list[np.ndarray], DACConfig]:
    """Parse a .dac binary stream (untrusted input: bounded + truncation-safe)."""
    if _read_exact(f, 4) != _MAGIC:
        raise ValueError("Not a .dac artifact")
    (version,) = struct.unpack("<I", _read_exact(f, 4))
    if version != _VERSION:
        raise ValueError(f"Unsupported .dac version {version}")
    (config_len,) = struct.unpack("<I", _read_exact(f, 4))
    if config_len > _MAX_CONFIG_BYTES:
        raise ValueError(f"unreasonable .dac config size {config_len}")
    config = DACConfig.from_dict(json.loads(_read_exact(f, config_len)))
    (count,) = struct.unpack("<I", _read_exact(f, 4))
    if count > _MAX_TENSORS:
        raise ValueError(f"unreasonable .dac tensor count {count}")
    codes = []
    for _ in range(count):
        (ndim,) = struct.unpack("<I", _read_exact(f, 4))
        if ndim > _MAX_NDIM:
            raise ValueError(f"unreasonable .dac tensor rank {ndim}")
        shape = struct.unpack(f"<{ndim}q", _read_exact(f, 8 * ndim))
        if any(d < 0 for d in shape):
            raise ValueError("negative .dac tensor dimension")
        n = 1
        for d in shape:
            n *= int(d)  # python ints: no overflow
        if n > _MAX_ELEMENTS:
            raise ValueError(f"unreasonable .dac tensor size {n}")
        arr = np.frombuffer(_read_exact(f, 4 * n), np.int32).reshape(shape)
        codes.append(arr)
    return codes, config


def save_dac_file(path: str | Path, codes: list[np.ndarray],
                  config: DACConfig) -> None:
    with open(path, "wb") as f:
        write_dac_stream(f, codes, config)


def load_dac_file(path: str | Path) -> tuple[list[np.ndarray], DACConfig]:
    with open(path, "rb") as f:
        return read_dac_stream(f)


def dac_file_bytes(codes: list[np.ndarray], config: DACConfig) -> bytes:
    """The .dac artifact as bytes (a server's compress response body)."""
    buf = io.BytesIO()
    write_dac_stream(buf, codes, config)
    return buf.getvalue()


def parse_dac_file(data: bytes) -> tuple[list[np.ndarray], DACConfig]:
    """Parse .dac bytes (a server's decompress request body)."""
    return read_dac_stream(io.BytesIO(data))
