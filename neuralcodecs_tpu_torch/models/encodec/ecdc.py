""".ecdc container format: header and scale-block I/O.

Copy of neuralcodecs_tpu.models.encodec.ecdc, which imports no JAX but sits
in a package that does. Layout: ``b"ECDC"`` magic, a 1-byte version (0), a
4-byte big-endian JSON metadata length, the UTF-8 JSON metadata, then the
per-frame payloads. Required metadata keys: m (model name), al (audio
length), nc (number of codebooks), lm (language-model flag).
"""

from __future__ import annotations

import json
import struct
from typing import Any, BinaryIO

MAGIC = b"ECDC"
CURRENT_VERSION = 0
REQUIRED_KEYS = ("m", "al", "nc", "lm")


def write_header(stream: BinaryIO, metadata: dict[str, Any]) -> None:
    meta_bytes = json.dumps(metadata).encode("utf-8")
    stream.write(MAGIC)
    stream.write(bytes([CURRENT_VERSION]))
    stream.write(struct.pack(">i", len(meta_bytes)))
    stream.write(meta_bytes)


#: sanity cap for the metadata block — a real header is a few hundred bytes
MAX_META_BYTES = 1 << 20


def read_header(stream: BinaryIO) -> dict[str, Any]:
    """Parse the .ecdc header; malformed/truncated input raises ValueError
    (never a raw struct/json error — the bytes may come from the network)."""
    magic = stream.read(4)
    if magic != MAGIC:
        raise ValueError("Invalid Encodec header magic number")
    version = stream.read(1)
    if not version or version[0] != CURRENT_VERSION:
        raise ValueError(f"Unsupported header version: {version!r}")
    raw_len = stream.read(4)
    if len(raw_len) != 4:
        raise ValueError("Truncated .ecdc header (metadata length)")
    (meta_len,) = struct.unpack(">i", raw_len)
    if not (0 < meta_len <= MAX_META_BYTES):
        raise ValueError(f"Implausible .ecdc metadata length: {meta_len}")
    raw_meta = stream.read(meta_len)
    if len(raw_meta) != meta_len:
        raise ValueError("Truncated .ecdc header (metadata body)")
    try:
        meta = json.loads(raw_meta.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise ValueError("Malformed .ecdc metadata JSON") from exc
    if not isinstance(meta, dict):
        raise ValueError("Malformed .ecdc metadata (not an object)")
    return meta


def validate_metadata(metadata: dict[str, Any]) -> None:
    for key in REQUIRED_KEYS:
        if key not in metadata:
            raise ValueError(f"Missing required metadata key: {key}")


def write_scale_values(stream: BinaryIO, scales) -> None:
    """Big-endian scale-factor block (EncodecCompressor.cs:78-95)."""
    values = [float(v) for v in scales]
    stream.write(struct.pack(">i", len(values)))
    for v in values:
        stream.write(struct.pack(">f", v))


def read_scale_values(stream: BinaryIO) -> list[float]:
    raw = stream.read(4)
    if len(raw) != 4:
        raise ValueError("Truncated .ecdc scale block")
    (count,) = struct.unpack(">i", raw)
    if not (0 < count <= 1000):
        raise ValueError(f"Invalid scale count: {count}")
    body = stream.read(4 * count)
    if len(body) != 4 * count:
        raise ValueError("Truncated .ecdc scale block")
    return [struct.unpack(">f", body[4 * i: 4 * i + 4])[0]
            for i in range(count)]
