"""Bit packing for the raw (no language model) .ecdc payloads.

``BitPacker`` and ``BitUnpacker`` are copies of the JAX package's
(neuralcodecs_tpu.models.encodec.entropy). The arithmetic coder of the
LM-coded path is not ported yet (ROADMAP).
"""

from __future__ import annotations

import io


class BitPacker:
    """n-bit little-endian bit packing (BitPacker.cs:6-177)."""

    def __init__(self, bits: int, stream: io.RawIOBase | io.BytesIO):
        if not (0 < bits <= 24):
            raise ValueError(f"bits must be in (0, 24], got {bits}")
        self.bits = bits
        self.stream = stream
        self._current_value = 0
        self._current_bits = 0

    def push(self, value: int) -> None:
        max_value = (1 << self.bits) - 1
        if not (0 <= value <= max_value):
            raise ValueError(f"value {value} out of range [0, {max_value}]")
        self._current_value |= value << self._current_bits
        self._current_bits += self.bits
        while self._current_bits >= 8:
            self.stream.write(bytes([self._current_value & 0xFF]))
            self._current_value >>= 8
            self._current_bits -= 8

    def push_many(self, values) -> None:
        for v in values:
            self.push(int(v))

    def flush(self) -> None:
        if self._current_bits > 0:
            self.stream.write(bytes([self._current_value & 0xFF]))
            self._current_value = 0
            self._current_bits = 0


class BitUnpacker:
    """n-bit little-endian bit unpacking (BitUnpacker.cs:6-154)."""

    def __init__(self, bits: int, stream):
        if not (0 < bits <= 32):
            raise ValueError(f"bits must be in (0, 32], got {bits}")
        self.bits = bits
        self.stream = stream
        self._mask = (1 << bits) - 1
        self._current_value = 0
        self._current_bits = 0

    def pull(self) -> int | None:
        while self._current_bits < self.bits:
            byte = self.stream.read(1)
            if not byte:
                return None
            self._current_value |= byte[0] << self._current_bits
            self._current_bits += 8
        value = self._current_value & self._mask
        self._current_value >>= self.bits
        self._current_bits -= self.bits
        return value
