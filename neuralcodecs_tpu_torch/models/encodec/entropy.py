"""Entropy coding for .ecdc: bit packing and range (arithmetic) coding.

Copies of the JAX package's neuralcodecs_tpu.models.encodec.entropy, which
imports no JAX but sits in a package that does: ``BitPacker`` and
``BitUnpacker`` for the raw payloads; the CDF quantizers and
``ArithmeticCoder`` / ``ArithmeticDecoder`` for the LM-coded ones.

The CDF quantizers are numpy on the host, so every device builds the same
integer CDFs from the same pdfs. The coder classes are the plain versions
of the C++ range coder (``native/entropy.cpp``), which the compressor runs:
they hold its semantics and serve the tests.
"""

from __future__ import annotations

import io

import numpy as np


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


def build_stable_quantized_cdf(
    pdf: np.ndarray,
    total_range_bits: int = 24,
    roundoff: float = 1e-8,
    min_range: int = 2,
    check: bool = True,
) -> np.ndarray:
    """Quantize a pdf into a stable integer CDF
    (ArithmeticCodingUtils.BuildStableQuantizedCdf :18-101)."""
    pdf = np.asarray(pdf, np.float32)
    if roundoff > 0:
        pdf = np.floor(pdf / roundoff) * roundoff
    total_range = 1 << total_range_bits
    cardinality = pdf.shape[0]
    alpha = min_range * cardinality / total_range
    if alpha > 1:
        raise ValueError(f"alpha ({alpha}) > 1: reduce min_range or raise bits")
    ranges = np.floor(pdf * ((1.0 - alpha) * total_range)).astype(np.int64) + min_range
    cdf = np.cumsum(ranges)
    if check:
        if cdf[-1] > total_range:
            raise ValueError(f"CDF total {cdf[-1]} exceeds range {total_range}")
        if (np.diff(cdf) < min_range).any() or cdf[0] < min_range:
            raise ValueError("Ranges too small: raise bits or lower min_range")
    return cdf


def build_stable_quantized_cdf_batch(
    pdfs: np.ndarray,
    total_range_bits: int = 24,
    roundoff: float = 1e-8,
    min_range: int = 2,
    check: bool = True,
) -> np.ndarray:
    """Vectorized CDF quantizer over [..., card] pdfs (same math as the scalar
    version; one numpy pass instead of a Python loop per symbol)."""
    pdfs = np.asarray(pdfs, np.float32)
    if roundoff > 0:
        pdfs = np.floor(pdfs / roundoff) * roundoff
    total_range = 1 << total_range_bits
    cardinality = pdfs.shape[-1]
    alpha = min_range * cardinality / total_range
    if alpha > 1:
        raise ValueError(f"alpha ({alpha}) > 1: reduce min_range or raise bits")
    ranges = np.floor(pdfs * ((1.0 - alpha) * total_range)).astype(np.int64) + min_range
    cdfs = np.cumsum(ranges, axis=-1)
    if check:
        if (cdfs[..., -1] > total_range).any():
            raise ValueError("CDF total exceeds range")
        if (np.diff(cdfs, axis=-1) < min_range).any() or (cdfs[..., 0] < min_range).any():
            raise ValueError("Ranges too small: raise bits or lower min_range")
    return cdfs


class ArithmeticCoder:
    """Range coder over quantized CDFs (ArithmeticCoder.cs:9-241)."""

    def __init__(self, stream, total_range_bits: int = 24):
        if not (0 < total_range_bits <= 30):
            raise ValueError("total_range_bits must be in (0, 30]")
        self.total_range_bits = total_range_bits
        self._packer = BitPacker(1, stream)
        self._low = 0
        self._high = 0
        self._max_bit = -1

    @property
    def delta(self) -> int:
        return self._high - self._low + 1

    def push(self, symbol: int, quantized_cdf: np.ndarray) -> None:
        while self.delta < (1 << self.total_range_bits):
            self._low *= 2
            self._high = self._high * 2 + 1
            self._max_bit += 1
        range_low = 0 if symbol == 0 else int(quantized_cdf[symbol - 1])
        range_high = int(quantized_cdf[symbol]) - 1
        scale = self.delta / (1 << self.total_range_bits)
        effective_low = int(np.ceil(range_low * scale))
        effective_high = int(np.floor(range_high * scale))
        if effective_low > effective_high:
            raise RuntimeError(
                f"Invalid range for symbol {symbol}: "
                f"low={effective_low}, high={effective_high}")
        self._high = self._low + effective_high
        self._low = self._low + effective_low
        self._flush_common_prefix()
        if self._max_bit > 61:
            raise RuntimeError(f"max_bit too large: {self._max_bit}")

    def _flush_common_prefix(self) -> None:
        while self._max_bit >= 0:
            b1 = (self._low >> self._max_bit) & 1
            b2 = (self._high >> self._max_bit) & 1
            if b1 != b2:
                break
            self._low -= b1 << self._max_bit
            self._high -= b1 << self._max_bit
            self._max_bit -= 1
            self._packer.push(b1)

    def flush(self) -> None:
        while self._max_bit >= 0:
            bit = (self._low >> self._max_bit) & 1
            self._packer.push(bit)
            self._max_bit -= 1
        self._packer.flush()


class ArithmeticDecoder:
    """Range decoder (ArithmeticDecoder.cs:8-233)."""

    def __init__(self, stream, total_range_bits: int = 24):
        if not (0 < total_range_bits <= 30):
            raise ValueError("total_range_bits must be in (0, 30]")
        self.total_range_bits = total_range_bits
        self._unpacker = BitUnpacker(1, stream)
        self._low = 0
        self._high = 0
        self._current = 0
        self._max_bit = -1

    @property
    def delta(self) -> int:
        return self._high - self._low + 1

    def pull(self, quantized_cdf: np.ndarray) -> int | None:
        while self.delta < (1 << self.total_range_bits):
            bit = self._unpacker.pull()
            if bit is None:
                return None
            self._low *= 2
            self._high = self._high * 2 + 1
            self._current = self._current * 2 + bit
            self._max_bit += 1

        scale = self.delta / (1 << self.total_range_bits)

        def search(low_idx: int, high_idx: int):
            if high_idx < low_idx:
                raise RuntimeError("Binary search failed")
            mid = (low_idx + high_idx) // 2
            range_low = int(quantized_cdf[mid - 1]) if mid > 0 else 0
            range_high = int(quantized_cdf[mid]) - 1
            effective_low = int(np.ceil(range_low * scale))
            effective_high = int(np.floor(range_high * scale))
            low = effective_low + self._low
            high = effective_high + self._low
            if low <= self._current <= high:
                return mid, low, high
            if self._current > high:
                return search(mid + 1, high_idx)
            return search(low_idx, mid - 1)

        symbol, self._low, self._high = search(0, len(quantized_cdf) - 1)
        self._flush_common_prefix()
        return symbol

    def _flush_common_prefix(self) -> None:
        while self._max_bit >= 0:
            b1 = (self._low >> self._max_bit) & 1
            b2 = (self._high >> self._max_bit) & 1
            if b1 != b2:
                break
            self._low -= b1 << self._max_bit
            self._high -= b1 << self._max_bit
            self._current -= b1 << self._max_bit
            self._max_bit -= 1
