"""ctypes bindings of the native range coder (native/entropy.cpp).

Counterpart of neuralcodecs_tpu.native.entropy_native without its Python
fallback: a coder that cannot be built raises (native/build.py). The plain
versions, ``ArithmeticCoder`` and ``ArithmeticDecoder`` in
models/encodec/entropy.py, write and read the same bytes.
"""

from __future__ import annotations

import numpy as np

from neuralcodecs_tpu_torch.native.build import entropy_lib


def encode_symbols(cdfs: np.ndarray, symbols: np.ndarray,
                   total_range_bits: int = 24) -> bytes:
    """Range-encode symbols[i] against cdfs[i] ([N, card] int64) in one call."""
    cdfs = np.ascontiguousarray(cdfs, np.int64)
    symbols = np.ascontiguousarray(symbols, np.int32)
    n, card = cdfs.shape
    if symbols.shape != (n,):
        # the C loop reads symbols[0..n): a shorter array would be read out
        # of bounds
        raise ValueError(f"encode_symbols: {symbols.shape[0]} symbols for {n} cdf rows")
    if n and (symbols.min() < 0 or symbols.max() >= card):
        raise ValueError(f"encode_symbols: a symbol outside [0, {card})")
    lib = entropy_lib()
    out_cap = max(1024, n * card.bit_length())  # generous upper bound
    out = np.empty(out_cap, np.uint8)
    written = lib.nc_ac_encode(cdfs.ctypes.data, symbols.ctypes.data, n, card,
                               total_range_bits, out.ctypes.data, out_cap)
    if written < 0:
        raise RuntimeError(f"native range coder failed: {written}")
    return out[:written].tobytes()


class NativeArithmeticDecoder:
    """Stateful decoder over a byte buffer (the C++ handle API)."""

    def __init__(self, data: bytes, total_range_bits: int = 24):
        self._handle = None
        self._lib = entropy_lib()
        arr = np.frombuffer(data, np.uint8)
        self._handle = self._lib.nc_ad_new(arr.ctypes.data, len(arr), total_range_bits)

    def pull(self, cdf: np.ndarray) -> int | None:
        """One symbol, or None at the end of the stream."""
        cdf = np.ascontiguousarray(cdf, np.int64)
        symbol = self._lib.nc_ad_pull(self._handle, cdf.ctypes.data, len(cdf))
        if symbol == -1:
            return None
        if symbol < 0:
            raise RuntimeError(f"native decoder failed: {symbol}")
        return symbol

    def pull_many(self, cdfs: np.ndarray) -> np.ndarray:
        """Decode len(cdfs) symbols in one native call (cdfs [N, card])."""
        cdfs = np.ascontiguousarray(cdfs, np.int64)
        n, card = cdfs.shape
        out = np.empty(n, np.int32)
        got = self._lib.nc_ad_pull_many(self._handle, cdfs.ctypes.data, n, card,
                                        out.ctypes.data)
        if got < n:
            raise RuntimeError("stream ended during native decode")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.nc_ad_free(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeArithmeticDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
