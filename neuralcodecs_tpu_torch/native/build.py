"""Build the native range coder (entropy.cpp) with g++ and load it with ctypes.

Counterpart of neuralcodecs_tpu.native.build. The library is compiled at
first use, never at import, into the git-ignored
``neuralcodecs_tpu_torch/_build/`` beside the CUDA kernels, named by a hash
of the source and flags, so an unchanged tree reuses it. A failed build
raises NativeBuildError: nothing falls back to the Python coder, which is
about 100 times slower and would hide the failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from neuralcodecs_tpu_torch.core.exceptions import NativeBuildError
from neuralcodecs_tpu_torch.ops.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "entropy.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # cdfs [n, card] int64, symbols [n] int32, n, card, range bits, out, out_cap
    "nc_ac_encode": ([_P, _P, _L, _I, _I, _P, _L], _L),
    # data, size, range bits -> handle
    "nc_ad_new": ([_P, _L, _I], _P),
    # handle, cdf [card] int64, card -> symbol, -1 at the end, -2 on failure
    "nc_ad_pull": ([_P, _P, _I], _I),
    # handle, cdfs [count, card], count, card, out symbols -> decoded count
    "nc_ad_pull_many": ([_P, _P, _I, _I, _P], _I),
    "nc_ad_free": ([_P], None),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libncentropy_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise NativeBuildError(f"g++ could not build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each install a whole library


def entropy_lib() -> ctypes.CDLL:
    """Compile (if needed) and load the range coder; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise NativeBuildError(f"cannot load {path}: {exc}") from exc
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib
