"""Build the port's CUDA kernels into one shared library, loaded with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into a shared
library with a plain C interface, at first use, never at import. The
library lands in ``neuralcodecs_tpu_torch/_build/`` (ignored by git), named
by a hash of the sources and flags, so an unchanged tree reuses it and a
changed one rebuilds. Sources that include PyTorch's headers take minutes
to compile; these include only the CUDA runtime and build in seconds.

A failed build raises KernelBuildError: no wrapper falls back to its plain
version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from neuralcodecs_tpu_torch.core.exceptions import KernelBuildError

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: each returns cudaGetLastError() after its launch
_SIGNATURES = {
    # x, codebook, out, T, N, D, device, stream
    "nc_codebook_argmin_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, alpha1, w_dil, b_dil, alpha2, w1_big, w1_small, b_pw, y (scratch), out, B, C, T,
    # dilation, device, stream; W1 split and re-laid by resunit.pack_pointwise_weights
    "nc_resunit_depthwise_f32": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    # x, alpha1, wd_big, wd_small, b_dil, alpha2, w1_big, w1_small, b_pw, y (scratch),
    # out, B, C, T, dilation, device, stream; the weights split and re-laid by
    # resunit.pack_dense_weights
    "nc_resunit_dense_f32": [_P] * 11 + [_I, _I, _I, _I, _I, _P],
    # the training form: nc_resunit_dense_f32's arguments with h, z (kept for the
    # backward) before y, which is kept too
    "nc_resunit_dense_train_f32": [_P] * 13 + [_I, _I, _I, _I, _I, _P],
    # gates_x, w_hh, h0, c0, ys, h_f, c_f, T, B, H, device, stream
    "nc_lstm_scan_f32": [_P] * 7 + [_I, _I, _I, _I, _P],
    # B, H, device, out[3] (launches nothing)
    "nc_lstm_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    # x, env, N, T, attack, release, device, stream
    "nc_envelope_f32": [_P, _P, _I, _I, _F, _F, _I, _P],
    # x, y, e (f64 scratch), s (f32 scratch), N, T, L, S, coefs[5 S] (host f32),
    # phi[2S x 2S] (host f64), device, stream
    "nc_biquad_cascade_f32": [_P] * 4 + [_I] * 4 + [_P, _P, _I, _P],
    # dtype, q, k_new, v_new, k_cache, v_cache, pos, pos_stride, step, timescale, out,
    # part, ml (scratch), B, maxT, Nq, Nkv, Dh, chunks, device, stream
    "nc_decode_attn_self": [_I] + [_P] * 6 + [_L] + [_P] * 5 + [_I] * 7 + [_P],
    # dtype, q, k_cache, v_cache, mask, mask_stride, pos, pos_stride, timescale, out, B, S,
    # Nq, Nkv, Dh, device, stream
    "nc_decode_attn_cross": [_I] + [_P] * 4 + [_L, _P, _L, _P, _P] + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report) of the last build


def sources() -> list[Path]:
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnctorch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [s for s in sources() if s.suffix == ".cu"]
    objs = [out.with_suffix(f".{s.stem}.{tag}.o") for s in cu]
    tmp = out.with_suffix(f".{tag}")
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o),
                               str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [s.name for s, p in zip(cu, procs) if p.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    build_log = "".join(logs)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed ({failed or 'link'}):\n{build_log}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def sass_counts(kernel: str, opcodes: tuple[str, ...] = ("HGMMA", "HMMA")) -> dict:
    """{function: {opcode: count}} over the built library's SASS
    (``cuobjdump -sass``) for every function whose name holds ``kernel``:
    shows whether a kernel runs on the tensor cores."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library_path())], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = counts.setdefault(name, dict.fromkeys(opcodes, 0)) if kernel in name else None
        elif current is not None:
            for op in opcodes:
                if f" {op}." in line or f" {op} " in line:
                    current[op] += 1
    return counts


def device_and_stream(t) -> tuple[int, int]:
    """(device index, raw handle of torch's current stream) for a CUDA tensor:
    the kernels launch on the stream torch is using for that device."""
    import torch

    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward that the kernel ``name``
    lacks: grad mode on and an input that requires grad. The kernel's output
    would carry no grad_fn and cut the graph without a word (a Pallas call
    without a custom_vjp cannot be differentiated either)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; run it under "
                           "torch.no_grad() or on inputs that do not require grad")


def check_rows(x, name: str) -> None:
    """Raise unless x is what the per-row recurrence kernels take: a
    non-empty contiguous f32 [N, T] CUDA tensor."""
    import torch

    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}, want cuda")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x is {x.dtype}, want float32")
    if x.dim() != 2 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be non-empty contiguous [N, T], got "
                         f"{tuple(x.shape)}")
