"""Codebook argmin: the CUDA kernel csrc/codebook.cu and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/codebook.py:l2_argmin_pallas. On the
H100 the search is small: its inputs stay in L2 and its products take a
few µs. The kernel splits the codebook across a thread-block cluster of up
to 8 blocks, each staging only its slice (coalesced) and scoring it for a
tile of rows; the blocks merge their (min, index) pairs through distributed
shared memory, so the [T, N] score matrix is never written. D in {4, 8,
12, 16} runs on f32 FMAs, D in {32, 64, 128} on the tensor cores in 3xTF32
(see the header of csrc/codebook.cu).

``codebook_argmin`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, or an error. ``codebook_argmin.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from neuralcodecs_tpu_torch.ops.kernels.build import check, device_and_stream, load_library

KERNEL_DIMS = (4, 8, 12, 16, 32, 64, 128)  # the widths D the kernel takes


def codebook_argmin_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """flat [T, D], codebook [N, D] f32 -> int32 [T]: argmin of ‖e‖² − 2·x·e,
    lowest index on ties."""
    e_sq = torch.sum(codebook * codebook, dim=-1)
    cross = flat @ codebook.t()
    scores = e_sq[None, :] - 2.0 * cross
    return torch.argmin(scores, dim=-1).to(torch.int32)


def _check_inputs(flat: torch.Tensor, codebook: torch.Tensor) -> None:
    for name, t in (("flat", flat), ("codebook", codebook)):
        if t.device.type != "cuda":
            raise ValueError(f"codebook_argmin: {name} on {t.device}, want cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"codebook_argmin: {name} is {t.dtype}, want float32")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"codebook_argmin: {name} must be 2-D contiguous, "
                             f"got {tuple(t.shape)}")
    if codebook.device != flat.device:
        raise ValueError("codebook_argmin: flat and codebook on different devices")
    d = flat.shape[1]
    if d != codebook.shape[1]:
        raise ValueError(f"codebook_argmin: D mismatch {d} != {codebook.shape[1]}")
    if d not in KERNEL_DIMS or codebook.shape[0] == 0:
        raise ValueError(f"codebook_argmin: the kernel takes N >= 1 and D in {KERNEL_DIMS}, "
                         f"got N = {codebook.shape[0]}, D = {d}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where a view left it off the 16 bytes the kernel's
    vector loads need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def codebook_argmin(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """flat [T, D], codebook [N, D] f32 -> int32 [T] nearest-entry codes."""
    if flat.device.type == "cpu" and codebook.device.type == "cpu":
        return codebook_argmin_plain(flat, codebook)
    _check_inputs(flat, codebook)
    flat, codebook = _aligned(flat), _aligned(codebook)
    lib = load_library()
    t, d = flat.shape
    out = torch.empty(t, dtype=torch.int32, device=flat.device)
    rc = lib.nc_codebook_argmin_f32(flat.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                                    t, codebook.shape[0], d, *device_and_stream(flat))
    check(rc, "nc_codebook_argmin_f32")
    codebook_argmin.launches += 1
    return out


codebook_argmin.launches = 0
