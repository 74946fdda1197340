"""Codebook argmin: the CUDA kernel csrc/codebook.cu and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/codebook.py:l2_argmin_pallas. On the
H100 the search is bound by operations, not bytes (D = 8: one FMA per
codebook element per row); the kernel keeps each row in registers and the
staged codebook in shared memory and never writes the [T, N] score matrix
(see the header of csrc/codebook.cu).

``codebook_argmin`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, or an error. ``codebook_argmin.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from neuralcodecs_tpu_torch.ops.kernels.build import check, device_and_stream, load_library


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
    if flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"codebook_argmin: D mismatch {flat.shape[1]} != "
                         f"{codebook.shape[1]}")


def codebook_argmin(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """flat [T, D], codebook [N, D] f32 -> int32 [T] nearest-entry codes."""
    if flat.device.type == "cpu" and codebook.device.type == "cpu":
        return codebook_argmin_plain(flat, codebook)
    _check_inputs(flat, codebook)
    lib = load_library()
    t, d = flat.shape
    out = torch.empty(t, dtype=torch.int32, device=flat.device)
    rc = lib.nc_codebook_argmin_f32(flat.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                                    t, codebook.shape[0], d, *device_and_stream(flat))
    check(rc, "nc_codebook_argmin_f32")
    codebook_argmin.launches += 1
    return out


codebook_argmin.launches = 0
