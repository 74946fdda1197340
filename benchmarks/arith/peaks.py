"""Published peaks of one NVIDIA H100 SXM and the roofline bound.

NVIDIA's data sheet, dense rates without sparsity, at the full 700 W power
limit. A card set below it runs slower under load, so every result line
carries the card's power limit beside the shares computed from these.

``bound`` is a copy of chip_smoke.py's: the least time the card could take
for work of ``flops`` operations at ``peak`` per second that must move
``nbytes`` (each input read once, each output written once).
"""

from __future__ import annotations

F32_FLOPS = 67e12     # float32 outside the tensor cores
TF32_FLOPS = 495e12   # TF32 on the tensor cores (3xTF32 makes three passes)
BF16_FLOPS = 989e12   # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

PEAKS = {"float32": F32_FLOPS, "tf32": TF32_FLOPS, "bfloat16": BF16_FLOPS}


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS) -> dict:
    """{"bound_s", "bound_by"}: the larger of flops / peak and nbytes / HBM
    bandwidth, and which of the two sets it."""
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
