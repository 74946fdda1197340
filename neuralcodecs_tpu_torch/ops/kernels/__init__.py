"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""

from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin
from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan
from neuralcodecs_tpu_torch.ops.kernels.resunit import fused_residual_unit

WRAPPERS = {"codebook_argmin": codebook_argmin,
            "fused_residual_unit": fused_residual_unit,
            "lstm_scan": lstm_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
