"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""

from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t
from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin
from neuralcodecs_tpu_torch.ops.kernels.decode_attn import decode_cross_attn, decode_self_attn
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow
from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan
from neuralcodecs_tpu_torch.ops.kernels.resunit import (
    fused_residual_unit,
    fused_residual_unit_dense,
)

WRAPPERS = {"codebook_argmin": codebook_argmin,
            "fused_residual_unit": fused_residual_unit,
            "fused_residual_unit_dense": fused_residual_unit_dense,
            "lstm_scan": lstm_scan,
            "envelope_follow": envelope_follow,
            "biquad_df2t": biquad_df2t,
            "decode_self_attn": decode_self_attn,
            "decode_cross_attn": decode_cross_attn}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
