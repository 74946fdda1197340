"""Diagnostics: tensor stats, timing scopes, anomaly detection, dumps.

Counterpart of neuralcodecs_tpu.diagnostics (the reference's
NeuralCodecs.Diagnostics: DiagnosticsContext, TensorLogger / TensorSaver /
TensorComparison, null-object pattern). ``profiler`` holds the trace,
annotation and NaN-guard helpers; the JAX package's ``xplane`` reader has
no counterpart here (``torch.profiler`` writes Chrome traces).
"""

from neuralcodecs_tpu_torch.diagnostics.context import (
    DiagnosticsContext,
    NullDiagnosticsContext,
    TensorStats,
    compare_tensors,
    get_diagnostics,
    set_diagnostics,
)

__all__ = [
    "DiagnosticsContext",
    "NullDiagnosticsContext",
    "TensorStats",
    "compare_tensors",
    "get_diagnostics",
    "set_diagnostics",
]
