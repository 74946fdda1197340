"""Diagnostics: tensor stats, timing scopes, anomaly detection, dumps.

Counterpart of neuralcodecs_tpu.diagnostics (the reference's
NeuralCodecs.Diagnostics: DiagnosticsContext, TensorLogger / TensorSaver /
TensorComparison, null-object pattern). ``profiler`` holds the trace and
NaN-guard helpers and the port's span recorder (``span``,
``recorded_spans``: spans at Dia's and DAC's layer boundaries, recorded
while a profiler records, which the benchmark's per-layer metrics read);
``xplane`` sums the device time by op of the Chrome traces that
``profiler.trace`` writes (the JAX package's reader of ``jax.profiler``'s
XSpace files).
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
