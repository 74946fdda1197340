"""Exception hierarchy of the port (counterpart of neuralcodecs_tpu.core.exceptions)."""

from __future__ import annotations


class NeuralCodecError(Exception):
    """Root of the framework's exception hierarchy."""


class LoadError(NeuralCodecError):
    """Raised when a model or weight file cannot be loaded."""

    def __init__(self, message: str, source: str | None = None):
        self.source = source
        super().__init__(message if source is None else f"{message} (source={source})")


class CacheError(NeuralCodecError):
    """Raised on model-cache failures (corruption, IO, eviction races)."""


class ConfigurationError(NeuralCodecError):
    """Raised when a model config is missing, malformed, or inconsistent."""


class CodecError(NeuralCodecError):
    """Raised when encode/decode fails at runtime (bad shapes, streams...)."""


class RepositoryError(LoadError):
    """Raised when a remote repository (HF / GitHub / direct URL) fails."""


class ValidationError(NeuralCodecError):
    """Raised when a loaded model fails its post-load validation gate."""


class KernelBuildError(NeuralCodecError):
    """Raised when the CUDA kernels cannot be compiled or loaded."""


class NativeBuildError(NeuralCodecError):
    """Raised when the native (C++) range coder cannot be compiled or loaded."""
