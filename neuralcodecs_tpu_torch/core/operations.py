"""Operation result plumbing (copy of neuralcodecs_tpu.core.operations).

A tagged enum of codec operation kinds and a small success/error result
record used by event callbacks and batch pipelines.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Generic, TypeVar

T = TypeVar("T")


class CodecOperation(enum.Enum):
    """Operation kinds reported through progress/error events
    (CodecOperation.cs:7-28)."""

    INITIALIZATION = "initialization"
    ENCODING = "encoding"
    DECODING = "decoding"
    MODEL_LOADING = "model_loading"


@dataclass(frozen=True)
class OperationResult(Generic[T]):
    """Success/error wrapper (OperationResult.cs:8-40)."""

    success: bool
    result: T | None = None
    error: Exception | None = None
    message: str = ""

    @classmethod
    def from_success(cls, result: T) -> "OperationResult[T]":
        return cls(success=True, result=result)

    @classmethod
    def from_error(cls, error: Exception) -> "OperationResult[T]":
        cause = getattr(error, "__cause__", None)
        msg = str(error) if cause is None else f"{error} {cause}"
        return cls(success=False, error=error, message=msg)
