"""Retry with exponential backoff for network operations (copy of
neuralcodecs_tpu.core.retry)."""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


def with_retry(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 1.0,
    max_delay: float = 30.0,
    retry_on: tuple[type[BaseException], ...] = (OSError, IOError),
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> T:
    """Call ``fn`` up to ``attempts`` times with exponential backoff."""
    last: BaseException | None = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as exc:  # noqa: PERF203 — retry loop
            last = exc
            if attempt == attempts - 1:
                break
            if on_retry is not None:
                on_retry(attempt + 1, exc)
            time.sleep(min(base_delay * (2**attempt), max_delay))
    assert last is not None
    raise last
