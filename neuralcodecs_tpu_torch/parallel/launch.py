"""Run a function on several local ranks, one process each.

``run_local(fn, nprocs, args)`` starts ``nprocs`` processes with the
``spawn`` start method (a parent that holds a CUDA context cannot fork), has
each join one process group through ``initialize_distributed`` and call
``fn(rank, *args)``, and returns the ranks' results in rank order. ``fn``
must be importable by name (a module's top-level function) and its results
picklable (numpy arrays, not tensors: a tensor crosses by shared
memory, which is gone once its rank exits). A rank that raises fails the
call with its traceback; the other ranks are then stopped, since they may
be waiting in a collective for it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable


def _rank_main(rank: int, fn: Callable, nprocs: int, init_method: str, args: tuple,
               results) -> None:
    import torch.distributed as dist

    from neuralcodecs_tpu_torch.parallel.mesh import initialize_distributed

    try:
        initialize_distributed(init_method, nprocs, rank)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, nprocs: int, args: tuple = (), init_method: str | None = None,
              timeout: float = 600.0) -> list[Any]:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each in its own
    process. ``init_method`` defaults to a file rendezvous in a temporary
    directory (no port to pick). Raises RuntimeError when a rank fails or
    the ranks outlast ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = init_method or f"file://{Path(tmp) / 'rdzv'}"
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, fn, nprocs, init_method, args, results))
                 for rank in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got: dict[int, Any] = {}
        failures: list[str] = []
        try:
            while len(got) + len(failures) < nprocs:
                remaining = deadline - time.monotonic()
                try:
                    rank, ok, out = results.get(timeout=max(remaining, 0.1))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if remaining <= 0 or dead:
                        failures.append(f"ranks timed out or died (exit codes "
                                        f"{[p.exitcode for p in procs]})")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    failures.append(f"rank {rank} failed:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not failures else 5)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        if failures:
            raise RuntimeError("\n".join(failures))
    return [got[rank] for rank in range(nprocs)]
