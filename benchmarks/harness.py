"""The benchmark's harness: finds a cell's files by name, runs its window,
reduces the trace and assembles the result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>
.json``), its driver (``drivers/<driver>.py``), its traffic parameters and
the limits of its correctness check. A per-layer metric is
``metrics/<metric>.py``, whose ``read(trace, ctx)`` returns a number or None
(nothing to read). ``BENCHMARK.json`` at the checkout's root says which
metrics a cell reports. Adding a cell, a configuration or a metric adds
files; nothing here names one.

A driver module defines ``Driver(cell, seed, device)``: set-up in the
constructor (weights, inputs, every shape of the traffic warmed), then
``call(i)`` for the window's i-th closed-loop call, returning
{"requests", "audio_s", "latency_s": [...]}; ``tracing`` is set while the
profiler records a call, and ``traced`` collects what the metric readers
need; ``release()`` frees the program; ``check()`` returns the correctness
checks, each a ``Check``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded by a run (the JAX package
# and JAX itself), compared as whole names: the port's own name begins
# with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralcodecs_tpu")
# the host's kernel and graph launches among the profiler's runtime events
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
SPAN_PREFIX = "bench."
TOP = 10


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_config(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "configs" / f"{name}.json")


def load_cell(name: str, bench: Path = BENCH) -> dict:
    """The workload file of cell ``name`` with its configuration loaded
    under "config_data"."""
    cell = load_json(bench / "workloads" / f"{name}.json")
    cell.update(name=name, bench=bench, config_data=load_config(cell["config"], bench))
    return cell


def load_module(kind: str, name: str, bench: Path = BENCH):
    """``<bench>/<kind>/<name>.py`` imported by its path. A metric named
    ``<quantity>.<cells>`` (one quantity split by the end-to-end metric its
    cells report) is read by ``<quantity>.py`` unless it has a file of its
    own."""
    path = bench / kind / f"{name}.py"
    if not path.exists() and kind == "metrics":
        path = bench / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(cell: dict, bench: Path = BENCH) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) entries of BENCHMARK.json that this cell
    reports: those that list it under "workloads", or list no workloads."""
    spec_path = bench.parent / "BENCHMARK.json"
    spec = load_json(spec_path) if spec_path.exists() else {"end_to_end": [], "per_layer": []}

    def mine(entry):
        return "workloads" not in entry or cell["name"] in entry["workloads"]

    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


@dataclass
class Check:
    """One compared number: passes when it is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    ``seed`` (Algorithm R): the same seed and offers keep the same items."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5A3]))

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Stamps:
    """Seconds of each named phase of a driver's set-up, by the host clock
    (after a device synchronisation where there is a card)."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._last = time.perf_counter()

    def __call__(self, name: str) -> None:
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run's ``seed``."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


def span(on: bool, name: str):
    """A benchmark span in the profiler's timeline while ``on``."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class TraceSummary:
    """What the metric readers read from a traced part of a window: the
    device's operations and the benchmark's spans as (name, start ns, end
    ns), and the host's kernel and graph launches. ``window`` is the
    traced calls' extent, from their "bench.call" spans."""

    def __init__(self, device: list, spans: list, launches: int):
        self.device, self.spans, self.launches = device, spans, launches
        calls = [(s, e) for n, s, e in spans if n == SPAN_PREFIX + "call"]
        self.window = (min(s for s, _ in calls), max(e for _, e in calls)) if calls else (0, 0)

    @classmethod
    def from_profiler(cls, prof) -> "TraceSummary":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, spans, launches = [], [], 0
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if not (e.is_user_annotation() or name.startswith((SPAN_PREFIX, "ProfilerStep"))):
                    device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name in LAUNCH_CALLS:
                launches += 1
        return cls(device, spans, launches)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _blocks(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device's intervals inside the window, as sorted
        disjoint (starts, ends); made once."""
        if getattr(self, "_union", None) is None:
            self._union = self._merge()
        return self._union

    def _merge(self) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.window
        if not self.device:
            return np.zeros(0), np.zeros(0)
        iv = np.array([(s, e) for _, s, e in self.device], dtype=np.float64)
        iv = np.clip(iv, lo, hi)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        block_ends = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
        return starts, block_ends

    def busy_s(self) -> float:
        return float(self.busy_between(*self.window))

    def busy_between(self, lo, hi) -> np.ndarray:
        """Busy device seconds inside each [lo, hi] (arrays of ns)."""
        starts, ends = self._blocks()
        if not len(starts):
            return np.zeros(np.shape(lo))
        cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

        def until(t):
            t = np.asarray(t, dtype=np.float64)
            k = np.searchsorted(starts, t, side="right")
            prev = np.clip(k - 1, 0, None)
            part = np.clip(t - starts[prev], 0, ends[prev] - starts[prev])
            return np.where(k > 0, cum[prev] + part, 0.0)

        return (until(hi) - until(lo)) / 1e9

    def device_s(self, match=None) -> float:
        """Device seconds summed over operations whose name ``match``
        accepts (all by default)."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device
                   if (match is None or match(n)) and e > lo and s < hi) / 1e9

    def span_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == SPAN_PREFIX + name) / 1e9

    def top_ops(self, n: int = TOP) -> list:
        totals: dict[str, float] = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = TOP) -> list:
        """Idle seconds inside the window by the innermost benchmark span
        open at the time ("none" outside every span): the window is cut at
        every span's ends, and each piece's idle time goes to its span."""
        lo, hi = self.window
        cuts = np.unique(np.clip([lo, hi, *(t for _, s, e in self.spans for t in (s, e))],
                                 lo, hi).astype(np.float64))
        b0, b1 = cuts[:-1], cuts[1:]
        idle = (b1 - b0) / 1e9 - self.busy_between(b0, b1)
        mid = (b0 + b1) / 2
        label = np.full(len(mid), -1)
        names: list[str] = []
        # outer spans first, so that inner ones overwrite them
        for name, s, e in sorted(self.spans, key=lambda x: -(x[2] - x[1])):
            if name not in names:
                names.append(name)
            label[(mid > s) & (mid < e)] = names.index(name)
        sums = np.bincount(label + 1, weights=idle, minlength=len(names) + 1)
        out = [["none" if j == 0 else names[j - 1], float(v)] for j, v in enumerate(sums) if v > 0]
        return sorted(out, key=lambda kv: -kv[1])[:n]


def _profiler(device: str, active: int):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=active, repeat=1))


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def p95(values: list[float]) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict | None:
    """Set up, warm, measure for ``seconds`` and check one cell. Returns the
    result line's dict, or None where a forbidden module was loaded (named
    on stderr). ``t0``: the process's start on the perf_counter clock."""
    import torch

    cuda = device != "cpu"
    before_driver = time.perf_counter() - t0
    driver = load_module("drivers", cell["driver"], cell["bench"]).Driver(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.3f} s: start and imports {before_driver:.3f}, " + ", ".join(
        f"{k} {v:.3f}" for k, v in getattr(driver, "setup_phases", {}).items()), file=sys.stderr)

    traced_calls = int(cell.get("traced_calls", 2))
    prof = _profiler(device, traced_calls) if trace else None
    results, i, call_s = [], 0, []
    start = time.perf_counter()
    while i == 0 or time.perf_counter() - start < seconds or (prof is not None and
                                                            i <= traced_calls):
        if prof is not None and i == 0:
            prof.start()
        active = prof is not None and 1 <= i <= traced_calls
        driver.tracing = active
        t_call = time.perf_counter()
        with span(active, "call"):
            results.append(driver.call(i))
        call_s.append(time.perf_counter() - t_call)
        if prof is not None and i <= traced_calls:
            prof.step()
            if i == traced_calls:
                prof.stop()
        i += 1
    window_s = time.perf_counter() - start
    driver.tracing = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    card = power_limit() if cuda else None

    e2e, per_layer = cell_metrics(cell, cell["bench"])
    values = {"audio_s_per_s": sum(r["audio_s"] for r in results) / window_s,
              "peak_gb": peak / 1e9, "setup_s": setup_s}
    latencies = [x for r in results for x in r.get("latency_s", [])]
    if latencies:
        values["request_p95_ms"] = p95(latencies) * 1e3
    metrics, breakdown, dev_extra = {}, None, {}
    if prof is None:
        for m in e2e:
            # "<quantity>.<cells>": the quantity, under a name of its own
            quantity = m["name"].split(".")[0]
            if quantity in values:
                metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}
                if quantity == "request_p95_ms":
                    metrics[m["name"]]["samples"] = len(latencies)
    else:
        summary = TraceSummary.from_profiler(prof)
        del prof   # the profiler's own copy of the events: a Dia call holds ~10^6
        ctx = dict(driver.traced, calls=traced_calls)
        for m in per_layer:
            v = load_module("metrics", m["name"], cell["bench"]).read(summary, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
        dev_extra = {"busy_s": summary.busy_s(), "window_s": summary.window_s}

    driver.release()
    checks = driver.check()
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return None
    correct = bool(checks) and all(c.passed for c in checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.passed else 'FAIL'}", file=sys.stderr)
    result = {
        "correct": correct,
        "attempted": sum(r["requests"] for r in results),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak),
                   **dev_extra, "card": card, "calls": i, "measured_s": window_s,
                   "call_s": [min(call_s), statistics.median(call_s), max(call_s)]},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result
