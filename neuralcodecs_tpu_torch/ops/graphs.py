"""CUDA graphs of the port's fixed-shape step paths.

The JAX package compiles its step paths (Dia's generation loop, Encodec's
streaming pushes, the LM step) into jitted programs. Here the counterpart
is a CUDA graph: the step function is run once eagerly (cuBLAS handles,
cached weight casts and the kernel library exist before capture), captured
once over static buffers, then replayed, so the host's work for a step is
one ``CUDAGraph.replay()`` instead of hundreds of launches.

A step function takes no arguments: it reads and writes tensors that
outlive the graph (the caller copies a session's values in before a replay
and out after), and may return tensors, the graph's outputs, which the next
replay overwrites. Every graph of one model shares one memory pool, so two
of them must never run at once: they are replayed on the current stream,
which orders them (``StaticStep`` also holds a lock around its copies in,
its replay and its copies out, which callers in several threads share).

The kernel wrappers' launch counters count host calls. A capture launches
nothing, so what the capture added to a counter is taken back and added
again at every replay: the counters report the launches the device made.

On a CUDA device the graphed path is the path; a capture or replay that
fails raises. ``graphs_disabled()`` turns graphs off in the whole process
for the block it wraps (the card's gates run the eager steps on the same
weights with it); on the CPU and under tensor parallelism the steps run
eagerly.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

import torch

_disabled = 0
_disabled_lock = threading.Lock()


@contextlib.contextmanager
def graphs_disabled():
    """Run the step paths eagerly inside the block, on every thread."""
    global _disabled
    with _disabled_lock:
        _disabled += 1
    try:
        yield
    finally:
        with _disabled_lock:
            _disabled -= 1


def graphs_enabled(device: torch.device | str) -> bool:
    """Whether the step paths on ``device`` replay graphs: a CUDA device,
    outside ``graphs_disabled()``."""
    return torch.device(device).type == "cuda" and not _disabled


def _counters():
    from neuralcodecs_tpu_torch.ops.kernels import WRAPPERS

    return WRAPPERS


class StepGraph:
    """``fn`` run once eagerly, then captured into one CUDA graph.

    ``generators`` are the ``torch.Generator`` objects ``fn`` draws from:
    each is registered with the graph, so a replay advances its Philox
    offset as an eager call would. ``outputs`` is what ``fn`` returned
    during capture; ``replay()`` refreshes and returns it."""

    def __init__(self, fn, *, pool=None, generators=()):
        fn()  # warm-up: lazy state is made outside the capture
        torch.cuda.synchronize()
        wrappers = _counters()
        before = {name: w.launches for name, w in wrappers.items()}
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool):
            self.outputs = fn()
        # the kernels' launches that one replay makes
        self.launches = {name: w.launches - before[name] for name, w in wrappers.items()
                         if w.launches != before[name]}
        for name, n in self.launches.items():
            wrappers[name].launches -= n
        self.graph = graph
        self.replays = 0

    def replay(self):
        """One replay on the current stream -> ``outputs``."""
        self.graph.replay()
        self.replays += 1
        wrappers = _counters()
        for name, n in self.launches.items():
            wrappers[name].launches += n
        return self.outputs


class StaticStep:
    """``step(*args)`` over static copies of its tensor arguments, for a
    step whose caller owns the state: ``run(args)`` copies every argument
    in, runs the step (the replay of its graph, captured into ``pool``; or
    eagerly with ``pool`` None, the CPU's form of the same copies), copies
    the last ``n_state`` arguments, which the step updates in place, back
    out into the caller's tensors, and returns a clone of the step's output
    (the graph's own is overwritten at the next replay). So callers with
    state of the same shapes (sessions, coders) share one graph and pay no
    capture each."""

    def __init__(self, step, args, n_state: int, pool=None):
        # normal tensors even under inference_mode: callers in other modes
        # and threads copy into them
        with torch.inference_mode(False):
            self.args = [torch.zeros_like(a, memory_format=torch.contiguous_format)
                         for a in args]
        self.n_state = n_state
        self.fn = lambda: step(*self.args)
        self.graph = step_graph(self.fn, pool)
        self.lock = threading.Lock()

    def run(self, args):
        with self.lock:
            for dst, src in zip(self.args, args):
                dst.copy_(src)
            out = self.graph.replay()
            for dst, src in zip(args[len(args) - self.n_state:],
                                self.args[len(args) - self.n_state:]):
                dst.copy_(src)
            return out.clone()


class EagerStep:
    """A ``StepGraph``'s stand-in where nothing is captured (``pool`` None:
    a model on the CPU): ``replay()`` runs ``fn``."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        return self.fn()


def step_graph(fn, pool, generators=()):
    """``fn`` captured into ``pool``, or, with no pool, run as it is."""
    return EagerStep(fn) if pool is None else StepGraph(fn, pool=pool, generators=generators)


class GraphCache:
    """A model's captured programs by key, sharing one memory pool.
    ``clear()`` drops them all (the weights they read changed). On a CUDA
    device each entry's build function captures into the pool; on the CPU
    it gets no pool and builds the same program uncaptured (``EagerStep``,
    ``StaticStep`` without a graph), which is how the CPU tests see the
    static buffers."""

    def __init__(self, device: torch.device | str):
        self.capture = torch.device(device).type == "cuda"
        self.graphs: dict = {}
        self._pool = None
        self._lock = threading.Lock()
        self.capture_s = 0.0

    def get(self, key, build):
        """The entry of ``key``, made at first use by ``build(pool)``, which
        captures its graphs into ``pool`` (a ``StepGraph``, or an object
        holding some). ``capture_s`` sums the builds' seconds, warm-up
        steps included."""
        with self._lock:
            entry = self.graphs.get(key)
            if entry is None:
                if self._pool is None and self.capture:
                    self._pool = torch.cuda.graph_pool_handle()
                t0 = time.perf_counter()
                entry = self.graphs[key] = build(self._pool)
                self.capture_s += time.perf_counter() - t0
            return entry

    def clear(self) -> None:
        with self._lock:
            self.graphs.clear()
            self._pool = None


def flatten(tree) -> tuple[list[torch.Tensor], object]:
    """The tensors of a nest of lists and tuples (None kept as a leaf-free
    slot) -> (leaves, spec) for ``unflatten``."""
    leaves: list[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return "t"
        if node is None:
            return None
        if isinstance(node, (list, tuple)):
            return (type(node), [walk(n) for n in node])
        raise TypeError(f"graph state: cannot flatten {type(node).__name__}")

    return leaves, walk(tree)


def carve(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Views of ``flat`` with ``shapes``, back to back."""
    views, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        views.append(flat[off:off + n].view(shape))
        off += n
    return views


def unflatten(leaves, spec):
    it = iter(leaves)

    def build(s):
        if s == "t":
            return next(it)
        if s is None:
            return None
        kind, children = s
        return kind(build(c) for c in children)

    return build(spec)


def signature(leaves) -> tuple:
    """Shapes and dtypes of tensors: what a graph over them is keyed by."""
    return tuple((tuple(t.shape), t.dtype) for t in leaves)
