"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks for.
One process: set-up (weights and inputs from the seed, every shape of the
cell's traffic warmed), a closed-loop window of ``--seconds``, then the
check of the window's outputs against the plain reference. With
``--trace 1`` the first calls of the window after one warm-up call run
under torch.profiler, summarised in memory into the cell's per-layer
metrics; otherwise the result holds its end-to-end metrics. The compared
numbers and their limits go to standard error as its last lines; the last
line of standard output is the result, one JSON object. Exits 2 without
enough CUDA devices, 3 where a forbidden module (JAX, the JAX package) was
loaded; neither prints a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, set before
# torch loads; transformers, should anything load it, is told to leave JAX
CACHE = ROOT / "_bench_cache"
ENV = {"TRITON_CACHE_DIR": CACHE / "triton", "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
       "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor", "CUDA_CACHE_PATH": CACHE / "nv",
       "USE_FLAX": "0"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.update({k: str(v) for k, v in ENV.items()})
    sys.path.insert(0, str(ROOT))
    from benchmarks import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
