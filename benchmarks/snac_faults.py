"""Faults planted in the program's SNAC underneath a run, for the tests that
see a SNAC cell's ``correct`` come out false
(``tests/test_bench_snac.py``), and the readings of a fault at a cell's own
size:

    python3 benchmarks/snac_faults.py --workload <cell> --seeds 1,2 --fault noise

Faults: a scale's codes of one clip altered (``stage_codes``), the first
half's answers given to the second half (``half_batch``), a clip's audio
altered (``audio``), and the decoder's noise left out (``noise``: no
generator, so each noise block is the identity). A one-chip cell has no
exchange between chips to leave out. The readings print one JSON line a
seed, as ``control.py``'s, for the program with the fault planted.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

FAULTS = ("stage_codes", "half_batch", "audio", "noise")


@contextlib.contextmanager
def planted(fault: str):
    """The program's SNAC with ``fault`` planted, restored on exit."""
    from neuralcodecs_tpu_torch.models.snac.model import SNAC

    if fault not in FAULTS:
        raise ValueError(f"no SNAC fault {fault!r}")
    name = "_noise_generator" if fault == "noise" else "_forward_fn"
    saved = getattr(SNAC, name)

    def broken(self, audio, generator):
        out, codes = saved(self, audio, generator)
        if fault == "stage_codes":
            codes[1][0] = (codes[1][0] + 1) % self.config.codebook_size
        elif fault == "half_batch":
            half = out.shape[0] // 2
            for c in codes:
                c[half:] = c[:half]
            out[half:] = out[:half]
        elif fault == "audio":
            out[0] *= 1.01
        return out, codes

    setattr(SNAC, name, (lambda self, generator: None) if fault == "noise" else broken)
    try:
        yield
    finally:
        setattr(SNAC, name, saved)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault", required=True, choices=FAULTS)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from benchmarks import harness
    from benchmarks.run import ENV

    os.environ.update({k: str(v) for k, v in ENV.items()})
    cell = harness.load_cell(args.workload)
    driver = harness.load_module("drivers", cell["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.fault):
            got = driver.readings(cell, seed, args.device)
        line = json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                           **{side: {c.name: c.value for c in checks}
                              for side, checks in got.items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
