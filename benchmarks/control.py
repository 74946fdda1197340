"""The readings that a cell's correctness limits are set from.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 [--out FILE]
        [--fault NAME | --int8]

For each seed: the numbers the cell's check compares, once for the program
(its set-up and calls at the cell's own sizes, untimed) and once for the
control, the plain reference computed one step below the configuration's
precision in the program's place (the driver's ``readings``). With
``--fault``, the program runs with that fault of ``faults.py`` planted;
with ``--int8`` (Dia), on its own int8 weight path. One JSON line a seed on
standard output (and appended to ``--out``). Runs on the card; the
benchmark's own runs never run it.
"""

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    parser.add_argument("--fault")
    parser.add_argument("--int8", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmarks import faults, harness
    from benchmarks.run import ENV

    os.environ.update({k: str(v) for k, v in ENV.items()})
    cell = harness.load_cell(args.workload)
    driver = harness.load_module("drivers", cell["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        kind = "tts" if cell["driver"] == "tts_generate" else "codec"
        extra = {"int8": True} if args.int8 else {}
        with faults.planted(kind, args.fault) if args.fault else contextlib.nullcontext():
            got = driver.readings(cell, seed, args.device, **extra)
        line = json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                           "int8": args.int8, **{
            side: {c.name: c.value for c in checks} for side, checks in got.items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
