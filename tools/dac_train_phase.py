"""Run chip_smoke.py's DAC training phase alone.

    python3 tools/dac_train_phase.py [--out train.json]

Needs one CUDA card and nvcc. Builds the kernels, holds kernel 2b's
inference form against the plain chain at a seeded DAC-44k's 24 unit shapes
of a 10 s stream (chip_smoke.phase_resunit_dense, with its time), then runs
chip_smoke.phase_dac_train: full-width DAC-44k GAN and generator steps at
8 x 0.5 s with the kernels against the plain versions, their timing,
launches, profile and peak memory, kernel 2b's training form and backward
at the batch's unit shapes, and the kernels without a backward raising
under grad. Exits non-zero at the first failed phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the phases' results here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dac_train_phase: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    t0 = time.time()
    res = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        info = cs.phase_device()
        res["build"] = cs.phase_build()
        gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
        from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

        dac = DAC(DACConfig(), device=cs.DEVICE, seed=cs.SEED)
        res["resunit_dense"] = cs.phase_resunit_dense(dac, gen)
        del dac
        res["dac_train"] = cs.phase_dac_train(Path(tmp_dir), info["smi"], gen)
        res["device"] = info
    res["seconds"] = time.time() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    print(f"dac training phase done in {res['seconds']:.1f} s on {info['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
