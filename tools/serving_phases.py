"""Run chip_smoke.py's serving phases alone, on the models they serve.

    python3 tools/serving_phases.py [--out serving.json]

Needs one CUDA card and nvcc. Builds the kernels, loads SNAC-24k,
Encodec-24k and DAC-44k from their exports and puts the 24 kHz LM in the
model cache (chip_smoke.phase_loader, phase_lm_cache), then runs
phase_snac_http, phase_encodec_http and phase_dac_http; then exports and
loads Dia 1.6B with the DAC-44k vocoder (_dia_from_export) and runs
phase_dia_http. Each phase holds every reply to the direct model call and
counts its kernels' launches, as in the whole smoke; each prints its
routes' client-side and /metrics latencies. Exits non-zero at the first
failed phase.
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
    parser.add_argument("--out", help="write each phase's results here (JSON)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("serving_phases: no CUDA device available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    t0 = time.time()
    res = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        info = cs.phase_device()
        cs.phase_build()
        card = info["smi"]
        model, enc, dac, dac_dir, _ = cs.phase_loader(tmp, card)
        res["snac_http"] = cs.phase_snac_http(model, card)
        cs.phase_lm_cache(enc, tmp, card)
        res["encodec_http"] = cs.phase_encodec_http(enc, card)
        res["dac_http"] = cs.phase_dac_http(dac, card)
        del model, enc, dac
        torch.cuda.empty_cache()
        dia, _ = cs._dia_from_export(tmp, card)
        dia.load_dac_model(str(dac_dir))
        res["dia_http"] = cs.phase_dia_http(dia, card)
    res["seconds"] = time.time() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    print(f"serving phases done in {res['seconds']:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
