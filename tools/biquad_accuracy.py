"""The biquad-cascade kernel's accuracy against the plain loop's, over seeds,
on the CPU.

    python3 tools/biquad_accuracy.py [--seeds 0:10] [--rows 4] [--T 240000] [--chunk 1024]

Runs the K-weighting cascade over ``rows`` rows of 0.25-sigma noise per
seed three ways: the plain f32 loop (ops/kernels/biquad.py,
biquad_cascade_plain), the kernel's chunked arithmetic emulated in PyTorch
(biquad_cascade_chunked: f64 chunk end states and carry, the loop's f32
step within each chunk), and the exact filter (scipy's lfilter in f64 with
the f32 coefficients). Prints, per seed, each one's max error against the
exact filter and their ratio, the quantity chip_smoke.py gates at 1.5 on
the card; then the ratio's spread over the seeds. The emulation equals the
kernel on the card bit for bit where checked (tools/row_scan_ablate.py
prints that check), so this is the kernel's accuracy on other data. A seed
takes ~30 s at T = 240 000 (the plain loop).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.signal import lfilter

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neuralcodecs_tpu_torch.dsp import loudness  # noqa: E402
from neuralcodecs_tpu_torch.ops.kernels import biquad as bq  # noqa: E402

K_WEIGHTING = [(loudness._HIGH_SHELF_B, loudness._HIGH_SHELF_A),
               (loudness._HIGH_PASS_B, loudness._HIGH_PASS_A)]


def exact(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float64)
    for b0, b1, b2, a1, a2 in bq.section_coefs(K_WEIGHTING):
        y = lfilter([b0, b1, b2], [1.0, a1, a2], y, axis=-1)
    return y


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0:10", help="first:last (exclusive)")
    parser.add_argument("--rows", type=int, default=4)
    parser.add_argument("--T", type=int, default=240_000)
    parser.add_argument("--chunk", type=int, default=bq.CHUNK)
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split(":"))
    ratios = []
    for seed in range(first, last):
        rng = np.random.default_rng(seed)
        x = (0.25 * rng.standard_normal((args.rows, args.T))).astype(np.float32)
        ref = exact(x)
        plain = bq.biquad_cascade_plain(torch.from_numpy(x), K_WEIGHTING).numpy()
        chunked = bq.biquad_cascade_chunked(torch.from_numpy(x), K_WEIGHTING, args.chunk).numpy()
        e_plain = float(np.abs(plain - ref).max())
        e_chunked = float(np.abs(chunked - ref).max())
        ratios.append(e_chunked / e_plain)
        print(f"seed {seed}: max error vs f64: plain loop {e_plain:.4e}, chunked {e_chunked:.4e}, "
              f"ratio {ratios[-1]:.3f}", flush=True)
    r = np.array(ratios)
    print(f"{len(r)} seeds, {args.rows} x {args.T}, chunk {args.chunk}: ratio min {r.min():.3f} "
          f"median {np.median(r):.3f} max {r.max():.3f} sd {r.std():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
