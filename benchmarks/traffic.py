"""The one traffic generator: turns a workload file's ``traffic`` parameters
and a run's seed into the requests the drivers send.

The seed sets content only: which clip content, which texts in which order,
which sampling seed a call takes. The sizes of the work (clip lengths,
batch, token counts) come from the parameters alone, so every seed sends
the same amount of work in another order or with other values.

``clip_seconds`` is a number (every clip that long) or
{"lognormal_quantiles": n, "median": m, "sigma": s, "min": a, "max": b}:
the n quantiles at (i + 1/2) / n of a log-normal of median m and shape s,
clipped to [a, b], shortest first; request i takes the (i mod n)-th.
"""

from __future__ import annotations

import math
import statistics

import numpy as np


def clip_lengths(traffic: dict, sample_rate: int) -> list[int]:
    """Clip lengths in samples, one a pool entry."""
    spec = traffic["clip_seconds"]
    if isinstance(spec, (int, float)):
        seconds = [float(spec)] * int(traffic.get("pool", 1))
    else:
        n = int(spec["lognormal_quantiles"])
        normal = statistics.NormalDist()
        seconds = [min(max(spec["median"] * math.exp(spec["sigma"] * normal.inv_cdf((i + 0.5) / n)),
                           spec["min"]), spec["max"]) for i in range(n)]
    return [int(round(s * sample_rate)) for s in seconds]


def make_clips(lengths: list[int], batch: int, sample_rate: int, seed: int,
               device) -> list[np.ndarray]:
    """One host array [batch, length] a pool entry: three tones of random
    pitch, level and phase over noise of random level, one stretch of
    silence of up to 30% of the clip, clipped to [-1, 1]. Made on
    ``device`` by one torch.Generator, then copied to host memory (where a
    server's requests arrive)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    clips = []
    for n in lengths:
        t = torch.arange(n, device=device, dtype=torch.float64) / sample_rate
        p = torch.rand((batch, 12), generator=gen, device=device, dtype=torch.float64)
        freq = 60.0 * (6000.0 / 60.0) ** p[:, 0:3]
        amp = 0.05 + 0.25 * p[:, 3:6]
        phase = 2 * math.pi * p[:, 6:9]
        x = torch.sum(amp[:, :, None] * torch.sin(2 * math.pi * freq[:, :, None] * t
                                                  + phase[:, :, None]), dim=1).float()
        noise = torch.randn((batch, n), generator=gen, device=device)
        x = x + noise * (0.005 + 0.045 * p[:, 9:10].float())
        start = (p[:, 10] * n).long()
        width = (p[:, 11] * 0.3 * n).long()
        idx = torch.arange(n, device=device)
        silent = (idx >= start[:, None]) & (idx < (start + width)[:, None])
        clips.append(torch.clamp(torch.where(silent, 0.0, x), -1.0, 1.0).cpu().numpy())
    return clips


def text_order(traffic: dict, seed: int) -> list[str]:
    """The workload's texts in an order drawn from the seed; call i takes
    the next ``batch`` of them, cyclically."""
    texts = traffic["texts"]
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7E7])).permutation(
        len(texts))
    return [texts[j] for j in order]
