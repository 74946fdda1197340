"""Operations and bytes of a DAC round trip, from the configuration's shapes.

A configuration is the dict of ``configs/<name>.json``. Lengths are in
samples (``t``) or frames (``f``, one frame a hop); ``batch`` is the
number of streams. FLOPs count two a multiply-add of every convolution
and projection; the Snake activations, tanh and norms are left out (a few
operations an element, under a tenth of a percent).

Kernel 2b (the dense residual unit) computes, a unit at C channels over T
steps, a dilated 7-tap C x C conv and a 1 x 1 C x C conv: 16 B T C^2
operations. It runs them as three TF32 passes on the tensor cores
(3xTF32), so its bound counts three times those operations at the TF32
peak; its bytes are x read and out written once, and the unit's weights.
"""

from __future__ import annotations

import math

from benchmarks.arith.peaks import TF32_FLOPS, bound

UNIT_TAPS = 7
UNIT_DILATIONS = (1, 3, 9)
TF32_PASSES = 3


def hop(cfg: dict) -> int:
    return math.prod(cfg["encoder_rates"])


def latent_dim(cfg: dict) -> int:
    return cfg.get("latent_dim") or cfg["encoder_dim"] * 2 ** len(cfg["encoder_rates"])


def padded(cfg: dict, samples: int) -> int:
    """The input length the model runs on: ``samples`` padded to the hop."""
    return -(-samples // hop(cfg)) * hop(cfg)


def encoder_units(cfg: dict, t: int) -> list[tuple[int, int, int]]:
    """(C, T, dilation) of every residual unit of the encoder on a padded
    input of ``t`` samples: block i runs its units at encoder_dim 2^i
    channels before its strided conv."""
    out, dim = [], cfg["encoder_dim"]
    for rate in cfg["encoder_rates"]:
        out += [(dim, t, d) for d in UNIT_DILATIONS]
        dim, t = dim * 2, t // rate
    return out


def decoder_units(cfg: dict, f: int) -> list[tuple[int, int, int]]:
    """(C, T, dilation) of every residual unit of the decoder on ``f``
    frames: block i upsamples by its rate to decoder_dim / 2^(i+1)
    channels, then runs its units."""
    out, t = [], f
    for i, rate in enumerate(cfg["decoder_rates"]):
        t *= rate
        out += [(cfg["decoder_dim"] >> (i + 1), t, d) for d in UNIT_DILATIONS]
    return out


def unit_flops(c: int, t: int, batch: int) -> float:
    return 2.0 * batch * t * c * c * (UNIT_TAPS + 1)


def unit_bytes(c: int, t: int, batch: int) -> float:
    """x read, out written, the two C x C weights and four C-vectors, f32."""
    return 4.0 * (2 * batch * c * t + (UNIT_TAPS + 1) * c * c + 4 * c)


def units_bound_s(units: list[tuple[int, int, int]], batch: int) -> float:
    """Kernel 2b's least time for ``units`` at ``batch`` streams: each unit
    at the larger of its 3xTF32 operations and its bytes."""
    return sum(bound(TF32_PASSES * unit_flops(c, t, batch), unit_bytes(c, t, batch),
                     TF32_FLOPS)["bound_s"] for c, t, _ in units)


def _conv(batch: int, t_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * batch * t_out * cin * cout * k


def encode_flops(cfg: dict, t: int, batch: int) -> float:
    """Encoder and RVQ on ``batch`` padded inputs of ``t`` samples."""
    flops = _conv(batch, t, 1, cfg["encoder_dim"], 7)
    flops += sum(unit_flops(c, tt, batch) for c, tt, _ in encoder_units(cfg, t))
    dim, tt = cfg["encoder_dim"], t
    for rate in cfg["encoder_rates"]:
        tt //= rate
        flops += _conv(batch, tt, dim, 2 * dim, 2 * rate)
        dim *= 2
    lat, d, n = latent_dim(cfg), cfg["codebook_dim"], cfg["codebook_size"]
    flops += _conv(batch, tt, dim, lat, 3)
    # each stage: in_proj, the distance to every entry, out_proj
    flops += cfg["n_codebooks"] * 2.0 * batch * tt * (lat * d + n * d + d * lat)
    return flops


def decode_flops(cfg: dict, f: int, batch: int, from_codes: bool = False) -> float:
    """Decoder on ``f`` frames; with ``from_codes`` the stages' out_proj
    from the codes first (the vocoder's path)."""
    lat, dd = latent_dim(cfg), cfg["decoder_dim"]
    flops = cfg["n_codebooks"] * 2.0 * batch * f * cfg["codebook_dim"] * lat if from_codes \
        else 0.0
    flops += _conv(batch, f, lat, dd, 7)
    t = f
    for i, rate in enumerate(cfg["decoder_rates"]):
        t *= rate
        flops += _conv(batch, t // rate, dd >> i, dd >> (i + 1), 2 * rate)  # transposed
    flops += sum(unit_flops(c, tt, batch) for c, tt, _ in decoder_units(cfg, f))
    flops += _conv(batch, t, dd >> len(cfg["decoder_rates"]), 1, 7)
    return flops


def roundtrip_flops(cfg: dict, samples: int, batch: int) -> float:
    t = padded(cfg, samples)
    return encode_flops(cfg, t, batch) + decode_flops(cfg, t // hop(cfg), batch)


def roundtrip_units(cfg: dict, samples: int) -> list[tuple[int, int, int]]:
    t = padded(cfg, samples)
    return encoder_units(cfg, t) + decoder_units(cfg, t // hop(cfg))
