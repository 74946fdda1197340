"""Operations and bytes of a SNAC round trip, from the configuration's shapes.

A configuration is the dict of ``configs/<name>.json`` (upstream's keys).
Lengths are in samples (``t``) or frames (``f``, one frame a hop); ``batch``
is the number of streams. FLOPs count two a multiply-add of every
convolution and projection, depthwise ones included; the Snake activations,
the noise's product, the pooling, tanh and norms are left out (a few
operations an element, under a tenth of a percent).

Depthwise configurations only (``depthwise`` true, every SNAC preset).
Kernel 2a (the depthwise residual unit) computes, a unit at C channels over
T steps, a dilated 7-tap depthwise conv on f32 FMAs and a 1 x 1 C x C conv
on the tensor cores as three TF32 passes (3xTF32): its bound counts three
times the pointwise operations at the TF32 peak, against its bytes: x read
and out written once, and the unit's weights. The scratch between its two
launches is not counted: the unit's output does not depend on it, so a
fused unit would not move it.
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
    """The input length the model runs on: ``samples`` padded to the hop
    times the coarsest scale's stride."""
    step = hop(cfg) * math.lcm(cfg["vq_strides"][0], cfg.get("attn_window_size") or 1)
    return -(-samples // step) * step


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


def pointwise_flops(c: int, t: int, batch: int) -> float:
    return 2.0 * batch * t * c * c


def unit_flops(c: int, t: int, batch: int) -> float:
    """A depthwise unit: its 7 taps a channel and its C x C pointwise conv."""
    return 2.0 * batch * t * c * UNIT_TAPS + pointwise_flops(c, t, batch)


def unit_bytes(c: int, t: int, batch: int) -> float:
    """x read, out written, W1 (C x C), Wd (C x 7) and four C-vectors, f32."""
    return 4.0 * (2 * batch * c * t + c * c + UNIT_TAPS * c + 4 * c)


def units_bound_s(units: list[tuple[int, int, int]], batch: int) -> float:
    """Kernel 2a's least time for ``units`` at ``batch`` streams: each unit
    at the larger of its pointwise operations in 3xTF32 and its bytes."""
    return sum(bound(TF32_PASSES * pointwise_flops(c, t, batch), unit_bytes(c, t, batch),
                     TF32_FLOPS)["bound_s"] for c, t, _ in units)


def _conv(batch: int, t_out: int, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * batch * t_out * cin * cout * k / groups


def encode_flops(cfg: dict, t: int, batch: int) -> float:
    """Encoder and RVQ on ``batch`` padded inputs of ``t`` samples."""
    dim = cfg["encoder_dim"]
    flops = _conv(batch, t, 1, dim, 7)
    flops += sum(unit_flops(c, tt, batch) for c, tt, _ in encoder_units(cfg, t))
    tt = t
    for rate in cfg["encoder_rates"]:
        tt //= rate
        flops += _conv(batch, tt, dim, 2 * dim, 2 * rate)
        dim *= 2
    flops += _conv(batch, tt, dim, dim, 7, dim)
    lat, d, n = latent_dim(cfg), cfg["codebook_dim"], cfg["codebook_size"]
    # each scale at its pooled rate: in_proj, the distance to every entry, out_proj
    flops += sum(2.0 * batch * (tt // s) * (lat * d + n * d + d * lat)
                 for s in cfg["vq_strides"])
    return flops


def decode_flops(cfg: dict, f: int, batch: int) -> float:
    """Decoder on ``f`` frames."""
    lat, dd = latent_dim(cfg), cfg["decoder_dim"]
    flops = _conv(batch, f, lat, lat, 7, lat) + _conv(batch, f, lat, dd, 1)
    t = f
    for i, rate in enumerate(cfg["decoder_rates"]):
        t *= rate
        cout = dd >> (i + 1)
        flops += _conv(batch, t // rate, dd >> i, cout, 2 * rate)  # transposed
        if cfg["noise"]:
            flops += _conv(batch, t, cout, cout, 1)
    flops += sum(unit_flops(c, tt, batch) for c, tt, _ in decoder_units(cfg, f))
    flops += _conv(batch, t, dd >> len(cfg["decoder_rates"]), 1, 7)
    return flops


def roundtrip_flops(cfg: dict, samples: int, batch: int) -> float:
    t = padded(cfg, samples)
    return encode_flops(cfg, t, batch) + decode_flops(cfg, t // hop(cfg), batch)


def roundtrip_units(cfg: dict, samples: int) -> list[tuple[int, int, int]]:
    t = padded(cfg, samples)
    return encoder_units(cfg, t) + decoder_units(cfg, t // hop(cfg))
