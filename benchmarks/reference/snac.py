"""Plain SNAC (Multi-Scale Neural Audio Codec) in float32 PyTorch: the benchmark's reference.

Written from the published model (github.com/hubertsiuzdak/snac,
``snac/snac.py``, ``snac/layers.py``, ``snac/vq.py``) with weight norm folded
into plain weights, under the checkpoint's parameter names. Everything is
read from a configuration dict (``configs/*.json``); nothing of the program
under test is imported. Activations are [B, C, T]. Configurations without
attention only (``attn_window_size`` null, as SNAC-24k): LocalMHA is not
written here.

    encoder: conv k7 -> per rate s: 3 residual units (dilations 1, 3, 9),
             Snake, conv k=2s stride s -> conv k7 (depthwise where
             ``depthwise``)
    RVQ, per scale of stride s: residual average-pooled by s; z_e =
             in_proj(pooled); code = the nearest codebook row after both
             are L2-normalised; z_q = out_proj(z_e + (codebook[code] - z_e)),
             repeated s times along T
    decoder: depthwise conv k7 and conv 1x1 (or one conv k7) -> per rate s:
             Snake, transposed conv k=2s stride s, noise, 3 residual units
             -> Snake -> conv k7 -> tanh

A residual unit is x + conv1x1(snake(conv_k7_dilated(snake(x)))), its k7
conv depthwise where ``depthwise``. Noise is x + n * conv1x1(x) (no bias)
with n of shape [B, 1, T].

One departure from upstream: upstream's noise draws ``randn((B, 1, T))``
from the global RNG; here it is drawn from the generator ``decode`` is
given, one draw a decoder block in order, so that the reference draws the
noise the program drew from a generator of the same seed on the same device
(the program's own draws come from a fresh generator seeded 0 a call).

``draw_weights`` makes the benchmark's weights from a seed on the device, as
``reference/dac.py`` does: one uniform draw and one normal draw for the
whole model, sliced. The driver hands them to the program through its
state-dict load; the reference draws them again from the same seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference.dac import precision, snake  # noqa: F401  (precision re-exported)

DILATIONS = (1, 3, 9)


def latent_dim(cfg: dict) -> int:
    return cfg.get("latent_dim") or cfg["encoder_dim"] * 2 ** len(cfg["encoder_rates"])


def hop(cfg: dict) -> int:
    return math.prod(cfg["encoder_rates"])


def pad_to(cfg: dict) -> int:
    """Inputs are padded to a multiple of this: the hop times the coarsest
    scale's stride (and the attention window, which these configurations
    lack)."""
    return hop(cfg) * math.lcm(cfg["vq_strides"][0], cfg.get("attn_window_size") or 1)


def _check(cfg: dict) -> None:
    if cfg.get("attn_window_size"):
        raise NotImplementedError("reference/snac.py: configurations with LocalMHA")


def _units(prefix: str, c: int, first: int, depthwise: bool) -> dict[str, tuple[int, ...]]:
    out = {}
    for i in range(first, first + len(DILATIONS)):
        p = f"{prefix}.{i}.block"
        out.update({f"{p}.0.alpha": (1, c, 1), f"{p}.1.weight": (c, 1 if depthwise else c, 7),
                    f"{p}.1.bias": (c,), f"{p}.2.alpha": (1, c, 1),
                    f"{p}.3.weight": (c, c, 1), f"{p}.3.bias": (c,)})
    return out


def _decoder_head(cfg: dict) -> int:
    """Layers of ``decoder.model`` before its first block."""
    return 2 if cfg["depthwise"] else 1


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the folded checkpoint, name -> shape, in a fixed
    order."""
    _check(cfg)
    dw, dim, lat = cfg["depthwise"], cfg["encoder_dim"], latent_dim(cfg)
    s: dict[str, tuple[int, ...]] = {"encoder.block.0.weight": (dim, 1, 7),
                                     "encoder.block.0.bias": (dim,)}
    for i, rate in enumerate(cfg["encoder_rates"], start=1):
        p = f"encoder.block.{i}.block"
        s.update(_units(p, dim, 0, dw))
        s.update({f"{p}.3.alpha": (1, dim, 1), f"{p}.4.weight": (2 * dim, dim, 2 * rate),
                  f"{p}.4.bias": (2 * dim,)})
        dim *= 2
    n = len(cfg["encoder_rates"])
    s.update({f"encoder.block.{n + 1}.weight": (dim, 1 if dw else dim, 7),
              f"encoder.block.{n + 1}.bias": (dim,)})
    d, size = cfg["codebook_dim"], cfg["codebook_size"]
    for i in range(len(cfg["vq_strides"])):
        p = f"quantizer.quantizers.{i}"
        s.update({f"{p}.in_proj.weight": (d, lat, 1), f"{p}.in_proj.bias": (d,),
                  f"{p}.out_proj.weight": (lat, d, 1), f"{p}.out_proj.bias": (lat,),
                  f"{p}.codebook.weight": (size, d)})
    dd = cfg["decoder_dim"]
    if dw:
        s.update({"decoder.model.0.weight": (lat, 1, 7), "decoder.model.0.bias": (lat,),
                  "decoder.model.1.weight": (dd, lat, 1), "decoder.model.1.bias": (dd,)})
    else:
        s.update({"decoder.model.0.weight": (dd, lat, 7), "decoder.model.0.bias": (dd,)})
    head = _decoder_head(cfg)
    for i, rate in enumerate(cfg["decoder_rates"]):
        cin, cout = dd >> i, dd >> (i + 1)
        p = f"decoder.model.{head + i}.block"
        s.update({f"{p}.0.alpha": (1, cin, 1), f"{p}.1.weight": (cin, cout, 2 * rate),
                  f"{p}.1.bias": (cout,)})
        if cfg["noise"]:
            s[f"{p}.2.linear.weight"] = (cout, cout, 1)
        s.update(_units(p, cout, 3 if cfg["noise"] else 2, dw))
    n = len(cfg["decoder_rates"])
    cout = dd >> n
    s.update({f"decoder.model.{head + n}.alpha": (1, cout, 1),
              f"decoder.model.{head + n + 1}.weight": (1, cout, 7),
              f"decoder.model.{head + n + 1}.bias": (1,)})
    return s


def draw_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded weights on ``device``, as torch's default initialisers draw
    them: conv weights and biases uniform in +-1/sqrt(fan_in) (fan_in = the
    weight's dim 1 times its taps), codebooks standard normal, Snake's
    alpha 1. Two draws of a torch.Generator on the device, sliced."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uniform = [k for k in shapes if not k.endswith(("alpha", "codebook.weight"))]
    normal = [k for k in shapes if k.endswith("codebook.weight")]
    u = torch.rand(sum(math.prod(shapes[k]) for k in uniform), generator=gen, device=device)
    z = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=gen, device=device)
    out, at = {}, 0
    for k in uniform:
        n = math.prod(shapes[k])
        w_shape = shapes[k[: -len("bias")] + "weight" if k.endswith("bias") else k]
        fan_in = w_shape[1] * w_shape[2]
        out[k] = u[at:at + n].view(shapes[k]).mul_(2.0).sub_(1.0).mul_(fan_in ** -0.5)
        at += n
    at = 0
    for k in normal:
        n = math.prod(shapes[k])
        out[k] = z[at:at + n].view(shapes[k])
        at += n
    for k in shapes:
        if k.endswith("alpha"):
            out[k] = torch.ones(shapes[k], device=device)
    return {k: out[k] for k in shapes}


def noise_generator(device, seed: int = 0) -> torch.Generator:
    """The generator one call's decoder noise is drawn from: seeded 0, as
    the program seeds its own a call."""
    return torch.Generator(device=device).manual_seed(seed)


def _conv(w: dict, p: str, x: torch.Tensor, **kw) -> torch.Tensor:
    weight = w[f"{p}.weight"]
    groups = x.shape[1] // weight.shape[1]
    return F.conv1d(x, weight, w.get(f"{p}.bias"), groups=groups, **kw)


def _unit(w: dict, p: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = snake(x, w[f"{p}.block.0.alpha"])
    y = _conv(w, f"{p}.block.1", y, padding=3 * dilation, dilation=dilation)
    y = snake(y, w[f"{p}.block.2.alpha"])
    return x + _conv(w, f"{p}.block.3", y)


def encoder(w: dict, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """Padded audio [B, 1, T] -> latent [B, latent, T / hop]."""
    x = _conv(w, "encoder.block.0", audio, padding=3)
    for i, rate in enumerate(cfg["encoder_rates"], start=1):
        p = f"encoder.block.{i}.block"
        for j, d in enumerate(DILATIONS):
            x = _unit(w, f"{p}.{j}", x, d)
        x = _conv(w, f"{p}.4", snake(x, w[f"{p}.3.alpha"]), stride=rate,
                  padding=math.ceil(rate / 2))
    return _conv(w, f"encoder.block.{len(cfg['encoder_rates']) + 1}", x, padding=3)


def _nearest(w: dict, p: str, z_e: torch.Tensor) -> torch.Tensor:
    """Codes [B, T'] of z_e [B, D, T']: upstream's ``decode_latents``."""
    enc = F.normalize(z_e.transpose(1, 2).reshape(-1, z_e.shape[1]))
    cb = F.normalize(w[f"{p}.codebook.weight"])
    dist = enc.pow(2).sum(1, keepdim=True) - 2 * enc @ cb.t() + cb.pow(2).sum(1, keepdim=True).t()
    return (-dist).max(1)[1].view(z_e.shape[0], z_e.shape[2])


def quantize(w: dict, cfg: dict, z: torch.Tensor) -> list[torch.Tensor]:
    """Latent [B, C, F] -> codes, one [B, F / stride] (int64) a scale."""
    codes = []
    residual = z
    for i, stride in enumerate(cfg["vq_strides"]):
        p = f"quantizer.quantizers.{i}"
        pooled = F.avg_pool1d(residual, stride, stride) if stride > 1 else residual
        z_e = _conv(w, f"{p}.in_proj", pooled)
        code = _nearest(w, p, z_e)
        z_q = w[f"{p}.codebook.weight"][code].transpose(1, 2)
        z_q = _conv(w, f"{p}.out_proj", z_e + (z_q - z_e))
        residual = residual - z_q.repeat_interleave(stride, dim=-1)
        codes.append(code)
    return codes


def from_codes(w: dict, cfg: dict, codes: list[torch.Tensor]) -> torch.Tensor:
    """Codes, one [B, F / stride] a scale -> z_q [B, latent, F]: each
    scale's out_proj, repeated to the frame rate, summed."""
    z_q = None
    for i, (stride, code) in enumerate(zip(cfg["vq_strides"], codes)):
        p = f"quantizer.quantizers.{i}"
        e = w[f"{p}.codebook.weight"][code.long()].transpose(1, 2)
        part = _conv(w, f"{p}.out_proj", e).repeat_interleave(stride, dim=-1)
        z_q = part if z_q is None else z_q + part
    return z_q


def decoder(w: dict, cfg: dict, z_q: torch.Tensor, generator: torch.Generator | None
            ) -> torch.Tensor:
    """z_q [B, latent, F] -> audio [B, F hop]; the noise from ``generator``
    (required where the configuration has noise)."""
    x = _conv(w, "decoder.model.0", z_q, padding=3)
    if cfg["depthwise"]:
        x = _conv(w, "decoder.model.1", x)
    head = _decoder_head(cfg)
    for i, rate in enumerate(cfg["decoder_rates"]):
        p = f"decoder.model.{head + i}.block"
        x = F.conv_transpose1d(snake(x, w[f"{p}.0.alpha"]), w[f"{p}.1.weight"],
                               w[f"{p}.1.bias"], stride=rate, padding=math.ceil(rate / 2),
                               output_padding=rate % 2)
        if cfg["noise"]:
            b, _, t = x.shape
            n = torch.randn((b, 1, t), generator=generator, device=x.device, dtype=x.dtype)
            x = x + n * _conv(w, f"{p}.2.linear", x)
        for j, d in enumerate(DILATIONS, start=3 if cfg["noise"] else 2):
            x = _unit(w, f"{p}.{j}", x, d)
    n = len(cfg["decoder_rates"])
    x = snake(x, w[f"decoder.model.{head + n}.alpha"])
    x = _conv(w, f"decoder.model.{head + n + 1}", x, padding=3)
    return torch.tanh(x)[:, 0]


def pad_audio(cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, 1, T'] zero-padded at the end to a multiple of
    ``pad_to``."""
    t = audio.shape[-1]
    return F.pad(audio, (0, -t % pad_to(cfg)))[:, None]


@torch.no_grad()
def encode(w: dict, cfg: dict, audio: torch.Tensor) -> list[torch.Tensor]:
    """Audio [B, T] -> codes, one [B, frames / stride] a scale."""
    _check(cfg)
    return quantize(w, cfg, encoder(w, cfg, pad_audio(cfg, audio)))


@torch.no_grad()
def decode(w: dict, cfg: dict, codes: list[torch.Tensor],
           generator: torch.Generator | None) -> torch.Tensor:
    """Codes -> audio [B, frames hop], the noise drawn from ``generator``."""
    _check(cfg)
    return decoder(w, cfg, from_codes(w, cfg, codes), generator)
