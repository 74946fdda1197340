"""Plain DAC (Descript Audio Codec) in float32 PyTorch: the benchmark's reference.

Written from the published model (github.com/descriptinc/descript-audio-codec,
``dac/model/dac.py``, ``dac/nn/layers.py``, ``dac/nn/quantize.py``) with
weight norm folded into plain weights, under the checkpoint's parameter
names. Everything is read from a configuration dict (``configs/*.json``);
nothing of the program under test is imported. Activations are [B, C, T].

    encoder: conv k7 -> per rate s: 3 residual units (dilations 1, 3, 9),
             Snake, conv k=2s stride s -> Snake -> conv k3 to the latent
    RVQ, per stage: z_e = in_proj(residual); code = the nearest codebook
             row after both are L2-normalised; z_q = out_proj(codebook[code])
    decoder: conv k7 -> per rate s: Snake, transposed conv k=2s stride s,
             3 residual units -> Snake -> conv k7 -> tanh

A residual unit is x + conv1x1(snake(conv_k7_dilated(snake(x)))). Snake is
x + sin^2(a x) / (a + 1e-9), upstream's form.

``draw_weights`` makes the benchmark's weights from a seed on the device: one
uniform draw and one normal draw for the whole model, sliced. The driver
hands them to the program through its state-dict load; the reference draws
them again from the same seed.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


def latent_dim(cfg: dict) -> int:
    return cfg.get("latent_dim") or cfg["encoder_dim"] * 2 ** len(cfg["encoder_rates"])


def hop(cfg: dict) -> int:
    return math.prod(cfg["encoder_rates"])


def _units(prefix: str, c: int, first: int) -> dict[str, tuple[int, ...]]:
    out = {}
    for i in range(first, first + len(DILATIONS)):
        p = f"{prefix}.{i}.block"
        out.update({f"{p}.0.alpha": (1, c, 1), f"{p}.1.weight": (c, c, 7), f"{p}.1.bias": (c,),
                    f"{p}.2.alpha": (1, c, 1), f"{p}.3.weight": (c, c, 1), f"{p}.3.bias": (c,)})
    return out


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the folded checkpoint, name -> shape, in a fixed
    order."""
    dim, lat = cfg["encoder_dim"], latent_dim(cfg)
    s: dict[str, tuple[int, ...]] = {"encoder.block.0.weight": (dim, 1, 7),
                                     "encoder.block.0.bias": (dim,)}
    for i, rate in enumerate(cfg["encoder_rates"], start=1):
        p = f"encoder.block.{i}.block"
        s.update(_units(p, dim, 0))
        s.update({f"{p}.3.alpha": (1, dim, 1), f"{p}.4.weight": (2 * dim, dim, 2 * rate),
                  f"{p}.4.bias": (2 * dim,)})
        dim *= 2
    n = len(cfg["encoder_rates"])
    s.update({f"encoder.block.{n + 1}.alpha": (1, dim, 1),
              f"encoder.block.{n + 2}.weight": (lat, dim, 3), f"encoder.block.{n + 2}.bias": (lat,)})
    d, size = cfg["codebook_dim"], cfg["codebook_size"]
    for i in range(cfg["n_codebooks"]):
        p = f"quantizer.quantizers.{i}"
        s.update({f"{p}.in_proj.weight": (d, lat, 1), f"{p}.in_proj.bias": (d,),
                  f"{p}.out_proj.weight": (lat, d, 1), f"{p}.out_proj.bias": (lat,),
                  f"{p}.codebook.weight": (size, d)})
    dd = cfg["decoder_dim"]
    s.update({"decoder.model.0.weight": (dd, lat, 7), "decoder.model.0.bias": (dd,)})
    for i, rate in enumerate(cfg["decoder_rates"], start=1):
        cin, cout = dd >> (i - 1), dd >> i
        p = f"decoder.model.{i}.block"
        s.update({f"{p}.0.alpha": (1, cin, 1), f"{p}.1.weight": (cin, cout, 2 * rate),
                  f"{p}.1.bias": (cout,)})
        s.update(_units(p, cout, 2))
    n = len(cfg["decoder_rates"])
    cout = dd >> n
    s.update({f"decoder.model.{n + 1}.alpha": (1, cout, 1),
              f"decoder.model.{n + 2}.weight": (1, cout, 7), f"decoder.model.{n + 2}.bias": (1,)})
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
        w_key = k[: -len("bias")] + "weight" if k.endswith("bias") else k
        w_shape = shapes[w_key]
        fan_in = w_shape[1] * (w_shape[2] if len(w_shape) > 2 else 1)
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


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 products with TF32 off (the reference), or on (the control
    one step below it)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return x + (alpha + 1e-9).reciprocal() * torch.sin(alpha * x).pow(2)


def _unit(w: dict, p: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = snake(x, w[f"{p}.block.0.alpha"])
    y = F.conv1d(y, w[f"{p}.block.1.weight"], w[f"{p}.block.1.bias"], padding=3 * dilation,
                 dilation=dilation)
    y = snake(y, w[f"{p}.block.2.alpha"])
    return x + F.conv1d(y, w[f"{p}.block.3.weight"], w[f"{p}.block.3.bias"])


def encoder(w: dict, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """Padded audio [B, 1, T] -> latent [B, latent, T / hop]."""
    x = F.conv1d(audio, w["encoder.block.0.weight"], w["encoder.block.0.bias"], padding=3)
    for i, rate in enumerate(cfg["encoder_rates"], start=1):
        p = f"encoder.block.{i}.block"
        for j, d in enumerate(DILATIONS):
            x = _unit(w, f"{p}.{j}", x, d)
        x = F.conv1d(snake(x, w[f"{p}.3.alpha"]), w[f"{p}.4.weight"], w[f"{p}.4.bias"],
                     stride=rate, padding=math.ceil(rate / 2))
    n = len(cfg["encoder_rates"])
    x = snake(x, w[f"encoder.block.{n + 1}.alpha"])
    return F.conv1d(x, w[f"encoder.block.{n + 2}.weight"], w[f"encoder.block.{n + 2}.bias"],
                    padding=1)


def quantize(w: dict, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, C, F] -> codes [B, n_codebooks, F] (int64)."""
    codes = []
    residual = z
    for i in range(cfg["n_codebooks"]):
        p = f"quantizer.quantizers.{i}"
        z_e = F.conv1d(residual, w[f"{p}.in_proj.weight"], w[f"{p}.in_proj.bias"])
        book = w[f"{p}.codebook.weight"]
        enc = F.normalize(z_e.transpose(1, 2).reshape(-1, z_e.shape[1]))
        cb = F.normalize(book)
        dist = enc.pow(2).sum(1, keepdim=True) - 2 * enc @ cb.t() + cb.pow(2).sum(1)[None]
        code = dist.argmin(dim=1).view(z_e.shape[0], z_e.shape[2])
        z_q = F.conv1d(book[code].transpose(1, 2), w[f"{p}.out_proj.weight"],
                       w[f"{p}.out_proj.bias"])
        residual = residual - z_q
        codes.append(code)
    return torch.stack(codes, dim=1)


def from_codes(w: dict, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """Codes [B, n, F] -> z_q [B, latent, F]: each stage's out_proj summed."""
    z_q = None
    for i in range(codes.shape[1]):
        p = f"quantizer.quantizers.{i}"
        e = w[f"{p}.codebook.weight"][codes[:, i].long()].transpose(1, 2)
        part = F.conv1d(e, w[f"{p}.out_proj.weight"], w[f"{p}.out_proj.bias"])
        z_q = part if z_q is None else z_q + part
    return z_q


def decoder(w: dict, cfg: dict, z_q: torch.Tensor) -> torch.Tensor:
    """z_q [B, latent, F] -> audio [B, F hop]."""
    x = F.conv1d(z_q, w["decoder.model.0.weight"], w["decoder.model.0.bias"], padding=3)
    for i, rate in enumerate(cfg["decoder_rates"], start=1):
        p = f"decoder.model.{i}.block"
        x = F.conv_transpose1d(snake(x, w[f"{p}.0.alpha"]), w[f"{p}.1.weight"],
                               w[f"{p}.1.bias"], stride=rate, padding=math.ceil(rate / 2))
        for j, d in enumerate(DILATIONS, start=2):
            x = _unit(w, f"{p}.{j}", x, d)
    n = len(cfg["decoder_rates"])
    x = snake(x, w[f"decoder.model.{n + 1}.alpha"])
    x = F.conv1d(x, w[f"decoder.model.{n + 2}.weight"], w[f"decoder.model.{n + 2}.bias"],
                 padding=3)
    return torch.tanh(x)[:, 0]


def pad_audio(cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, 1, T'] zero-padded at the end to a multiple of the hop."""
    t = audio.shape[-1]
    return F.pad(audio, (0, -t % hop(cfg)))[:, None]


@torch.no_grad()
def encode(w: dict, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """Audio [B, T] -> codes [B, n_codebooks, ceil(T / hop)]."""
    return quantize(w, cfg, encoder(w, cfg, pad_audio(cfg, audio)))


@torch.no_grad()
def decode(w: dict, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """Codes [B, n, F] -> audio [B, F hop]."""
    return decoder(w, cfg, from_codes(w, cfg, codes))
