"""SEANet encoder/decoder stack for Encodec, PyTorch port.

Counterpart of neuralcodecs_tpu.models.encodec.seanet, in torch's [B, C, T]
layout. The padding math (causal left pad, asymmetric "same" padding for
the non-causal form, the stride-alignment extra pad, the small-input
reflect fallback and its trim) is the JAX package's, on static shapes. The
convs are cuDNN's.

The 2-layer SLSTM computes each layer's input projection for the whole
sequence with one ``torch.matmul``; only the recurrence runs step by step,
through ``ops.kernels.lstm.lstm_scan`` (the CUDA kernel on a CUDA device).

Module and parameter names equal the JAX parameter names
(``encoder.layers.7.lstm.weight_hh_l0``, ``decoder.layers.1.block.3.conv.weight``,
``...norm.weight``); the parameterless ELU slots keep the indices.

The ``stream()`` methods run one chunk of a causal model with carried
state: each conv's input tail (its causal left context), each transposed
conv's pre-bias overlap tail and each SLSTM's (h, c) [L, B, H], which goes
to the LSTM kernel as h0 / c0. A first chunk (state None) takes the layer's
normal left padding, so the chunks' outputs concatenate to the full causal
forward. States are lists with a None slot for each stateless layer.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuralcodecs_tpu_torch.ops.conv import conv1d, conv_transpose1d
from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x > 0 ? x : alpha (exp(x) - 1), written as the JAX package writes it."""
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def get_extra_padding(length: int, eff_kernel: int, stride: int, pad_total: int) -> int:
    """Stride-alignment extra pad: enough right padding that the last
    (partial) frame is computed."""
    n_frames = (length - eff_kernel + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (eff_kernel - pad_total)
    return ideal - length


def pad1d(x: torch.Tensor, left: int, right: int, mode: str = "reflect") -> torch.Tensor:
    """Time-axis padding of [B, C, T]. Reflect on an input no longer than the
    pad zero-extends first so that reflect is valid, then trims the extension
    back off: the output length is always T + left + right."""
    if mode in ("zero", "constant"):
        return F.pad(x, (left, right))
    t = x.shape[-1]
    extra = 0
    if mode == "reflect" and t <= max(left, right):
        extra = max(left, right) - t + 1
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode=mode)
    return out[..., : out.shape[-1] - extra] if extra else out


class ConvLayerNorm(nn.Module):
    """Layer norm over the channel axis of [B, C, T]."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=1, keepdim=True)
        h = (x - mean) * torch.rsqrt(var + self.eps)
        return h * self.weight[:, None] + self.bias[:, None]


class GroupNorm1(nn.Module):
    """GroupNorm(1, C): normalise over (C, T) per sample; Encodec's
    ``time_group_norm``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=(1, 2), keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=(1, 2), keepdim=True)
        h = (x - mean) * torch.rsqrt(var + self.eps)
        return h * self.weight[:, None] + self.bias[:, None]


def _make_norm(norm_type: str, channels: int) -> nn.Module | None:
    """weight_norm is folded at load (no runtime module); time_group_norm and
    layer_norm follow the conv."""
    if norm_type == "time_group_norm":
        return GroupNorm1(channels)
    if norm_type == "layer_norm":
        return ConvLayerNorm(channels)
    if norm_type in ("weight_norm", "none", ""):
        return None
    raise ValueError(f"Unsupported norm type: {norm_type}")


class SConv1d(nn.Module):
    """Conv1d with causal or asymmetric "same" padding, plus the optional
    norm. Parameters: ``conv.weight`` [Cout, Cin/g, K], ``conv.bias``,
    ``norm.*``."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = True, causal: bool = False,
                 norm_type: str = "weight_norm", pad_mode: str = "reflect"):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=stride, dilation=dilation,
                              groups=groups, bias=bias)
        self.causal = causal
        self.pad_mode = pad_mode
        self.norm = _make_norm(norm_type, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        stride, dilation = conv.stride[0], conv.dilation[0]
        eff_k = (conv.kernel_size[0] - 1) * dilation + 1
        pad_total = eff_k - stride
        extra = get_extra_padding(x.shape[-1], eff_k, stride, pad_total)
        if self.causal:
            x = pad1d(x, pad_total, extra, self.pad_mode)
        else:
            right = pad_total // 2
            x = pad1d(x, pad_total - right, right + extra, self.pad_mode)
        out = conv1d(x, conv.weight, conv.bias, stride=stride, dilation=dilation,
                     groups=conv.groups)
        return out if self.norm is None else self.norm(out)

    def stream(self, x: torch.Tensor, state: torch.Tensor | None):
        """One chunk x [B, Cin, Tc], Tc % stride == 0 -> (out, the input tail
        [B, Cin, eff_k - stride] that is the next chunk's left context). A
        first chunk (state None) is padded as the full forward pads it,
        reflect and its short-input fallback included."""
        if not self.causal:
            raise ValueError("streaming requires a causal conv")
        conv = self.conv
        ctx = (conv.kernel_size[0] - 1) * conv.dilation[0] + 1 - conv.stride[0]
        ext = pad1d(x, ctx, 0, self.pad_mode) if state is None else torch.cat([state, x], -1)
        out = conv1d(ext, conv.weight, conv.bias, stride=conv.stride[0],
                     dilation=conv.dilation[0], groups=conv.groups)
        if self.norm is not None:
            out = self.norm(out)
        return out, ext[..., ext.shape[-1] - ctx:]


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d, the optional norm, then the causal or symmetric trim
    of the k - stride overhang."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, causal: bool = False,
                 norm_type: str = "weight_norm", trim_right_ratio: float = 1.0):
        super().__init__()
        self.conv = nn.ConvTranspose1d(cin, cout, k, stride=stride)
        self.causal = causal
        self.trim_right_ratio = trim_right_ratio
        self.pad_total = k - stride
        self.norm = _make_norm(norm_type, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_transpose1d(x, self.conv.weight, self.conv.bias, stride=self.conv.stride[0])
        if self.norm is not None:
            y = self.norm(y)
        if self.causal:
            pad_right = math.ceil(self.pad_total * self.trim_right_ratio)
        else:
            pad_right = self.pad_total // 2
        pad_left = self.pad_total - pad_right
        return y[..., pad_left: y.shape[-1] - pad_right]

    def stream(self, x: torch.Tensor, state: torch.Tensor | None):
        """One chunk x [B, Cin, Tc] -> (y [B, Cout, Tc·stride], tail). The
        transposed conv's last k - stride samples overlap the next chunk:
        they are carried before the bias and added to the next chunk's head,
        and the bias comes after that overlap-add, as in the full causal
        forward with trim_right_ratio = 1 (Encodec's)."""
        if not self.causal or self.trim_right_ratio != 1.0 or self.norm is not None:
            raise ValueError("streaming needs a causal transposed conv with "
                             "trim_right_ratio = 1 and no norm")
        y = conv_transpose1d(x, self.conv.weight, None, stride=self.conv.stride[0])
        emit = x.shape[-1] * self.conv.stride[0]
        out = y[..., :emit]
        if self.pad_total > 0:
            if state is not None:
                out = torch.cat([out[..., :self.pad_total] + state, out[..., self.pad_total:]],
                                dim=-1)
            state = y[..., emit:]
        else:
            state = y[..., :0]
        return out + self.conv.bias[:, None], state


class ELU(nn.Module):
    """Parameterless ELU slot: keeps the layer indices of the reference."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return elu(x)


class SEANetResnetBlock(nn.Module):
    """ELU → conv(k, dil) → ELU → conv(1), plus an identity or 1×1-conv skip.
    ``block.1`` and ``block.3`` are the convs."""

    def __init__(self, dim: int, *, kernel_sizes=(3, 1), dilations=(1, 1),
                 causal: bool = False, norm_type: str = "weight_norm",
                 pad_mode: str = "reflect", compress: int = 2, true_skip: bool = False):
        super().__init__()
        hidden = dim // compress
        layers: list[nn.Module] = []
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            cin = dim if i == 0 else hidden
            cout = dim if i == len(kernel_sizes) - 1 else hidden
            layers += [ELU(), SConv1d(cin, cout, k, dilation=d, causal=causal,
                                      norm_type=norm_type, pad_mode=pad_mode)]
        self.block = nn.Sequential(*layers)
        self.shortcut = None if true_skip else SConv1d(
            dim, dim, 1, causal=causal, norm_type=norm_type, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + self.block(x)

    def stream(self, x: torch.Tensor, state: list | None):
        """One chunk; the state holds the block's conv tails, then the
        shortcut's (None for an identity skip)."""
        h, states = _stream_layers(self.block, x, None if state is None else state[:-1])
        if self.shortcut is None:
            return x + h, states + [None]
        skip, tail = self.shortcut.stream(x, None if state is None else state[-1])
        return skip + h, states + [tail]


class LSTMWeights(nn.Module):
    """The parameters of a stacked LSTM under nn.LSTM's names and layouts:
    ``weight_ih_l{n}`` [4H, in], ``weight_hh_l{n}`` [4H, H], ``bias_ih_l{n}``
    and ``bias_hh_l{n}`` [4H]; gate order i, f, g, o. Initialised as nn.LSTM
    does, U(-1/sqrt(H), 1/sqrt(H)).

    nn.LSTM itself is not the holder: on a CUDA device it flattens its
    weights into cuDNN's packed buffer at every ``.to()`` and expects its
    own forward to run them, while here the input projection is one matmul
    per layer and the recurrence the LSTM kernel (ops/kernels/lstm.py)."""

    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        bound = 1.0 / math.sqrt(dim)
        for n in range(num_layers):
            for name, shape in ((f"weight_ih_l{n}", (4 * dim, dim)),
                                (f"weight_hh_l{n}", (4 * dim, dim)),
                                (f"bias_ih_l{n}", (4 * dim,)), (f"bias_hh_l{n}", (4 * dim,))):
                setattr(self, name, nn.Parameter(torch.empty(shape).uniform_(-bound, bound)))

    def layer(self, n: int) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"{p}_l{n}") for p in ("weight_ih", "weight_hh",
                                                         "bias_ih", "bias_hh"))


class SLSTM(nn.Module):
    """Stacked LSTM over time with a skip connection, on [B, C, T]."""

    def __init__(self, dim: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        self.dim = dim
        self.skip = skip
        self.lstm = LSTMWeights(dim, num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stream(x, None)[0]

    def stream(self, x: torch.Tensor, state: tuple[torch.Tensor, torch.Tensor] | None):
        """x [B, C, T] from the state (h, c), each [L, B, H] (zeros when
        None) -> (out [B, H, T], the state after the last step)."""
        b = x.shape[0]
        out = x.permute(2, 0, 1)                                    # [T, B, C]
        if state is None:
            zeros = x.new_zeros(self.lstm.num_layers, b, self.dim)
            state = (zeros, zeros)
        h_f, c_f = [], []
        for n in range(self.lstm.num_layers):
            w_ih, w_hh, b_ih, b_hh = self.lstm.layer(n)
            # the weights in the activations' dtype, as the JAX package's SLSTM
            # takes them (f32 under its precision modes: the conv before the
            # SLSTM has promoted); the input projection for the whole
            # sequence: [T, B, 4H]
            dtype = out.dtype
            gates_x = torch.matmul(out, w_ih.to(dtype).t()) + (b_ih + b_hh).to(dtype)
            out, h, c = lstm_scan(gates_x.contiguous(), w_hh.to(dtype), state[0][n],
                                  state[1][n])
            h_f.append(h)
            c_f.append(c)
        out = out.permute(1, 2, 0)                                  # [B, H, T]
        return out + x if self.skip else out, (torch.stack(h_f), torch.stack(c_f))


class SEANetEncoder(nn.Module):
    """conv(k7) → [resblocks + ELU + strided conv]×4 → SLSTM → ELU → conv(k7).
    The ratios apply reversed (finest first)."""

    def __init__(self, *, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 1, ratios=(8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, causal: bool = False,
                 norm_type: str = "weight_norm", pad_mode: str = "reflect",
                 true_skip: bool = False, compress: int = 2, lstm: int = 2):
        super().__init__()
        self.ratios = list(reversed(list(ratios)))
        self.hop_length = int(np.prod(ratios))
        kw = dict(causal=causal, norm_type=norm_type, pad_mode=pad_mode)
        mult = 1
        layers: list[nn.Module] = [SConv1d(channels, mult * n_filters, kernel_size, **kw)]
        for ratio in self.ratios:
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, **kw))
            layers.append(ELU())
            layers.append(SConv1d(mult * n_filters, mult * n_filters * 2, ratio * 2,
                                  stride=ratio, **kw))
            mult *= 2
        if lstm > 0:
            layers.append(SLSTM(mult * n_filters, lstm))
        layers.append(ELU())
        layers.append(SConv1d(mult * n_filters, dimension, last_kernel_size, **kw))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)

    def stream(self, x: torch.Tensor, states: list | None):
        """One chunk of audio [B, C, Tc], Tc % hop_length == 0 -> (latents
        [B, D, Tc / hop], the next state)."""
        return _stream_layers(self.layers, x, states)


class SEANetDecoder(nn.Module):
    """conv(k7) → SLSTM → [ELU + transposed conv + resblocks]×4 → ELU → conv(k7)."""

    def __init__(self, *, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 1, ratios=(8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, causal: bool = False,
                 norm_type: str = "weight_norm", pad_mode: str = "reflect",
                 true_skip: bool = False, compress: int = 2, lstm: int = 2,
                 trim_right_ratio: float = 1.0):
        super().__init__()
        self.ratios = list(ratios)
        kw = dict(causal=causal, norm_type=norm_type, pad_mode=pad_mode)
        mult = 2 ** len(self.ratios)
        layers: list[nn.Module] = [SConv1d(dimension, mult * n_filters, kernel_size, **kw)]
        if lstm > 0:
            layers.append(SLSTM(mult * n_filters, lstm))
        for ratio in self.ratios:
            layers.append(ELU())
            layers.append(SConvTranspose1d(mult * n_filters, mult * n_filters // 2, ratio * 2,
                                           stride=ratio, causal=causal, norm_type=norm_type,
                                           trim_right_ratio=trim_right_ratio))
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, **kw))
            mult //= 2
        layers.append(ELU())
        layers.append(SConv1d(n_filters, channels, last_kernel_size, **kw))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)

    def stream(self, x: torch.Tensor, states: list | None):
        """One chunk of latents [B, D, Fc] -> (audio [B, C, Fc·hop], the
        next state)."""
        return _stream_layers(self.layers, x, states)


def _stream_layers(layers, x: torch.Tensor, states: list | None):
    """One streaming step through a sequence of layers; a stateless layer
    keeps a None slot."""
    states = states if states is not None else [None] * len(layers)
    new_states = []
    for layer, state in zip(layers, states):
        if hasattr(layer, "stream"):
            x, state = layer.stream(x, state)
        else:
            x = layer(x)
        new_states.append(state)
    return x, new_states
