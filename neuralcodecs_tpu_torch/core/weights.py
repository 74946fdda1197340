"""State-dict helpers: weight-norm folding, the JAX package's layouts, and
the weight hooks the loader and export call on every model.

``fold_weight_norm`` is a copy of neuralcodecs_tpu.core.importer's: a
hubertsiuzdak/snac checkpoint folded by it loads into the port's modules
with ``load_state_dict(strict=True)``.

``from_jax_params`` inverts the layouts the JAX package keeps its
parameters in (neuralcodecs_tpu.ops.conv.torch_conv_weight_to_hio and
torch_conv_transpose_weight_to_hio, the Linear and Snake conversions in
neuralcodecs_tpu.models.layers), so one set of seeded JAX parameters can
drive both packages; ``to_jax_params`` is its exact inverse. Those layouts
are the "native" layout of a ``save_pretrained`` export, which either
package reads back.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from neuralcodecs_tpu_torch.core.exceptions import LoadError

StateDict = dict[str, np.ndarray]

_WN_SUFFIXES = [
    # (g suffix, v suffix) — new-style parametrizations, then legacy names
    (".parametrizations.weight.original0", ".parametrizations.weight.original1"),
    (".weight_g", ".weight_v"),
]


def fold_weight_norm(sd: StateDict) -> StateDict:
    """Fold weight-norm (g, v) parameter pairs into plain ``weight`` tensors.

    w = g * v / ||v|| with the L2 norm over all dims except dim 0 (PyTorch
    weight_norm(dim=0) semantics: per out-channel for Conv1d, per in-channel
    for ConvTranspose1d, matching the stored tensor layouts).
    """
    out: StateDict = {}
    consumed: set[str] = set()
    for key in sd:
        for g_suf, v_suf in _WN_SUFFIXES:
            if key.endswith(g_suf):
                base = key[: -len(g_suf)]
                v_key = base + v_suf
                if v_key in sd:
                    g = sd[key].astype(np.float32)
                    v = sd[v_key].astype(np.float32)
                    reduce_dims = tuple(range(1, v.ndim))
                    norm = np.sqrt(np.sum(v * v, axis=reduce_dims, keepdims=True))
                    g = g.reshape(norm.shape) if g.size == norm.size else g
                    out[base + ".weight"] = (g * v / norm).astype(np.float32)
                    consumed.add(key)
                    consumed.add(v_key)
                break
    for key, value in sd.items():
        if key not in consumed:
            out[key] = value
    return out


def transposed_groups(model: nn.Module) -> dict[str, int]:
    """``{weight key: groups}`` of every transposed conv in ``model``: the
    keys ``from_jax_params`` must read as transposed-conv weights."""
    return {f"{name}.weight": m.groups for name, m in model.named_modules()
            if isinstance(m, nn.ConvTranspose1d)}


def _conv_from_hio(w: np.ndarray) -> np.ndarray:
    """[K, Cin/g, Cout] -> torch Conv1d [Cout, Cin/g, K]."""
    return np.transpose(w, (2, 1, 0))


def _conv_transpose_from_hio(w: np.ndarray, groups: int) -> np.ndarray:
    """Equivalent-conv HIO [K, Cin/g, g·Cout/g] -> torch ConvTranspose1d
    [Cin, Cout/g, K]: undo the group regrouping, then the tap flip."""
    k, cin_g, cout = w.shape
    cout_g = cout // groups
    w = w.reshape(k, cin_g, groups, cout_g)
    # [K, Cin/g, g, Cout/g] -> [g, Cin/g, Cout/g, K] -> [Cin, Cout/g, K]
    w = np.transpose(w, (2, 1, 3, 0)).reshape(groups * cin_g, cout_g, k)
    return w[:, :, ::-1]


def _conv2d_from_hwio(w: np.ndarray) -> np.ndarray:
    """[kh, kw, Cin, Cout] -> torch Conv2d [Cout, Cin, kh, kw]."""
    return np.transpose(w, (3, 2, 0, 1))


def _conv2d_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [Cout, Cin, kh, kw] -> [kh, kw, Cin, Cout]."""
    return np.transpose(w, (2, 3, 1, 0))


def _conv_to_hio(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [Cout, Cin/g, K] -> [K, Cin/g, Cout]."""
    return np.transpose(w, (2, 1, 0))


def _conv_transpose_to_hio(w: np.ndarray, groups: int) -> np.ndarray:
    """torch ConvTranspose1d [Cin, Cout/g, K] -> the equivalent conv's HIO
    [K, Cin/g, g·Cout/g]: flip the taps, then regroup."""
    cin, cout_g, k = w.shape
    cin_g = cin // groups
    w = w[:, :, ::-1].reshape(groups, cin_g, cout_g, k)
    # [g, Cin/g, Cout/g, K] -> [K, Cin/g, g, Cout/g]
    return np.transpose(w, (3, 1, 0, 2)).reshape(k, cin_g, groups * cout_g)


# 2-D parameters the JAX package stores in torch's own layout: SNAC's
# codebook embeddings, Encodec's codebooks [K, D] with their EMA averages,
# and Encodec's RVQ projections (torch Linear [out, in]). Every other 2-D
# weight is a Linear or LSTM weight stored transposed, [in, out].
_TORCH_LAYOUT_2D = (".codebook.weight", ".codebook.embed", ".codebook.embed_avg",
                    ".project_in.weight", ".project_out.weight")
# the Encodec LM's per-codebook embeddings [card + 1, D], torch's layout too
_EMBEDDING = re.compile(r"(^|\.)emb\.\d+\.weight$")


def _keeps_torch_layout(key: str) -> bool:
    return ("." + key).endswith(_TORCH_LAYOUT_2D) or bool(_EMBEDDING.search(key))


def from_jax_params(params: Mapping[str, np.ndarray],
                    transposed: Mapping[str, int] | None = None
                    ) -> dict[str, torch.Tensor]:
    """JAX-package parameters -> a torch state dict for the port.

    params: name -> array in the JAX layouts. transposed: the weight keys of
    transposed convs with their groups (``transposed_groups(model)``); every
    other 3-D weight is a regular conv, and a 4-D weight a 2-D conv (HWIO,
    the DAC discriminator's). 2-D weights named in
    ``_TORCH_LAYOUT_2D`` and the Encodec LM's embeddings ``emb.{k}.weight``
    keep their layout; every other 2-D weight (Linear, LSTM
    ``weight_ih_l*`` / ``weight_hh_l*``, the LM's ``in_proj_weight``
    [D, 3D]) is ``[in, out]`` and is transposed to torch's ``[out, in]``.
    Snake ``alpha`` [C] becomes [1, C, 1].
    """
    transposed = transposed or {}
    out: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        w = np.asarray(value, dtype=np.float32)
        if key in transposed:
            w = _conv_transpose_from_hio(w, transposed[key])
        elif key.endswith(".alpha"):
            w = w.reshape(1, -1, 1)
        elif w.ndim == 3:
            w = _conv_from_hio(w)
        elif w.ndim == 4:
            w = _conv2d_from_hwio(w)
        elif w.ndim == 2 and not _keeps_torch_layout(key):
            w = w.T
        out[key] = torch.from_numpy(np.array(w))  # a writable, contiguous copy
    return out


def to_jax_params(state_dict: Mapping[str, np.ndarray | torch.Tensor],
                  transposed: Mapping[str, int] | None = None) -> StateDict:
    """A port state dict -> numpy arrays in the JAX package's layouts: the
    exact inverse of ``from_jax_params``, key for key and bit for bit.

    transposed: the weight keys of transposed convs with their groups
    (``transposed_groups(model)``). Conv weights go to HIO, a transposed
    conv's taps are unflipped and its groups regrouped, 2-D conv weights go
    to HWIO, Snake ``alpha``
    [1, C, 1] becomes [C], and 2-D weights are transposed to ``[in, out]``
    except those ``from_jax_params`` keeps in torch's layout.
    """
    transposed = transposed or {}
    out: StateDict = {}
    for key, value in state_dict.items():
        w = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
             else np.asarray(value))
        if key in transposed:
            w = _conv_transpose_to_hio(w, transposed[key])
        elif key.endswith(".alpha"):
            w = w.reshape(-1)
        elif w.ndim == 3:
            w = _conv_to_hio(w)
        elif w.ndim == 4:
            w = _conv2d_to_hwio(w)
        elif w.ndim == 2 and not _keeps_torch_layout(key):
            w = w.T
        out[key] = np.ascontiguousarray(w)
    return out


# ------------------------------------------------------------- model hooks


class CodecWeights:
    """The weight hooks the loader and export call on a model, so that both
    stay model-agnostic (Dia, whose JAX layouts are the port's, has its
    own). Mixed into SNAC, DAC and Encodec."""

    def native_state_dict(self) -> StateDict:
        """The weights as numpy arrays in the JAX package's layouts."""
        return to_jax_params(self.state_dict(), transposed_groups(self))

    def load_native_state_dict(self, tensors: Mapping[str, np.ndarray]):
        """Load arrays in the JAX package's layouts, bit for bit: every key
        of the model, and no other, must be there. Returns self."""
        check_keys(self, tensors, strict=True)
        _assign(self, from_jax_params(tensors, transposed_groups(self)))
        return self

    def load_upstream_state_dict(self, sd: Mapping[str, np.ndarray]):
        """Load a folded checkpoint in torch's layouts under upstream's
        names: keys the model has no slot for are dropped; a key it needs and
        ``sd`` lacks raises LoadError. Values are cast to f32. Returns self."""
        check_keys(self, sd, strict=False)
        _assign(self, {k: torch.from_numpy(np.array(sd[k], np.float32))
                       for k in self.state_dict()})
        return self


def check_keys(model: nn.Module, tensors: Mapping, strict: bool) -> None:
    """LoadError unless ``tensors`` has every key of the model's state dict
    and, when ``strict``, no other."""
    own = model.state_dict().keys()
    missing = sorted(set(own) - set(tensors))
    if missing:
        raise LoadError(f"Checkpoint lacks {len(missing)} tensors the model needs: "
                        f"{missing[:5]}")
    unexpected = sorted(set(tensors) - set(own))
    if strict and unexpected:
        raise LoadError(f"Checkpoint has {len(unexpected)} tensors the model lacks: "
                        f"{unexpected[:5]}")


def _assign(model: nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    own = model.state_dict()
    for key, value in tensors.items():
        if value.shape != own[key].shape:
            raise LoadError(f"Checkpoint tensor {key} has shape {tuple(value.shape)}, "
                            f"the model's is {tuple(own[key].shape)}")
    model.load_state_dict(tensors, strict=True)
