"""Parameter and batch placements over a (dp, tp, sp) mesh (counterpart of
neuralcodecs_tpu.parallel.sharding).

A placement is a tuple of ``torch.distributed.tensor`` placements, one a
mesh axis in (dp, tp, sp) order, as ``distribute_tensor`` takes them:
parameters are ``Replicate()`` everywhere or ``Shard(dim)`` over tp, the
batch ``Shard(0)`` over dp.

The codec rules are the JAX package's, read by meaning: JAX splits a conv's
output channels (its HIO [K, I/g, O] on O), a linear's outputs ([in, out]
on out) and large biases, when the split is at least ``_MIN_SHARD_DIM`` and
divides by tp. Here O is dim 0 of a ``Conv1d`` weight [O, I/g, K] but dim
1 of a ``ConvTranspose1d`` weight [I, O/g, K] (JAX keeps transposed convs
in HIO too), and out is dim 0 of an ``nn.Linear`` weight [out, in]: each
parameter's JAX shape is found from the layouts ``core/weights`` converts,
JAX's rule is applied to it, and the dim it picks is mapped back. Dia's
DenseGeneral kernels load unconverted, so ``dia_param_shardings`` keeps
JAX's dims.

``shard_params`` places each rank's slice into the module. The codecs keep
computing on the whole weight, gathered at its use by a parametrization
(``collectives.gather_at_use``), so the kernels see a plain tensor; Dia
computes on its slices (tensor parallelism proper: its heads and its
slice of the MLP, with the row-parallel sums after ``o_proj`` and ``wo``).
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.nn.utils import parametrize

from neuralcodecs_tpu_torch.core.weights import _keeps_torch_layout, transposed_groups
from neuralcodecs_tpu_torch.parallel import collectives
from neuralcodecs_tpu_torch.parallel.mesh import axis_rank, axis_size

#: below this many output channels, sharding costs more than it saves
_MIN_SHARD_DIM = 256

Placements = tuple


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(),) * mesh.ndim


def batch_sharding(mesh: DeviceMesh, ndim: int) -> Placements:
    """Dim 0 (batch) over dp; ``ndim`` is the array's rank, as in JAX (the
    placements do not depend on it)."""
    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def tp_sharded(dim: int) -> Placements:
    return (Replicate(), Shard(dim), Replicate())


def sharded_dim(placements: Placements) -> int | None:
    """The dim split over tp, or None when replicated."""
    p = placements[1]
    return p.dim if isinstance(p, Shard) else None


def _jax_sharded_dim(name: str, shape: tuple[int, ...], tp: int) -> int | None:
    """JAX's ``_spec_for``, on the parameter's JAX shape: the dim it splits."""
    if tp <= 1 or "codebook" in name:
        return None
    if len(shape) == 3 and name.endswith(".weight"):
        return 2 if shape[2] % tp == 0 and shape[2] >= _MIN_SHARD_DIM else None
    if len(shape) == 2 and name.endswith(".weight"):
        return 1 if shape[1] % tp == 0 and shape[1] >= _MIN_SHARD_DIM else None
    if len(shape) == 1 and name.endswith(".bias"):
        return 0 if shape[0] % tp == 0 and shape[0] >= _MIN_SHARD_DIM else None
    return None


def _jax_layout(name: str, shape: tuple[int, ...], transposed: Mapping[str, int]
                ) -> tuple[tuple[int, ...], dict[int, int]]:
    """(the JAX package's shape of the port's parameter ``name``, {JAX dim:
    port dim}); the layouts of ``core.weights.from_jax_params``."""
    if name in transposed:                     # [I, O/g, K] <- [K, I/g, g·O/g]
        i, o_g, k = shape
        g = transposed[name]
        # with groups > 1 JAX's O regroups, and no one port dim is O
        return (k, i // g, g * o_g), ({2: 1} if g == 1 else {})
    if name.endswith(".alpha"):                # [1, C, 1] <- [C]
        return (shape[1],), {0: 1}
    if len(shape) == 3:                        # [O, I/g, K] <- [K, I/g, O]
        return shape[::-1], {0: 2, 1: 1, 2: 0}
    if len(shape) == 4:                        # [O, I, kh, kw] <- [kh, kw, I, O]
        return (shape[2], shape[3], shape[1], shape[0]), {0: 2, 1: 3, 2: 1, 3: 0}
    if len(shape) == 2 and not _keeps_torch_layout(name):   # [out, in] <- [in, out]
        return shape[::-1], {0: 1, 1: 0}
    return shape, {d: d for d in range(len(shape))}


def param_shardings(mesh: DeviceMesh, module: nn.Module) -> dict[str, Placements]:
    """The placements of every tensor of ``module.state_dict()`` by the tp
    rules above."""
    tp = axis_size(mesh, "tp")
    transposed = transposed_groups(module)
    out = {}
    for name, value in module.state_dict().items():
        jax_shape, to_port = _jax_layout(name, tuple(value.shape), transposed)
        dim = _jax_sharded_dim(name, jax_shape, tp)
        dim = to_port.get(dim) if dim is not None else None
        out[name] = replicated(mesh) if dim is None else tp_sharded(dim)
    return out


def _slice(full: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = full.shape[dim] // size
    return full.narrow(dim, rank * n, n).clone()


class _Gathered(nn.Module):
    """The parametrization of a storage-sharded weight: stores this rank's
    slice (``right_inverse``), gives the whole weight at each use."""

    def __init__(self, dim: int, group, rank: int, size: int):
        super().__init__()
        self.dim, self.group, self.rank, self.size = dim, group, rank, size

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        return collectives.gather_at_use(local, self.dim, self.group)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return _slice(full, self.dim, self.rank, self.size)


_PARAMETRIZED = re.compile(r"\.parametrizations\.(\w+)\.original$")


def canonical_name(name: str) -> str:
    """A parameter's name as the unsharded module has it
    (``x.parametrizations.weight.original`` -> ``x.weight``)."""
    return _PARAMETRIZED.sub(r".\1", name)


def canonical_params(module: nn.Module, order: list[str]) -> dict[str, nn.Parameter]:
    """``module``'s parameters under their unsharded names, in ``order``."""
    params = {canonical_name(k): p for k, p in module.named_parameters()}
    return {name: params[name] for name in order}


def _broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank: the mesh starts from
    one set of weights, as JAX's ``device_put`` of one host array."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            collectives.broadcast(t.data, 0, None)


def shard_params(mesh: DeviceMesh, module: nn.Module,
                 shardings: Mapping[str, Placements] | None = None) -> nn.Module:
    """Place each rank's slice of ``module``'s tp-sharded parameters into
    it, by ``shardings`` (default ``param_shardings``, or
    ``dia_param_shardings`` for a Dia). Returns the module."""
    from neuralcodecs_tpu_torch.models.dia.layers import DenseGeneral

    if any(isinstance(m, DenseGeneral) for m in module.modules()):
        return _shard_dia(mesh, module, shardings or dia_param_shardings(mesh, module))
    shardings = shardings or param_shardings(mesh, module)
    _broadcast_module(module)
    group, rank, size = mesh.get_group("tp"), axis_rank(mesh, "tp"), axis_size(mesh, "tp")
    for name, placements in shardings.items():
        dim = sharded_dim(placements)
        if dim is None:
            continue
        owner_name, attr = name.rsplit(".", 1)
        owner = module.get_submodule(owner_name)
        if attr not in owner._parameters:
            raise ValueError(f"{name}: only parameters can be tp-sharded")
        parametrize.register_parametrization(owner, attr, _Gathered(dim, group, rank, size),
                                             unsafe=True)
    return module


def dia_param_shardings(mesh: DeviceMesh, params, min_dim: int = 2
                        ) -> dict[str, Placements]:
    """Megatron-style placements for the Dia transformer's DenseGeneral
    kernels (JAX's rules and dims; ``params`` a state dict or the module).

    Attention q/k/v kernels [D, H, Dh] shard the head dim; o_proj [H, Dh, D]
    reduces over heads (row-parallel); the gated MLP shards the
    intermediate dim on wi_fused [D, 2, I] and reduces on wo [I, D].
    Embeddings, norms and logits stay replicated. int8 kernels keep the
    kernel's ndim and shard alike, their per-output scales with their
    output dims; int4 stores flat [K/2, N] nibbles + [K/G, N] group scales:
    column-parallel layers shard N, row-parallel ones the packed K rows
    (scales follow iff tp divides their K/G rows). wi_fused's q4 / scale4
    flatten (2, I) into N, where a contiguous split would part gate from
    up, so they stay replicated."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    tp = axis_size(mesh, "tp")
    out: dict[str, Placements] = {}
    for name, arr in params.items():
        shape, dim = tuple(arr.shape), None
        if tp > 1:
            def col(ax: int, lo: int = min_dim) -> int | None:
                return ax if shape[ax] % tp == 0 and shape[ax] >= lo else None

            qkv = ("q_proj", "k_proj", "v_proj")
            if name.endswith(tuple(f"{p}.{s}" for p in qkv for s in ("weight", "weight_q8",
                                                                       "weight_scale"))):
                dim = col(1) if len(shape) == 3 else None
            elif name.endswith(("o_proj.weight", "o_proj.weight_q8")):
                dim = col(0) if len(shape) == 3 else None
            elif name.endswith(("wi_fused.weight", "wi_fused.weight_q8",
                                "wi_fused.weight_scale")):
                dim = col(2, 0) if len(shape) == 3 else None
            elif name.endswith(("wo.weight", "wo.weight_q8")):
                dim = col(0, 0) if len(shape) == 2 else None
            elif name.endswith(tuple(f"{p}.{s}" for p in qkv for s in ("weight_q4",
                                                                       "weight_scale4"))):
                dim = col(1) if len(shape) == 2 else None
            elif name.endswith(("o_proj.weight_q4", "o_proj.weight_scale4", "wo.weight_q4",
                                "wo.weight_scale4")):
                dim = col(0) if len(shape) == 2 else None
        out[name] = replicated(mesh) if dim is None else tp_sharded(dim)
    return out


_COLUMN = ("q_proj", "k_proj", "v_proj", "wi_fused")
_ROW = ("o_proj", "wo")


def _shard_dia(mesh: DeviceMesh, dia: nn.Module, shardings: Mapping[str, Placements]
               ) -> nn.Module:
    """Each rank keeps its heads and its slice of each MLP: column-parallel
    layers their slice of the outputs, row-parallel ones their rows, whose
    partial products ``DenseGeneral`` then sums over tp. The ranks must
    hold the same weights (built from one seed or loaded from one file)."""
    from neuralcodecs_tpu_torch.models.dia.layers import Attention, DenseGeneral, MlpBlock

    group, rank, tp = mesh.get_group("tp"), axis_rank(mesh, "tp"), axis_size(mesh, "tp")
    if tp == 1:
        return dia
    split: dict[str, bool] = {}
    for name, layer in dia.named_modules():
        if not isinstance(layer, DenseGeneral):
            continue
        role = name.rsplit(".", 1)[-1]
        dims = {}
        for attr, value in list(layer.named_parameters(recurse=False)) + list(
                layer.named_buffers(recurse=False)):
            dim = sharded_dim(shardings[f"{name}.{attr}"])
            if dim is None:
                continue
            local = _slice(value.data, dim, rank, tp)
            if attr == "weight":
                layer.weight = nn.Parameter(local, requires_grad=False)
            else:
                layer.register_buffer(attr, local)
            dims[attr] = dim
        layer.__dict__.pop("_cast", None)
        kernel = next(a for a in ("weight", "weight_q8", "weight_q4")
                      if a in layer._parameters or a in layer._buffers)
        split[name] = kernel in dims
        if not split[name]:
            continue
        if role in _COLUMN:
            if kernel == "weight_q4":          # [K/2, N]: N = prod(out_features)
                head = layer.out_features[0]
                layer.out_features = (head // tp,) + layer.out_features[1:]
            else:                              # the sharded dim counts from in_shapes
                ax = dims[kernel] - len(layer.in_shapes)
                out = list(layer.out_features)
                out[ax] //= tp
                layer.out_features = tuple(out)
        elif role in _ROW:
            k_full = 2 * layer.weight_q4.shape[0] * tp if kernel == "weight_q4" else None
            layer.in_shapes = (layer.in_shapes[0] // tp,) + layer.in_shapes[1:]
            layer.reduce_group = group
            if kernel == "weight_q4" and "weight_scale4" not in dims:
                layer.int4_rows = (rank * k_full // tp, k_full)
        else:
            raise ValueError(f"{name}: no tp rule for a DenseGeneral named {role}")
    for name, block in dia.named_modules():
        if isinstance(block, Attention):
            parts = [split[f"{name}.{p}"] for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
            if len(set(parts)) > 1:
                raise ValueError(f"{name}: q/k/v/o must shard together, got {parts}")
        elif isinstance(block, MlpBlock):
            wi, wo = split[f"{name}.wi_fused"], split[f"{name}.wo"]
            if wi and not wo:
                raise ValueError(f"{name}: wi_fused sharded but wo replicated")
            if wo and not wi:                  # wi's int4 stays whole: take this rank's slice
                n = block.wo.in_shapes[0]
                block.intermediate = (rank * n, n)
    dia.tp_group = group
    return dia
