"""The collectives of the parallel layer, written out (JAX's XLA inserts
them: the psum of gradients over dp, the all-gathers at tp boundaries,
Dia's row-parallel psum, ``ppermute`` for the sp halo).

Every one goes through ``all_reduce(SUM)`` or ``broadcast``, the two
collectives that both backends take on CUDA tensors: gloo has no CUDA
``all_gather`` or ``send`` / ``recv``, and gloo is what two ranks sharing
one card must use (NCCL refuses them). An all-gather is an all-reduce of a
zeroed buffer into which each rank writes its slice, exact because x + 0 =
x; the halo exchange gathers every rank's two edges the same way. So one
code path serves gloo on one card and NCCL on many. (A gathered -0.0 comes
back +0.0.)

Native NCCL ``all_gather`` / ``send`` are a later speed step (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Group = dist.ProcessGroup


def all_reduce_sum(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """In place; every collective below comes through here."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src_group_rank: int, group: Group | None) -> torch.Tensor:
    """In place, from the group's rank ``src_group_rank``."""
    src = src_group_rank if group is None else dist.get_global_rank(group, src_group_rank)
    dist.broadcast(t, src=src, group=group)
    return t


def gather_cat(local: torch.Tensor, dim: int, group: Group | None) -> torch.Tensor:
    """Concatenate the group's ``local`` slices (equal shapes) along
    ``dim`` in group-rank order, on every rank. No gradient."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, rank * n, n).copy_(local)
    return all_reduce_sum(full, group)


class _GatherAtUse(torch.autograd.Function):
    """A tp-sharded parameter gathered whole for its use; the backward
    hands back this rank's slice of the gradient. Every rank of the group
    computes the same full-weight gradient (the tp ranks share their
    batch), so no sum is needed there."""

    @staticmethod
    def forward(ctx, local, dim, group):
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), local.shape[dim]
        return gather_cat(local.detach(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def gather_at_use(local: torch.Tensor, dim: int, group: Group | None) -> torch.Tensor:
    return _GatherAtUse.apply(local, dim, group)


class _RowParallelSum(torch.autograd.Function):
    """The sum of a row-parallel product's partial outputs over tp; its
    gradient reaches every rank whole."""

    @staticmethod
    def forward(ctx, partial, group):
        return all_reduce_sum(partial.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def row_parallel_sum(partial: torch.Tensor, group: Group | None) -> torch.Tensor:
    return _RowParallelSum.apply(partial, group)


def mean_grads_(params, group: Group | None, values: torch.Tensor) -> torch.Tensor:
    """Average every ``param.grad`` over ``group`` in place, in one
    all-reduce of a flat f32 buffer; ``values`` (the step's losses) ride
    along and come back averaged."""
    params = [p for p in params if p.grad is not None]
    parts = [p.grad.reshape(-1) for p in params] + [values.detach().reshape(-1).float()]
    flat = all_reduce_sum(torch.cat(parts), group) / dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat[offset:].view_as(values).to(values.dtype)


def halo_exchange(chunk: torch.Tensor, halo: int, group: Group | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(left neighbour's last ``halo`` samples, right neighbour's first) of
    ``chunk`` [B, T] along the group's ranks; zeros at the global edges.
    Every rank's two edges go through one [sp, 2, B, halo] buffer."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    b = chunk.shape[0]
    buf = torch.zeros(size, 2, b, halo, dtype=chunk.dtype, device=chunk.device)
    buf[rank, 0] = chunk[:, -halo:]
    buf[rank, 1] = chunk[:, :halo]
    all_reduce_sum(buf, group)
    zeros = torch.zeros(b, halo, dtype=chunk.dtype, device=chunk.device)
    from_left = buf[rank - 1, 0] if rank > 0 else zeros
    from_right = buf[rank + 1, 1] if rank < size - 1 else zeros
    return from_left, from_right


def disagree(values: torch.Tensor, group: Group | None) -> torch.Tensor:
    """A 0-d bool on the device, the same on every rank: whether the
    group's ranks hold different ``values`` (integers). One all-reduce of
    (x, x²): the ranks agree everywhere iff size · Σx² = (Σx)²
    elementwise, exactly in int64."""
    x = values.to(torch.int64).reshape(1, -1)
    sums = all_reduce_sum(torch.cat([x, x * x]), group)
    return torch.any(dist.get_world_size(group) * sums[1] != sums[0] * sums[0])
