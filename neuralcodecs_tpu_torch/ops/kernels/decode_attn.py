"""Decode attention: the CUDA kernel csrc/decode_attn.cu and its plain version.

Replaces no Pallas kernel: the JAX package leaves Dia's decode-step
attention to XLA inside its jitted loop. Here the plain form of a step is
Dia's layer functions (``models/dia/layers.py``: ``apply_rope``, the cache
write, ``_blocked_decode_attn`` or a full read through ``sdpa_gqa``), some
80 small launches a layer that widen and copy the whole bf16 cache every
step; the kernel reads each live K/V byte once (see the header of
csrc/decode_attn.cu, the self kernel; csrc/decode_attn_cross.cu). The step
is bound by bytes.

``decode_self_attn``: one decode step of self-attention, q, k, v the
projections' outputs [B, 1, N, Dh]: q and k rotated (RoPE), k and v written
into slot ``index`` of the cache in place, attention over slots 0..index.
``decode_cross_attn``: one query position against the cross cache under a
key mask. Each is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors of bf16, f32 or f64, or an error; ``.launches``
counts kernel launches. The step index and positions are read on the
device, so a launch captured into a CUDA graph is right at every step.

The self kernel's arithmetic is the blocked read's (f32 scores, softmax and
weighted sum, v widened); it reads the live slots whatever read the plain
version is given (``block``, ``n_blocks``). An int8 cache is not the
kernel's: Dia's layer calls ``decode_self_attn_plain`` for it on every
device. The kernels have no backward: on CUDA tensors that require grad, in
grad mode, the wrappers raise.
"""

from __future__ import annotations

import torch

from neuralcodecs_tpu_torch.ops.kernels.build import (check, device_and_stream, load_library,
                                                      refuse_grad)

CHUNK = 64  # cache slots a block of the self kernel (csrc/decode_attn.cu kChunk)
MAX_SLOTS = 64 * CHUNK  # the self kernel's buffer at most (kMaxChunks chunks)
HEAD_DIMS = (8, 16, 128)  # the kernels' instances: Dia's and its test configurations'
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_CROSS_WARPS = 16  # warps of a cross-attention block (decode_attn_cross.cu kCrossThreads)
_CROSS_SMEM = 40 * 1024  # its scores and partial sums in shared memory, at most


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def decode_self_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache,
                           position: torch.Tensor, index: int | torch.Tensor,
                           timescale: torch.Tensor, *, block: int = 0,
                           n_blocks: int | None = None, kv_dot: bool = False) -> torch.Tensor:
    """q [B, 1, Nq, Dh], k / v [B, 1, Nkv, Dh], ``cache`` a KVCacheSlot,
    position [B, 1] -> [B, 1, Nq, Dh] in q's dtype: RoPE on q and k, the
    slot write (``cache.update``), then the blocked read (``block`` > 0, at
    ``n_blocks`` blocks, ``kv_dot`` on an int8 cache) or the full read."""
    from neuralcodecs_tpu_torch.models.dia.layers import (_blocked_decode_attn, apply_rope,
                                                          sdpa_gqa)

    q = apply_rope(q, position, timescale)
    cache.update(apply_rope(k, position, timescale), v, index)
    if block:
        return _blocked_decode_attn(q, cache, index, block, int8_dot=kv_dot, n_blocks=n_blocks)
    ck, cv = cache.kv(q.dtype)
    live = torch.arange(ck.shape[1], device=q.device) <= index
    return sdpa_gqa(q, ck, cv, live.expand(q.shape[0], 1, ck.shape[1]))


def decode_cross_attn_plain(q: torch.Tensor, cache, mask: torch.Tensor | None,
                            position: torch.Tensor, timescale: torch.Tensor) -> torch.Tensor:
    """q [B, T, Nq, Dh] against the cross cache (a KVCacheSlot [B, S, Nkv,
    Dh]) under mask [B, T, S] -> [B, T, Nq, Dh]: RoPE on q, then
    ``sdpa_gqa``."""
    from neuralcodecs_tpu_torch.models.dia.layers import apply_rope, sdpa_gqa

    return sdpa_gqa(apply_rope(q, position, timescale), cache.k, cache.v, mask)


def _check(name: str, tensors: dict[str, torch.Tensor], timescale: torch.Tensor) -> None:
    q = tensors["q"]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: {q.dtype}, want one of {list(_DTYPES)}")
    for key, t in (*tensors.items(), ("timescale", timescale)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} on {t.device}, want {q.device} (cuda)")
    for key, t in tensors.items():
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, want {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
    b, t_len, nq, dh = q.shape
    cache_k = tensors["k_cache"]
    nkv = cache_k.shape[2]
    if t_len != 1 or dh not in HEAD_DIMS or nq % nkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} against a cache of {nkv} heads: want "
                         f"one position, Dh in {HEAD_DIMS}, Nq a multiple of Nkv")
    for key, t in tensors.items():
        if key != "q" and (t.dim() != 4 or t.shape[0] != b or t.shape[2:] != (nkv, dh)):
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, want [{b}, *, {nkv}, {dh}]")
    if timescale.dtype != _acc_dtype(q.dtype) or tuple(timescale.shape) != (dh // 2,):
        raise ValueError(f"{name}: timescale {timescale.dtype} {tuple(timescale.shape)}, "
                         f"want {_acc_dtype(q.dtype)} [{dh // 2}]")


def _positions(position: torch.Tensor, b: int) -> tuple[torch.Tensor, int]:
    """The rows' positions as int64 on the device and their stride."""
    pos = position.to(torch.int64).reshape(-1, 1).expand(b, 1)
    return pos, pos.stride(0)


def decode_self_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache,
                     position: torch.Tensor, index: int | torch.Tensor,
                     timescale: torch.Tensor, *, block: int = 0,
                     n_blocks: int | None = None, kv_dot: bool = False) -> torch.Tensor:
    """One self-attention decode step (see ``decode_self_attn_plain``); on
    CUDA the kernel, which takes a float cache and ``index`` as a [1] int64
    device tensor."""
    if q.device.type == "cpu":
        return decode_self_attn_plain(q, k, v, cache, position, index, timescale,
                                      block=block, n_blocks=n_blocks, kv_dot=kv_dot)
    if cache.k_scale is not None:
        raise TypeError("decode_self_attn: an int8 cache is not the kernel's "
                        "(decode_self_attn_plain reads it)")
    _check("decode_self_attn", {"q": q, "k": k, "v": v, "k_cache": cache.k,
                                "v_cache": cache.v}, timescale)
    refuse_grad("decode_self_attn", q, k, v)
    if not isinstance(index, torch.Tensor) or index.numel() != 1 or index.dtype != torch.int64 \
            or index.device != q.device:
        raise ValueError("decode_self_attn: index must be a [1] int64 tensor on the device")
    b, _, nq, dh = q.shape
    max_t, nkv = cache.k.shape[1], cache.k.shape[2]
    if max_t > MAX_SLOTS:
        raise ValueError(f"decode_self_attn: a cache of {max_t} slots, the kernel takes at "
                         f"most {MAX_SLOTS}")
    chunks = -(-max_t // CHUNK)
    acc = _acc_dtype(q.dtype)
    pos, pos_stride = _positions(position, b)
    out = torch.empty_like(q)
    part = torch.empty(b * nq * chunks * (dh + 2), dtype=acc, device=q.device)
    ml = part.data_ptr() + b * nq * chunks * dh * part.element_size()
    rc = load_library().nc_decode_attn_self(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), cache.k.data_ptr(),
        cache.v.data_ptr(), pos.data_ptr(), pos_stride, index.data_ptr(), timescale.data_ptr(),
        out.data_ptr(), part.data_ptr(), ml, b, max_t, nq, nkv, dh, chunks,
        *device_and_stream(q))
    check(rc, "nc_decode_attn_self")
    decode_self_attn.launches += 1
    return out


decode_self_attn.launches = 0


def decode_cross_attn(q: torch.Tensor, cache, mask: torch.Tensor | None,
                      position: torch.Tensor, timescale: torch.Tensor) -> torch.Tensor:
    """One query position against the cross cache (see
    ``decode_cross_attn_plain``); on CUDA the kernel, which takes q [B, 1,
    Nq, Dh] and a bool mask [B, 1, S] or None."""
    if q.device.type == "cpu":
        return decode_cross_attn_plain(q, cache, mask, position, timescale)
    _check("decode_cross_attn", {"q": q, "k_cache": cache.k, "v_cache": cache.v}, timescale)
    refuse_grad("decode_cross_attn", q)
    b, _, nq, dh = q.shape
    s, nkv = cache.k.shape[1], cache.k.shape[2]
    heads = min(nq // nkv, 4)    # query heads a block (kGroup)
    if heads * max(s, _CROSS_WARPS * dh) * _acc_dtype(q.dtype).itemsize > _CROSS_SMEM:
        raise ValueError(f"decode_cross_attn: {s} keys of {heads} heads of {dh} do not fit "
                         "the kernel's shared memory")
    mask_ptr, mask_stride = 0, 0
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != q.device or mask.shape[-1] != s \
                or mask.shape[-2] != 1 or mask.shape[0] not in (1, b):
            raise ValueError(f"decode_cross_attn: mask {mask.dtype} {tuple(mask.shape)} on "
                             f"{mask.device}, want bool [{b}, 1, {s}] on {q.device}")
        mask = mask.reshape(-1, s)
        if mask.stride(-1) != 1:
            mask = mask.contiguous()
        mask = mask.expand(b, s)
        mask_ptr, mask_stride = mask.data_ptr(), mask.stride(0)
    pos, pos_stride = _positions(position, b)
    out = torch.empty_like(q)
    rc = load_library().nc_decode_attn_cross(
        _DTYPES[q.dtype], q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(), mask_ptr,
        mask_stride, pos.data_ptr(), pos_stride, timescale.data_ptr(), out.data_ptr(), b, s, nq,
        nkv, dh, *device_and_stream(q))
    check(rc, "nc_decode_attn_cross")
    decode_cross_attn.launches += 1
    return out


decode_cross_attn.launches = 0
