"""Time-axis sequence parallelism for long-audio encode (counterpart of
neuralcodecs_tpu.parallel.timeshard).

Each rank of the mesh's ``sp`` axis encodes its slice of the time axis plus
``halo`` samples of each neighbour's context, then crops to its own frames.
With halo >= the encoder's receptive field, interior codes equal the
unsharded encode's up to near-ties. The halos come from a halo exchange
(``collectives.halo_exchange``, an all-reduce of every rank's edges) where
JAX uses ``lax.ppermute``; the codes are gathered whole on every rank.

Windowed-attention configs (SNAC 32k/44.1k) keep their shard boundaries on
the global window grid (``pad_to`` is a multiple of ``attn_window_size ·
hop``); attention mixes whole windows, so the conv halo is rounded up to
whole windows and one more window covers the post-attention depthwise taps.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from neuralcodecs_tpu_torch.parallel import collectives
from neuralcodecs_tpu_torch.parallel.mesh import axis_rank, axis_size


def receptive_field(encoder_rates, kernel: int = 7, dilations=(1, 3, 9)) -> int:
    """Conservative one-sided receptive field of a SNAC/DAC-style encoder
    in input samples."""
    rf = kernel  # stem conv
    stride_total = 1
    for rate in encoder_rates:
        # 3 residual units (two convs each) + strided conv, at current rate
        block = sum((kernel - 1) * d for d in dilations) + 2 * rate
        rf += block * stride_total
        stride_total *= rate
    return rf


def default_halo(cfg) -> int:
    """The halo in samples, aligned to the frame unit ``cfg.pad_to``."""
    halo = receptive_field(cfg.encoder_rates)
    attn_w = getattr(cfg, "attn_window_size", None)
    if attn_w:
        span = attn_w * cfg.hop_length
        halo = (-(-halo // span) + 1) * span
    return halo


@torch.no_grad()
def sharded_encode(model, mesh: DeviceMesh, audio, halo: int | None = None
                   ) -> list[torch.Tensor]:
    """SNAC encode with the time axis sharded over the mesh's ``sp`` axis.

    audio: [B, T] or [T] (the whole clip, on every rank). Returns the
    per-stage codes [B, frames_i] on every rank, as ``model.encode`` gives
    them for halo >= the receptive field."""
    cfg = model.config
    sp, idx = axis_size(mesh, "sp"), axis_rank(mesh, "sp")
    group = mesh.get_group("sp")
    a = torch.as_tensor(audio, dtype=torch.float32, device=model.device)
    if a.dim() == 1:
        a = a[None, :]
    b, t = a.shape

    # per-shard length: a multiple of the code alignment unit, so that the
    # shard boundaries land on the global window grid
    unit = cfg.pad_to
    shard_len = -(-t // (sp * unit)) * unit
    halo = default_halo(cfg) if halo is None else halo
    halo = -(-halo // unit) * unit
    if halo > shard_len:
        raise ValueError(
            f"audio too short to time-shard over sp={sp}: per-shard length "
            f"{shard_len} < halo {halo} (the halo exchange sends one "
            f"neighbor's edge, so shards must cover the receptive field)")
    hop = cfg.hop_length
    halo_frames = halo // hop

    a = torch.nn.functional.pad(a, (0, sp * shard_len - t))
    chunk = a[:, idx * shard_len:(idx + 1) * shard_len].contiguous()
    from_left, from_right = collectives.halo_exchange(chunk, halo, group)
    ext = torch.cat([from_left, chunk, from_right], dim=1)[:, None, :].contiguous()

    t_pad = -(-t // unit) * unit
    out = []
    for stage_codes, vq in zip(model._encode_fn(ext), model.quantizer.quantizers):
        lo = halo_frames // vq.stride
        n = (shard_len // hop) // vq.stride
        local = stage_codes[:, lo:lo + n].contiguous()
        # crop the (sp·shard_len)-padded stream to the unsharded encode's
        # frames of a ceil(t/unit)·unit padded signal
        whole = collectives.gather_cat(local, 1, group)
        out.append(whole[:, : t_pad // (hop * vq.stride)])
    return out
