"""Device meshes over ``torch.distributed`` (counterpart of
neuralcodecs_tpu.parallel.mesh).

Axis conventions, as in the JAX package:
  * ``dp``: data parallel (batch axis), the one that pays for the codecs;
  * ``tp``: tensor parallel (channel / head axis), for Dia 1.6B;
  * ``sp``: sequence / time parallel for long-audio encode (halo exchange,
    parallel/timeshard.py).

Where JAX's ``Mesh`` is one process over many devices, a mesh here spans
processes: one rank a mesh slot, each rank running the same program
(``torch.distributed.device_mesh.DeviceMesh``). The ranks join a process
group first (``initialize_distributed``); with none and a mesh of one slot,
``make_mesh`` starts a world-1 group itself.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "tp", "sp")

log = logging.getLogger(__name__)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def choose_backend(ranks_on_host: int) -> tuple[str, str]:
    """(backend, the rule that chose it): NCCL when each of the host's
    ``ranks_on_host`` ranks has a card of its own, gloo otherwise (no card,
    or several ranks sharing one: NCCL refuses two ranks on one device)."""
    if not torch.cuda.is_available():
        return "gloo", "no CUDA device: gloo on the CPU"
    cards = torch.cuda.device_count()
    if cards >= ranks_on_host:
        return "nccl", f"{ranks_on_host} rank(s) on {cards} card(s), a card each: NCCL"
    return "gloo", f"{ranks_on_host} ranks share {cards} card(s): gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``. ``coordinator_address`` is ``host:port`` (rank 0
    listens there) or an init-method URL (``tcp://...``, ``file://...``).
    A no-op for one process and when a group exists already. The backend
    follows ``choose_backend`` over the ranks of this host
    (``LOCAL_WORLD_SIZE``, else all of them)."""
    if num_processes in (None, 1) or dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address and process_id "
                         f"for {num_processes} processes")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend, rule = choose_backend(on_host)
    log.info("rank %d of %d: backend %s (%s)", process_id, num_processes, backend, rule)
    dist.init_process_group(backend, init_method=url, rank=process_id,
                            world_size=num_processes)


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1,
              devices: str | None = None) -> DeviceMesh:
    """A (dp, tp, sp) mesh over the process group's ranks; dp defaults to
    world / (tp · sp). Axis order (dp, tp, sp): tp and sp neighbours are
    consecutive ranks.

    ``devices`` is the device type, "cuda" by default (each rank then uses
    card ``local_rank % device_count``: on a one-card machine every rank
    shares cuda:0) and "cpu" for the tests."""
    device_type = devices or "cuda"
    if not dist.is_initialized():
        if (dp or 1) * tp * sp != 1:
            raise RuntimeError(f"a {dp}x{tp}x{sp} mesh needs a process group: call "
                               "initialize_distributed in every rank first")
        backend, rule = choose_backend(1) if device_type == "cuda" else ("gloo", "CPU mesh")
        log.info("world-1 process group: backend %s (%s)", backend, rule)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if dp is None:
        if n % (tp * sp):
            raise ValueError(f"{n} ranks do not divide into tp={tp} x sp={sp}")
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"mesh {dp}x{tp}x{sp} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank(dist.get_rank()) % torch.cuda.device_count())
    return init_device_mesh(device_type, (dp, tp, sp), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{"dp": .., "tp": .., "sp": ..}, as ``dict(jax_mesh.shape)``."""
    return {axis: axis_size(mesh, axis) for axis in AXES}


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_axes_for(n_devices: int, model_scale: str = "codec") -> tuple[int, int, int]:
    """Heuristic (dp, tp, sp) split.

    Codecs (SNAC/DAC/Encodec, <200M params): pure DP.
    Dia-1.6B ("tts"): tp up to 4 for decode latency, rest dp.
    """
    if model_scale == "tts" and n_devices >= 4:
        tp = 4
        return n_devices // tp, tp, 1
    if model_scale == "tts" and n_devices >= 2:
        return n_devices // 2, 2, 1
    return n_devices, 1, 1
