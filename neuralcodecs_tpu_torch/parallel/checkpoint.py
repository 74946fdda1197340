"""Training checkpoints: a TrainState's parameters, optimizer state and step
(counterpart of neuralcodecs_tpu.parallel.checkpoint).

The JAX package writes orbax directories, which cannot be read without JAX;
the port writes its own format into ``directory``:

  * ``params.safetensors``: the parameters by name, in torch's layouts;
  * ``opt_state.safetensors``: every tensor of the optimizer's state, named
    ``{param index}.{key}``;
  * ``train_state.json``: the step, the optimizer's param groups, the
    state's values that are not tensors and the names of its 0-d tensors
    (such as AdamW's ``step``), which the container stores as [1].

Both files of tensors go through ``core/safetensors_io`` (numpy, no pickle).

A state on a mesh is written whole: each tp-sharded parameter, and each
tensor of its optimizer state, is gathered from its slices, and rank 0
writes the files, so a one-device restore reads them too. Restoring onto
a mesh slices each tensor for the template's rank by its placement.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from neuralcodecs_tpu_torch.core.safetensors_io import load_safetensors, save_safetensors
from neuralcodecs_tpu_torch.parallel import collectives
from neuralcodecs_tpu_torch.parallel.mesh import axis_rank, axis_size
from neuralcodecs_tpu_torch.parallel.sharding import sharded_dim
from neuralcodecs_tpu_torch.parallel.train import TrainState

_PARAMS, _OPT, _META = "params.safetensors", "opt_state.safetensors", "train_state.json"


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dims(state: TrainState) -> list[int | None]:
    """The tp-sharded dim of each parameter, in the optimizer's order."""
    if state.mesh is None:
        return [None] * len(state.params)
    return [sharded_dim(state.placements[name]) for name in state.params]


def save_train_state(state: TrainState, directory: str | Path) -> Path:
    """Write the full TrainState under ``directory`` (made if missing). On a
    mesh every rank calls it (the sharded tensors are gathered) and rank 0
    writes."""
    directory = Path(directory).absolute()
    dims = _dims(state)
    group = None if state.mesh is None else state.mesh.get_group("tp")

    def whole(t: torch.Tensor, dim: int | None) -> np.ndarray:
        t = t.detach()
        return _numpy(t if dim is None else collectives.gather_cat(t, dim, group))

    params = {k: whole(v, d) for (k, v), d in zip(state.params.items(), dims)}
    opt = state.opt_state.state_dict()
    tensors, values, scalars = {}, {}, []
    for index, entry in opt["state"].items():
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                tensors[f"{index}.{key}"] = whole(value, dims[index] if value.dim() else None)
                if value.dim() == 0:
                    scalars.append(f"{index}.{key}")
            else:
                values[f"{index}.{key}"] = value
    if state.mesh is None or dist.get_rank() == 0:
        directory.mkdir(parents=True, exist_ok=True)
        save_safetensors(directory / _PARAMS, params)
        save_safetensors(directory / _OPT, tensors)
        (directory / _META).write_text(json.dumps(
            {"step": int(state.step), "param_groups": opt["param_groups"], "values": values,
             "scalars": scalars},
            indent=1))
    if state.mesh is not None:
        dist.barrier()
    return directory


def restore_train_state(directory: str | Path, template: TrainState) -> TrainState:
    """Load a saved TrainState into ``template`` (a state from the same
    model and optimizer, e.g. a fresh ``init_fn()``): its parameters are
    overwritten in place and its optimizer's state replaced. On a mesh each
    rank takes its slices, by the template's placements. Returns the
    template with the saved step."""
    directory = Path(directory).absolute()
    meta = json.loads((directory / _META).read_text())
    params = load_safetensors(directory / _PARAMS)
    if params.keys() != template.params.keys():
        raise ValueError(f"{directory}: saved parameters {sorted(params)[:5]}... are not "
                         f"the template's")
    dims = _dims(template)
    tp = 1 if template.mesh is None else axis_size(template.mesh, "tp")
    rank = 0 if template.mesh is None else axis_rank(template.mesh, "tp")

    def mine(full: np.ndarray, dim: int | None) -> torch.Tensor:
        if dim is not None:
            n = full.shape[dim] // tp
            full = np.take(full, np.arange(rank * n, (rank + 1) * n), axis=dim)
        return torch.tensor(full)

    with torch.no_grad():
        for (name, value), dim in zip(template.params.items(), dims):
            value.copy_(mine(params[name], dim))
    state: dict[int, dict] = {}
    scalars = set(meta["scalars"])
    for name, value in load_safetensors(directory / _OPT).items():
        index, key = name.split(".", 1)
        value = value.reshape(()) if name in scalars else value
        dim = None if name in scalars else dims[int(index)]
        state.setdefault(int(index), {})[key] = mine(value, dim)
    for name, value in meta["values"].items():
        index, key = name.split(".", 1)
        state.setdefault(int(index), {})[key] = value
    template.opt_state.load_state_dict({"state": state, "param_groups": meta["param_groups"]})
    return TrainState(template.params, template.opt_state, int(meta["step"]), template.mesh,
                      template.placements)
