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
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from neuralcodecs_tpu_torch.core.safetensors_io import load_safetensors, save_safetensors
from neuralcodecs_tpu_torch.parallel.train import TrainState

_PARAMS, _OPT, _META = "params.safetensors", "opt_state.safetensors", "train_state.json"


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_train_state(state: TrainState, directory: str | Path) -> Path:
    """Write the full TrainState under ``directory`` (made if missing)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    opt = state.opt_state.state_dict()
    tensors, values, scalars = {}, {}, []
    for index, entry in opt["state"].items():
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                tensors[f"{index}.{key}"] = _numpy(value)
                if value.dim() == 0:
                    scalars.append(f"{index}.{key}")
            else:
                values[f"{index}.{key}"] = value
    save_safetensors(directory / _PARAMS, {k: _numpy(v) for k, v in state.params.items()})
    save_safetensors(directory / _OPT, tensors)
    (directory / _META).write_text(json.dumps(
        {"step": int(state.step), "param_groups": opt["param_groups"], "values": values,
         "scalars": scalars},
        indent=1))
    return directory


def restore_train_state(directory: str | Path, template: TrainState) -> TrainState:
    """Load a saved TrainState into ``template`` (a state from the same
    model and optimizer, e.g. a fresh ``init_fn()``): its parameters are
    overwritten in place and its optimizer's state replaced. Returns the
    template with the saved step."""
    directory = Path(directory).absolute()
    meta = json.loads((directory / _META).read_text())
    params = load_safetensors(directory / _PARAMS)
    if params.keys() != template.params.keys():
        raise ValueError(f"{directory}: saved parameters {sorted(params)[:5]}... are not "
                         f"the template's")
    with torch.no_grad():
        for name, value in template.params.items():
            value.copy_(torch.tensor(params[name]))
    state: dict[int, dict] = {}
    scalars = set(meta["scalars"])
    for name, value in load_safetensors(directory / _OPT).items():
        index, key = name.split(".", 1)
        value = value.reshape(()) if name in scalars else value
        state.setdefault(int(index), {})[key] = torch.tensor(value)
    for name, value in meta["values"].items():
        index, key = name.split(".", 1)
        state.setdefault(int(index), {})[key] = value
    template.opt_state.load_state_dict({"state": state, "param_groups": meta["param_groups"]})
    return TrainState(template.params, template.opt_state, int(meta["step"]))
