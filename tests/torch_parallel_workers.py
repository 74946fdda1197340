"""Rank bodies of the port's parallel tests: what each gloo CPU process
runs. They import the port and numpy only (no JAX, nothing of the JAX
package), so that the spawned ranks do not either; the test files make the
JAX side's results in the parent and compare.

``all_checks`` is one 4-rank spawn that runs every mesh check of
tests/test_torch_parallel.py and returns its results as numpy arrays;
``ema_check`` the dp=4 EMA update of tests/test_torch_quantize_train.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from neuralcodecs_tpu_torch.parallel import collectives
from neuralcodecs_tpu_torch.parallel.mesh import axis_rank, make_mesh, mesh_shape


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _whole_params(state) -> dict:
    """The state's parameters gathered whole (every rank takes part)."""
    from neuralcodecs_tpu_torch.parallel.sharding import sharded_dim

    out = {}
    group = state.mesh.get_group("tp")
    for name, p in state.params.items():
        dim = sharded_dim(state.placements[name])
        out[name] = _np(p if dim is None else collectives.gather_cat(p.detach(), dim, group))
    return out


def _meshes() -> dict:
    out = {"dp2tp2": mesh_shape(make_mesh(dp=2, tp=2, devices="cpu")),
           "tp2sp2": mesh_shape(make_mesh(tp=2, sp=2, devices="cpu")),
           "default": mesh_shape(make_mesh(devices="cpu"))}
    for kwargs in (dict(dp=3, tp=2), dict(tp=3)):
        try:
            make_mesh(devices="cpu", **kwargs)
        except ValueError as e:
            out[f"error {kwargs}"] = str(e)
    return out


def _train(inputs: dict, tmp: str) -> dict:
    from neuralcodecs_tpu_torch.models.dac import DAC
    from neuralcodecs_tpu_torch.parallel import (
        make_train_step,
        param_shardings,
        restore_train_state,
        save_train_state,
    )

    mesh = make_mesh(dp=2, tp=2, devices="cpu")
    model = DAC(inputs["dac_config"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["dac_state"].items()})
    placements = param_shardings(mesh, model)
    sgd = functools.partial(torch.optim.SGD, lr=inputs["lr"])
    init_fn, step_fn = make_train_step(model, mesh, sgd, sample_rate=inputs["sr"])
    audio = torch.from_numpy(inputs["audio"])
    state = init_fn()
    local_shapes = {k: tuple(p.shape) for k, p in state.params.items()}
    state, loss1 = step_fn(state, audio)
    step1 = _whole_params(state)
    save_train_state(state, f"{tmp}/ckpt")
    state, loss2 = step_fn(state, audio)
    step2 = _whole_params(state)
    restored = restore_train_state(f"{tmp}/ckpt", template=state)
    back = _whole_params(restored)
    restored, loss3 = step_fn(restored, audio)
    try:
        step_fn(restored, audio[:3])
        odd_batch = None
    except ValueError as e:
        odd_batch = str(e)
    # remat on the mesh: a second model, one step under torch.utils.checkpoint
    other = DAC(inputs["dac_config"], device="cpu")
    other.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["dac_state"].items()})
    r_init, r_step = make_train_step(other, mesh, sgd, sample_rate=inputs["sr"], remat=True)
    r_state, r_loss = r_step(r_init(), audio)
    return {"remat": _whole_params(r_state), "remat_loss": float(r_loss),
            "placements": {k: str(v) for k, v in placements.items()},
            "local_shapes": local_shapes, "loss1": float(loss1), "loss2": float(loss2),
            "loss3": float(loss3), "step1": step1, "step2": step2, "restored": back,
            "restored_step": restored.step, "again": _whole_params(restored),
            "odd_batch": odd_batch}


def _encode(inputs: dict) -> dict:
    from neuralcodecs_tpu_torch.models.snac import SNAC
    from neuralcodecs_tpu_torch.parallel import sharded_encode

    mesh = make_mesh(dp=1, tp=1, sp=4, devices="cpu")
    out = {}
    for name, (cfg, state, audio) in inputs["snac"].items():
        model = SNAC(cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        out[name] = [_np(c) for c in sharded_encode(model, mesh, audio)]
    try:
        sharded_encode(model, mesh, audio[: cfg.pad_to])
        out["too_short"] = None
    except ValueError as e:
        out["too_short"] = str(e)
    return out


def _dia(inputs: dict) -> dict:
    from neuralcodecs_tpu_torch.models.dia import Dia
    from neuralcodecs_tpu_torch.parallel import shard_params

    mesh = make_mesh(dp=2, tp=2, devices="cpu")
    dia = Dia(inputs["dia_config"], device="cpu")
    dia.load_state_dict(inputs["dia_params"])
    dia.quantize_int4(group_size=8)
    shard_params(mesh, dia)
    q4 = dia.decoder.layers[0].self_attention.q_proj.weight_q4.shape
    codes, lengths = dia.generate_codes(inputs["dia_texts"], max_tokens=20, seed=3,
                                        temperature=0.0)
    return {"codes": np.asarray(codes), "lengths": np.asarray(lengths),
            "q4_local": tuple(q4), "tp_rank": axis_rank(mesh, "tp")}


def _disagreement() -> dict:
    """collectives.disagree on values the ranks share and on values that
    differ on one rank only."""
    group = make_mesh(dp=1, tp=4, devices="cpu").get_group("tp")
    same = torch.arange(6)
    other = torch.arange(6)
    if dist.get_rank() == 3:
        other[2] = 7
    return {"same": bool(collectives.disagree(same, group)),
            "other": bool(collectives.disagree(other, group))}


def _dims(placements: dict) -> dict:
    from neuralcodecs_tpu_torch.parallel.sharding import sharded_dim

    return {k: sharded_dim(v) for k, v in placements.items()}


def _placements(recipes: dict, dia_config) -> dict:
    """The tp-sharded dim (or None) of every tensor: of each model that
    ``recipes`` ({name: (class, args, kwargs)}) builds, of modules named as
    tests/test_parallel.py's rule cases, and of a Dia in f32, int8 and
    int4 (group 8), on a dp=2 x tp=2 mesh."""
    from torch import nn

    from neuralcodecs_tpu_torch.models.dia import Dia
    from neuralcodecs_tpu_torch.parallel import dia_param_shardings, param_shardings

    mesh = make_mesh(dp=2, tp=2, devices="cpu")
    out = {name: _dims(param_shardings(mesh, cls(*args, **kwargs)))
           for name, (cls, args, kwargs) in recipes.items()}
    rules = nn.Module()
    rules.decoder = nn.Module()
    rules.decoder.model = nn.Sequential(nn.Conv1d(128, 512, 7))   # sharded on O
    rules.small = nn.Conv1d(4, 8, 7)                              # too small
    rules.quantizer = nn.Module()
    rules.quantizer.codebook = nn.Embedding(1024, 8)               # a codebook
    rules.head = nn.Linear(64, 512)                                # out = dim 0
    rules.up = nn.ConvTranspose1d(64, 512, 4)                      # O = dim 1
    out["rules"] = _dims(param_shardings(mesh, rules))
    for mode in ("f32", "int8", "int4"):
        dia = Dia(dia_config, device="cpu")
        if mode == "int8":
            dia.quantize_int8()
        elif mode == "int4":
            dia.quantize_int4(group_size=8)
        out[f"dia_{mode}"] = _dims(dia_param_shardings(mesh, dia))
    return out


def all_checks(rank: int, inputs: dict, tmp: str) -> dict:
    torch.set_num_threads(1)
    return {"meshes": _meshes(), "train": _train(inputs, tmp), "encode": _encode(inputs),
            "dia": _dia(inputs), "disagree": _disagreement(),
            "placements": _placements(inputs["placement_models"], inputs["dia_config"])}


def ema_check(rank: int, inputs: dict) -> dict:
    """The EMA step of one codebook over dp=4, each rank with its quarter
    of the rows (and codes), the batch statistics summed over dp."""
    from neuralcodecs_tpu_torch.models.encodec.quantize import CodebookState, EuclideanCodebook

    torch.set_num_threads(1)
    mesh = make_mesh(dp=4, devices="cpu")
    dim, size = inputs["embed"].shape[1], inputs["embed"].shape[0]
    cb = EuclideanCodebook(dim, size)
    state = CodebookState(*(torch.from_numpy(inputs[k]) for k in CodebookState._fields))
    r = axis_rank(mesh, "dp")
    n = inputs["flat_x"].shape[0] // 4
    x = torch.from_numpy(inputs["flat_x"][r * n:(r + 1) * n])
    codes = torch.from_numpy(inputs["codes"][r * n:(r + 1) * n])
    got = cb.ema_update(state, x, codes, dp_group=mesh.get_group("dp"))
    return {k: _np(v) for k, v in got._asdict().items()}
