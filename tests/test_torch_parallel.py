"""The port's parallel layer against the JAX package's, on the CPU.

The port's meshes span processes: every mesh check runs in one spawn of 4
gloo CPU ranks (``torch_parallel_workers.all_checks``, a file rendezvous in a
temporary directory, one thread a rank), which imports only the port; the JAX side
runs here, jitted, on conftest's 8 virtual CPU devices. Weights are seeded
JAX parameters carried into the port by ``from_jax_params`` (Dia's load
unconverted).

Tolerances:
  * the dp=2 x tp=2 SGD step: each parameter's change within ``GRAD_BAR`` =
    1e-3 of JAX's dp=2 x tp=2 step's (‖Δ_port − Δ_jax‖ / ‖Δ_jax‖, the bar of
    tests/test_torch_train.py's one-device step; the mel gradient is stable
    at the seed used, as asserted); against the port's one-process step on
    the same global batch within ``DP_BAR`` = 1e-4 (the worst tensor 1.1e-5
    here, a Snake alpha): the mean of the dp ranks' local means differs
    from the global mean by f32 summation order only;
  * the checkpoint: bit for bit;
  * ``sharded_encode`` at sp=4: codes equal to JAX's ``sharded_encode``
    codes in at least 99% of places a stage (JAX's own bar against its
    unsharded encode), and in all of them where JAX's sharded run equals its
    unsharded one;
  * Dia tp=2 int4 greedy: codes and lengths equal to JAX's unsharded int4
    generation (JAX's tests/test_parallel.py config and texts);
  * placements: each parameter split by the port where JAX splits it, along
    the dim that holds the same slices.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu.models.dia import Dia as JDia
from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
from neuralcodecs_tpu.parallel import mesh as jmesh
from neuralcodecs_tpu.parallel import sharding as jsharding
from neuralcodecs_tpu.parallel import timeshard as jtimeshard
from neuralcodecs_tpu.parallel import train as jtrain
from neuralcodecs_tpu_torch.core.weights import (
    from_jax_params,
    to_jax_params,
    transposed_groups,
)
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dac.discriminator import DACDiscriminator
from neuralcodecs_tpu_torch.models.dia import Dia
from neuralcodecs_tpu_torch.models.encodec import Encodec
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from neuralcodecs_tpu_torch.parallel import make_train_step, mesh_axes_for
from neuralcodecs_tpu_torch.parallel import restore_train_state
from neuralcodecs_tpu_torch.parallel.launch import run_local
from neuralcodecs_tpu_torch.parallel.timeshard import receptive_field
from test_dia import tiny_config as dia_tiny_config
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dia import port_config as dia_port_config
from test_torch_encodec import port_config as encodec_port_config
from test_torch_train import mel_sensitivity, rel_err
import torch_parallel_workers as workers

GRAD_BAR = 1e-3
DP_BAR = 1e-4
SR = 16000
LR = 0.5
DAC_SEED = 2  # the mel gradient is stable here (asserted below)
DAC_KW = dict(sample_rate=SR, encoder_dim=16, encoder_rates=[2, 4], decoder_dim=256,
              decoder_rates=[4, 2], n_codebooks=2, codebook_size=32, codebook_dim=4)
SNAC_KW = dict(sampling_rate=16000, encoder_dim=16, encoder_rates=[2, 4], decoder_dim=64,
               decoder_rates=[4, 2], attn_window_size=None, codebook_size=64,
               codebook_dim=8, vq_strides=[2, 1], noise=False, depthwise=False)
DIA_TEXTS = ["[S1]hello", "[S2]ok"]


def _carry(jparams, module) -> dict:
    return from_jax_params({k: np.asarray(v) for k, v in jparams.items()},
                           transposed_groups(module))


def _dac_audio() -> np.ndarray:
    hop = int(np.prod(DAC_KW["encoder_rates"]))
    rng = np.random.default_rng(0)
    return (0.1 * rng.standard_normal((4, hop * 64, 1))).astype(np.float32)


def _snac_case(name: str):
    kw = dict(SNAC_KW, attn_window_size=4 if name == "windowed" else None)
    jmodel = JSNAC(JSNACConfig(**kw), seed=0)
    cfg = SNACConfig(**kw)
    port = SNAC(cfg, device="cpu")
    t = cfg.pad_to * 4 * 64 + 37  # ragged, shards >> receptive field
    audio = (0.3 * np.random.default_rng(1).standard_normal(t)).astype(np.float32)
    state = {k: v.numpy() for k, v in _carry(jmodel.params, port).items()}
    return jmodel, (cfg, state, audio)


# ------------------------------------------------------------------ the spawn


@pytest.fixture(scope="module")
def jax_dac():
    jmodel = JDAC(JDACConfig(**DAC_KW), seed=DAC_SEED)
    audio = _dac_audio()
    assert mel_sensitivity(jmodel, audio[:, :, :]) < 1e-4  # a stable reference
    return jmodel, audio


@pytest.fixture(scope="module")
def snac_cases():
    return {name: _snac_case(name) for name in ("plain", "windowed")}


@pytest.fixture(scope="module")
def jax_dia():
    return JDia(dia_tiny_config(data=dataclasses.replace(
        dia_tiny_config().data, audio_length=24)), seed=0)


@pytest.fixture(scope="module")
def placement_cases():
    return _placement_cases()


@pytest.fixture(scope="module")
def spawned(jax_dac, snac_cases, jax_dia, tmp_path_factory):
    """Every rank's results of one 4-rank spawn."""
    jmodel, audio = jax_dac
    port = DAC(DACConfig(**DAC_KW), device="cpu")
    inputs = {
        "dac_config": DACConfig(**DAC_KW),
        "dac_state": {k: v.numpy() for k, v in _carry(jmodel.params, port).items()},
        "audio": audio, "lr": LR, "sr": SR,
        "snac": {name: case[1] for name, case in snac_cases.items()},
        "dia_config": dia_port_config(jax_dia.config),
        "dia_params": {k: np.asarray(v) for k, v in jax_dia.params.items()},
        "dia_texts": DIA_TEXTS,
        "placement_models": _placement_recipes(),
    }
    tmp = tmp_path_factory.mktemp("ranks")
    return run_local(workers.all_checks, 4, (inputs, str(tmp)), timeout=400), tmp


# ------------------------------------------------------------------- the mesh


def test_make_mesh_shapes(spawned):
    meshes = spawned[0][0]["meshes"]
    assert meshes["dp2tp2"] == {"dp": 2, "tp": 2, "sp": 1}
    assert meshes["tp2sp2"] == {"dp": 1, "tp": 2, "sp": 2}
    assert meshes["default"] == {"dp": 4, "tp": 1, "sp": 1}
    assert meshes["error {'dp': 3, 'tp': 2}"] == "mesh 3x2x1 != 4 devices"
    assert "do not divide" in meshes["error {'tp': 3}"]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_mesh_axes_for_matches_jax(n):
    for scale in ("codec", "tts"):
        assert mesh_axes_for(n, scale) == jmesh.mesh_axes_for(n, scale)


def test_collectives_disagree(spawned):
    for results in spawned[0]:
        assert results["disagree"] == {"same": False, "other": True}


# ------------------------------------------------------------- the placements


def _jax_mesh(tp: int = 2):
    return jmesh.make_mesh(dp=8 // tp, tp=tp)


def _jax_dim(spec) -> int | None:
    dims = [i for i, axis in enumerate(spec) if axis == "tp"]
    return dims[0] if dims else None


def _placement_recipes() -> dict:
    """(class, args, kwargs) of port models with layers of >= 256 channels
    (so that tp=2 splits): convs, transposed convs, Linears, an LSTM, 2-D
    convs. The ranks build their own from these."""
    dac_big = dict(DAC_KW, decoder_dim=512)
    snac_big = dict(SNAC_KW, decoder_dim=512, attn_window_size=4, encoder_dim=64)
    enc_big = encodec_tiny_config(num_filters=64, hidden_size=256)
    cpu = {"device": "cpu"}
    return {"dac": (DAC, (DACConfig(**dac_big),), cpu),
            "snac": (SNAC, (SNACConfig(**snac_big),), cpu),
            "encodec": (Encodec, (encodec_port_config(enc_big),), cpu),
            "disc": (DACDiscriminator, (), dict(periods=(2, 3), fft_sizes=(512,), **cpu))}


def _placement_cases() -> dict:
    return {name: cls(*args, **kwargs) for name, (cls, args, kwargs)
            in _placement_recipes().items()}


@pytest.fixture(scope="module")
def placements(spawned, placement_cases):
    """The port's placements of each case's model at tp=2."""
    return placement_cases, spawned[0][0]["placements"]


@pytest.mark.parametrize("name", ["dac", "snac", "encodec", "disc"])
def test_placements_hold_jax_slices(placements, name):
    """JAX's rules on the parameters in the JAX package's layouts
    (``to_jax_params``, the inverse of ``from_jax_params``): where JAX
    splits a parameter over tp, the port splits it too, and each rank's
    slice is the JAX slice in the port's layout; where JAX replicates, the
    port does."""
    cases, got = placements
    port = cases[name]
    groups = transposed_groups(port)
    jparams = to_jax_params(port.state_dict(), groups)
    specs = jsharding.param_shardings(_jax_mesh(), jparams)
    n_split = 0
    for key, value in jparams.items():
        jdim, pdim = _jax_dim(specs[key].spec), got[name][key]
        assert (jdim is None) == (pdim is None), (key, jdim, pdim)
        if jdim is None:
            continue
        n_split += 1
        for r, chunk in enumerate(np.split(value, 2, axis=jdim)):
            port_chunk = from_jax_params({key: chunk}, {key: groups[key]} if key in groups
                                         else None)[key]
            mine = torch.chunk(port.state_dict()[key], 2, dim=pdim)[r]
            assert torch.equal(mine, port_chunk), (key, r)
    assert n_split > 0


def test_param_shardings_jax_cases(placements):
    """tests/test_parallel.py's rule cases, on modules of the same names."""
    got = placements[1]["rules"]
    assert got == {"decoder.model.0.weight": 0, "decoder.model.0.bias": 0,
                   "small.weight": None, "small.bias": None,
                   "quantizer.codebook.weight": None, "head.weight": 0, "head.bias": 0,
                   "up.weight": 1, "up.bias": 0}


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
def test_dia_placements_match_jax(placements, jax_dia, mode):
    """JAX's dia_param_shardings on the port's Dia tensors (the JAX
    package's names and layouts, its int8 / int4 bytes)."""
    got = placements[1][f"dia_{mode}"]
    dia = Dia(dia_port_config(jax_dia.config), device="cpu")
    if mode != "f32":
        dia.quantize_int8() if mode == "int8" else dia.quantize_int4(group_size=8)
    params = {k: v.numpy() for k, v in dia.state_dict().items()}
    specs = jsharding.dia_param_shardings(_jax_mesh(), params)
    assert set(got) == set(specs)
    for key, sharding in specs.items():
        assert got[key] == _jax_dim(sharding.spec), key
    split = {k for k, v in got.items() if v is not None}
    assert len(split) > 0 and all(not k.endswith("wi_fused.weight_q4") for k in split)


# -------------------------------------------------------------- the train step


def test_dac_train_step_on_mesh_matches_jax(spawned, jax_dac):
    """JAX's jitted dp=2 x tp=2 SGD step against the port's, from the same
    parameters on the same global batch."""
    jmodel, audio = jax_dac
    init_fn, step_fn = jtrain.make_train_step(jmodel, jmesh.make_mesh(dp=2, tp=2,
                                                                      devices=jax.devices()[:4]),
                                              optax.sgd(LR), sample_rate=SR)
    # the jitted step donates its inputs: hand it copies
    state, loss = step_fn(init_fn({k: jnp.array(v) for k, v in jmodel.params.items()}),
                          jnp.asarray(audio))
    jparams, jloss = {k: np.asarray(v) for k, v in state.params.items()}, float(loss)
    port = DAC(DACConfig(**DAC_KW), device="cpu")
    before = _carry(jmodel.params, port)
    want = _carry(jparams, port)
    for results in spawned[0]:
        train = results["train"]
        np.testing.assert_allclose(train["loss1"], jloss, rtol=1e-4)
        for key, w in want.items():
            delta_port = train["step1"][key].astype(np.float64) - before[key].double().numpy()
            delta_jax = w.double().numpy() - before[key].double().numpy()
            assert rel_err(delta_port, delta_jax) <= GRAD_BAR, key


def test_mesh_step_matches_one_process_step(spawned, jax_dac):
    """dp=2 x tp=2 against the port's own step on the whole batch."""
    jmodel, audio = jax_dac
    port = DAC(DACConfig(**DAC_KW), device="cpu")
    port.load_state_dict(_carry(jmodel.params, port))
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    init_fn, step_fn = make_train_step(port, None, functools.partial(torch.optim.SGD, lr=LR))
    state, loss = step_fn(init_fn(), torch.from_numpy(audio))
    train = spawned[0][0]["train"]
    np.testing.assert_allclose(train["loss1"], float(loss), rtol=DP_BAR)
    for key, p in state.params.items():
        delta_mesh = train["step1"][key].astype(np.float64) - before[key].double().numpy()
        delta_one = p.detach().double().numpy() - before[key].double().numpy()
        assert rel_err(delta_mesh, delta_one) <= DP_BAR, key
    # every rank holds the same whole parameters
    for results in spawned[0][1:]:
        for key, value in results["train"]["step1"].items():
            np.testing.assert_array_equal(value, train["step1"][key])


def test_remat_on_the_mesh_gives_the_same_step(spawned):
    """remat=True on dp=2 x tp=2 (the gathers run again in the backward)."""
    train = spawned[0][0]["train"]
    assert train["remat_loss"] == train["loss1"]
    for key, value in train["step1"].items():
        np.testing.assert_allclose(train["remat"][key], value, rtol=1e-6, atol=1e-8,
                                   err_msg=key)


def test_mesh_step_stores_tp_slices(spawned):
    train = spawned[0][0]["train"]
    full = train["step1"]
    split = 0
    for key, placement in train["placements"].items():
        if "Shard" in placement and key in full:
            dim = int(placement.split("Shard(dim=")[1][0])
            shape = list(full[key].shape)
            shape[dim] //= 2
            assert train["local_shapes"][key] == tuple(shape), key
            split += 1
    assert split > 0
    assert "does not divide over dp=2" in train["odd_batch"]


def test_checkpoint_on_mesh_restores_bit_for_bit(spawned, jax_dac):
    """Save after step 1, step again, restore: the state is step 1's bit for
    bit; a step from it repeats step 2 bit for bit. The files hold whole
    tensors, which a one-device restore reads."""
    results, tmp = spawned
    for r in results:
        train = r["train"]
        assert train["restored_step"] == 2  # the saved step (1), stepped once
        for key, value in train["step1"].items():
            np.testing.assert_array_equal(train["restored"][key], value, err_msg=key)
        for key, value in train["step2"].items():
            np.testing.assert_array_equal(train["again"][key], value, err_msg=key)
        assert train["loss3"] == train["loss2"]
    port = DAC(DACConfig(**DAC_KW), device="cpu")
    init_fn, _ = make_train_step(port, None, functools.partial(torch.optim.SGD, lr=LR))
    one = restore_train_state(tmp / "ckpt", init_fn())
    assert one.step == 1
    for key, p in one.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), results[0]["train"]["step1"][key])


# ------------------------------------------------------------- sharded encode


def test_receptive_field_is_jax_s():
    for rates in ([2, 4], [2, 4, 8, 8], [3, 5, 7]):
        assert receptive_field(rates) == jtimeshard.receptive_field(rates)


@pytest.mark.parametrize("name", ["plain", "windowed"])
def test_sharded_encode_matches_jax(spawned, snac_cases, name):
    jmodel, (_, _, audio) = snac_cases[name]
    mesh = jmesh.make_mesh(dp=1, tp=1, sp=4, devices=jax.devices()[:4])
    encode = jax.jit(lambda a: jtimeshard.sharded_encode(jmodel, mesh, a))
    want = [np.asarray(c) for c in encode(jnp.asarray(audio))]
    ref = [np.asarray(c) for c in jmodel.encode(audio)]
    for results in spawned[0]:
        got = results["encode"][name]
        assert len(got) == len(want)
        for stage, (g, w, u) in enumerate(zip(got, want, ref)):
            assert g.shape == w.shape == u.shape, stage
            match = (g == w).mean()
            assert match >= 0.99, (stage, match)
            if (w == u).all():
                assert match == 1.0, (stage, match)


def test_sharded_encode_refuses_short_audio(spawned):
    assert "audio too short to time-shard over sp=4" in spawned[0][0]["encode"]["too_short"]


# ------------------------------------------------------------------- Dia tp


def test_dia_tp_int4_codes_equal_jax(spawned, jax_dia):
    """tests/test_parallel.py's tiny Dia at int4 (group 8), greedy, sharded
    tp=2 in two dp replicas: the codes of JAX's unsharded int4 model."""
    jdia = JDia(jax_dia.config, seed=0).quantize_int4(group_size=8)
    want_codes, want_len = jdia.generate_codes(DIA_TEXTS, max_tokens=20, seed=3,
                                               temperature=0.0)
    for results in spawned[0]:
        np.testing.assert_array_equal(results["dia"]["lengths"], np.asarray(want_len))
        np.testing.assert_array_equal(results["dia"]["codes"], np.asarray(want_codes))


def test_dia_tp_holds_half_the_heads(spawned, jax_dia):
    dia = Dia(dia_port_config(jax_dia.config), device="cpu").quantize_int4(group_size=8)
    full = tuple(dia.decoder.layers[0].self_attention.q_proj.weight_q4.shape)
    assert {r["dia"]["tp_rank"] for r in spawned[0]} == {0, 1}
    for results in spawned[0]:
        assert results["dia"]["q4_local"] == (full[0], full[1] // 2)
