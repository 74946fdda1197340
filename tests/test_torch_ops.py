"""The PyTorch port's ops and kernel plain versions against the JAX package.

Inputs are made with numpy from a seed and fed to both the JAX function and
its counterpart in neuralcodecs_tpu_torch; weights are laid out the JAX
way and converted with the port's ``from_jax_params``. On the CPU the kernel
wrappers run their plain PyTorch versions, which are what is compared here;
the CUDA kernels themselves are held against those plain versions on the GPU
by ``chip_smoke.py``.

Tolerances: rtol 1e-4 / atol 1e-5 where the two frameworks sum a
contraction in different orders (convs, attention, the residual unit);
rtol 1e-5 / atol 1e-6 for elementwise ops (sin differs by ulps between
XLA's and torch's CPU kernels); codes are compared bit-exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.ops import conv as jconv
from neuralcodecs_tpu_torch.core.weights import fold_weight_norm, from_jax_params
from neuralcodecs_tpu_torch.ops import kernels
from neuralcodecs_tpu_torch.ops.conv import conv1d, conv_transpose1d
from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t, biquad_df2t_plain
from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin, codebook_argmin_plain
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow, envelope_follow_plain
from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan, lstm_scan_plain
from neuralcodecs_tpu_torch.ops.kernels.resunit import (
    fused_residual_unit,
    fused_residual_unit_dense,
    residual_unit_plain,
)
from neuralcodecs_tpu_torch.ops.snake import snake

ROOT = Path(__file__).resolve().parents[1]


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _btc(a: np.ndarray) -> np.ndarray:
    """[B, C, T] <-> [B, T, C]."""
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 1)))


def test_snake_matches_jax(rng):
    from neuralcodecs_tpu.ops.snake import snake as jsnake

    x = _rand(rng, 2, 8, 16)
    alpha = _rand(rng, 8)
    alpha[0] = 0.0  # the α == 0 guard
    want = _btc(jsnake(_btc(x), alpha))
    got = snake(_t(x), _t(alpha).reshape(1, -1, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])


@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation,groups", [
    (8, 16, 4, 2, 1, 1, 1),      # strided
    (16, 16, 7, 1, 9, 3, 16),    # depthwise, dilated
])
def test_conv1d_matches_jax(rng, cin, cout, k, stride, padding, dilation, groups):
    x = _rand(rng, 2, cin, 64)
    w_hio = _rand(rng, k, cin // groups, cout)
    bias = _rand(rng, cout)
    want = _btc(jconv.conv1d(_btc(x), w_hio, bias, stride=stride, padding=padding,
                             dilation=dilation, groups=groups))
    w = from_jax_params({"c.weight": w_hio})["c.weight"]
    got = conv1d(_t(x), w, _t(bias), stride=stride, padding=padding,
                 dilation=dilation, groups=groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cin,cout,k,stride,padding,output_padding,groups", [
    (16, 8, 4, 2, 1, 0, 1),      # stride 2
    (16, 8, 6, 3, 2, 1, 1),      # stride 3, output_padding 1 (SNAC 44 kHz)
    (16, 16, 4, 2, 1, 0, 4),     # grouped: the regrouping inversion
])
def test_conv_transpose1d_matches_jax(rng, cin, cout, k, stride, padding,
                                      output_padding, groups):
    x = _rand(rng, 2, cin, 32)
    w_hio = _rand(rng, k, cin // groups, cout)
    bias = _rand(rng, cout)
    want = _btc(jconv.conv_transpose1d(_btc(x), w_hio, bias, stride=stride,
                                       padding=padding, output_padding=output_padding,
                                       groups=groups))
    w = from_jax_params({"c.weight": w_hio}, {"c.weight": groups})["c.weight"]
    assert tuple(w.shape) == (cin, cout // groups, k)
    got = conv_transpose1d(_t(x), w, _t(bias), stride=stride, padding=padding,
                           output_padding=output_padding, groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_local_mha_matches_jax(rng):
    from neuralcodecs_tpu.ops.attention import local_mha as jlocal_mha

    from neuralcodecs_tpu_torch.ops.attention import local_mha

    b, c, t, window, heads = 2, 128, 32, 8, 2
    x = _rand(rng, b, c, t)
    params = {"m.norm.weight": 1 + _rand(rng, c, scale=0.1),
              "m.norm.bias": _rand(rng, c, scale=0.1),
              "m.to_qkv.weight": _rand(rng, c, 3 * c, scale=c ** -0.5),
              "m.to_out.weight": _rand(rng, c, c, scale=c ** -0.5)}
    want = _btc(jlocal_mha(_btc(x), norm_scale=params["m.norm.weight"],
                           norm_bias=params["m.norm.bias"],
                           qkv_weight=params["m.to_qkv.weight"],
                           out_weight=params["m.to_out.weight"],
                           window_size=window, num_heads=heads))
    sd = from_jax_params(params)
    got = local_mha(_t(x), norm_scale=sd["m.norm.weight"], norm_bias=sd["m.norm.bias"],
                    qkv_weight=sd["m.to_qkv.weight"], out_weight=sd["m.to_out.weight"],
                    window_size=window, num_heads=heads).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("normalized", [False, True])
def test_codebook_plain_matches_xla(rng, normalized):
    from neuralcodecs_tpu.ops.vq import _l2_argmin_xla, l2_normalize

    x = _rand(rng, 300, 8)
    cb = _rand(rng, 4096, 8)
    if normalized:
        x, cb = np.asarray(l2_normalize(x)), np.asarray(l2_normalize(cb))
    want = np.asarray(_l2_argmin_xla(x, cb))
    got = codebook_argmin_plain(_t(x), _t(cb)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_codebook_plain_matches_pallas_interpret_with_tie(rng):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.codebook import l2_argmin_pallas

    base = _rand(rng, 500, 8)
    cb = np.concatenate([base, base[:12]])  # entries 500.. duplicate 0..11
    x = np.concatenate([base[:12], _rand(rng, 288, 8)])  # rows 0..11 hit a tie
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(l2_argmin_pallas(x, cb))
    got = codebook_argmin_plain(_t(x), _t(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:12], np.arange(12))  # lowest index wins


def _resunit_jax_params(rng, c, groups, k=7):
    return {"alpha1": _rand(rng, c), "alpha2": _rand(rng, c),
            "wd": _rand(rng, k, c // groups, c, scale=0.1), "bd": _rand(rng, c, scale=0.1),
            "w1": _rand(rng, 1, c, c, scale=0.1), "b1": _rand(rng, c, scale=0.1)}


def _resunit_port_args(p):
    sd = from_jax_params({"a.alpha": p["alpha1"], "b.alpha": p["alpha2"],
                          "wd": p["wd"], "w1": p["w1"]})
    return (sd["a.alpha"], sd["wd"], _t(p["bd"]), sd["b.alpha"], sd["w1"], _t(p["b1"]))


def test_resunit_plain_matches_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.resunit import fused_residual_unit as jfused

    t, c, d = 256, 128, 3
    x = _rand(rng, 1, c, t, scale=0.5)
    p = _resunit_jax_params(rng, c, groups=c)
    with pltpu.force_tpu_interpret_mode():
        want = _btc(jfused(_btc(x), p["alpha1"], p["wd"], p["bd"], p["alpha2"], p["w1"],
                           p["b1"], k=7, dilation=d, depthwise=True))
    got = residual_unit_plain(_t(x), *_resunit_port_args(p), dilation=d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_resunit_dense_plain_matches_pallas_interpret(rng):
    """The dense form (groups = 1, DAC). The Pallas kernel runs its dilated
    conv as one [T, 7·C] x [7·C, C] product in three bf16 passes (hi·hi +
    hi·lo + lo·hi), which drops the lo·lo term: about 2^-16 of each product,
    over K = 7·128 = 896 terms. Measured max abs err 6.3e-5 on outputs up to
    8.9, hence rtol 1e-4 / atol 1e-4 here (1e-5 for the f32 chains above)."""
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.resunit import fused_residual_unit as jfused

    t, c, d = 256, 128, 3
    x = _rand(rng, 1, c, t, scale=0.5)
    p = _resunit_jax_params(rng, c, groups=1)
    with pltpu.force_tpu_interpret_mode():
        want = _btc(jfused(_btc(x), p["alpha1"], p["wd"], p["bd"], p["alpha2"], p["w1"],
                           p["b1"], k=7, dilation=d, depthwise=False))
    got = residual_unit_plain(_t(x), *_resunit_port_args(p), dilation=d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dilation,groups", [(1, 48), (3, 48), (9, 48), (3, 1)])
def test_resunit_matches_jax_residual_unit(rng, dilation, groups):
    from neuralcodecs_tpu.models.layers import ResidualUnit as JResidualUnit

    from neuralcodecs_tpu_torch.models.layers import ResidualUnit

    c = 48
    junit = JResidualUnit("ru", c, dilation=dilation, groups=groups)
    params = {}
    junit.init(jax.random.key(dilation), params)
    params["ru.block.0.alpha"] = jnp.asarray(1 + _rand(rng, c, scale=0.3))
    x = _rand(rng, 2, c, 200)
    want = _btc(junit(params, _btc(x)))
    unit = ResidualUnit(c, dilation=dilation, groups=groups)
    sd = from_jax_params({k[len("ru."):]: np.asarray(v) for k, v in params.items()})
    unit.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = unit(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


_NO_LAUNCHES = {"codebook_argmin": 0, "fused_residual_unit": 0,
                "fused_residual_unit_dense": 0, "lstm_scan": 0, "envelope_follow": 0,
                "biquad_df2t": 0}


def _lstm_inputs(rng, t, b, h):
    """gates_x [T, B, 4H], w_hh in the JAX layout [H, 4H], h0, c0 [B, H]."""
    return (_rand(rng, t, b, 4 * h, scale=0.3), _rand(rng, h, 4 * h, scale=0.1),
            _rand(rng, b, h, scale=0.2), _rand(rng, b, h, scale=0.2))


def _lstm_port_args(gx, w_hh, h0, c0):
    """The port takes w_hh in torch's layout [4H, H]."""
    return _t(gx), _t(np.ascontiguousarray(w_hh.T)), _t(h0), _t(c0)


def _assert_lstm_close(got, want):
    for g, w, name in zip(got, want, ("ys", "h_f", "c_f")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("t,b", [(6, 1), (15, 4)])
def test_lstm_plain_matches_jax_scan(rng, t, b):
    from neuralcodecs_tpu.models.encodec.seanet import _lstm_recurrence

    inputs = _lstm_inputs(rng, t, b, 128)
    want = _lstm_recurrence(*(jnp.asarray(a) for a in inputs))
    _assert_lstm_close(lstm_scan_plain(*_lstm_port_args(*inputs)), want)


@pytest.mark.parametrize("t,b", [(6, 1), (15, 4)])
def test_lstm_plain_matches_pallas_interpret(rng, t, b):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.lstm import lstm_scan_pallas

    inputs = _lstm_inputs(rng, t, b, 128)
    with pltpu.force_tpu_interpret_mode():
        want = lstm_scan_pallas(*(jnp.asarray(a) for a in inputs))
    _assert_lstm_close(lstm_scan_plain(*_lstm_port_args(*inputs)), want)


def test_slstm_matches_jax(rng):
    """The port's SLSTM (per-layer input projection by matmul, recurrence by
    lstm_scan) against the JAX package's, from the same JAX parameters."""
    from neuralcodecs_tpu.models.encodec.seanet import SLSTM as JSLSTM

    from neuralcodecs_tpu_torch.models.encodec.seanet import SLSTM

    dim = 32
    jlayer = JSLSTM("s", dim, 2)
    params = {}
    jlayer.init(jax.random.key(1), params)
    x = _rand(rng, 3, dim, 21)
    want = _btc(jlayer(params, jnp.asarray(_btc(x))))
    layer = SLSTM(dim, 2)
    layer.load_state_dict(from_jax_params({k[2:]: np.asarray(v) for k, v in params.items()}),
                          strict=True)
    with torch.no_grad():
        got = layer(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_run_plain_on_cpu_without_counting(rng):
    kernels.reset_launch_counts()
    x, cb = _t(_rand(rng, 64, 8)), _t(_rand(rng, 256, 8))
    torch.testing.assert_close(codebook_argmin(x, cb), codebook_argmin_plain(x, cb),
                               rtol=0, atol=0)
    p = _resunit_jax_params(rng, 16, groups=16)
    xr = _t(_rand(rng, 1, 16, 50))
    args = _resunit_port_args(p)
    torch.testing.assert_close(fused_residual_unit(xr, *args, dilation=3),
                               residual_unit_plain(xr, *args, dilation=3), rtol=0, atol=0)
    dense = _resunit_port_args(_resunit_jax_params(rng, 16, groups=1))
    for fn in (fused_residual_unit, fused_residual_unit_dense):
        torch.testing.assert_close(fn(xr, *dense, dilation=9),
                                   residual_unit_plain(xr, *dense, dilation=9), rtol=0, atol=0)
    largs = _lstm_port_args(*_lstm_inputs(rng, 5, 2, 16))
    for got, want in zip(lstm_scan(*largs), lstm_scan_plain(*largs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    xs = _t(_rand(rng, 3, 40, scale=0.3))
    torch.testing.assert_close(envelope_follow(xs, 0.2, 0.01),
                               envelope_follow_plain(xs, 0.2, 0.01), rtol=0, atol=0)
    b, a = (0.2, 0.3, 0.1), (1.0, -0.5, 0.25)
    torch.testing.assert_close(biquad_df2t(xs, [(b, a)]), biquad_df2t_plain(xs, b, a),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == _NO_LAUNCHES


def test_wrappers_refuse_tensors_off_cpu_and_cuda(rng):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor raises instead of falling back to the plain version."""
    x, cb = torch.empty(8, 8, device="meta"), torch.empty(64, 8, device="meta")
    with pytest.raises(ValueError):
        codebook_argmin(x, cb)
    p = _resunit_jax_params(rng, 16, groups=16)
    with pytest.raises(ValueError):
        fused_residual_unit(torch.empty(1, 16, 20, device="meta"),
                            *_resunit_port_args(p), dilation=1)
    dense = _resunit_port_args(_resunit_jax_params(rng, 16, groups=1))
    for fn in (fused_residual_unit, fused_residual_unit_dense):
        with pytest.raises(ValueError):
            fn(torch.empty(1, 16, 20, device="meta"), *dense, dilation=3)
    h = 16
    with pytest.raises(ValueError):
        lstm_scan(torch.empty(4, 2, 4 * h, device="meta"), torch.empty(4 * h, h),
                  torch.empty(2, h), torch.empty(2, h))
    with pytest.raises(ValueError):
        envelope_follow(torch.empty(2, 100, device="meta"), 0.2, 0.01)
    with pytest.raises(ValueError):
        biquad_df2t(torch.empty(2, 100, device="meta"), [((1.0, 0.0, 0.0), (1.0, 0.0, 0.0))])
    assert kernels.launch_counts() == _NO_LAUNCHES


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    from neuralcodecs_tpu_torch.core.exceptions import KernelBuildError
    from neuralcodecs_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises((KernelBuildError, OSError)):
        build.load_library()


def test_from_jax_params_inverts_jax_layouts(rng):
    w_conv = _rand(rng, 12, 4, 5)          # [Cout, Cin/g, K]
    w_t1 = _rand(rng, 8, 6, 4)             # [Cin, Cout/g, K], groups 1
    w_t4 = _rand(rng, 8, 3, 4)             # groups 4
    lin = _rand(rng, 24, 8)                # torch Linear [out, in]
    jax_params = {
        "conv.weight": jconv.torch_conv_weight_to_hio(w_conv),
        "t1.weight": jconv.torch_conv_transpose_weight_to_hio(w_t1, 1),
        "t4.weight": jconv.torch_conv_transpose_weight_to_hio(w_t4, 4),
        "lin.weight": lin.T, "s.alpha": np.arange(5, dtype=np.float32),
        "q.codebook.weight": lin,
    }
    sd = from_jax_params(jax_params, {"t1.weight": 1, "t4.weight": 4})
    np.testing.assert_array_equal(sd["conv.weight"].numpy(), w_conv)
    np.testing.assert_array_equal(sd["t1.weight"].numpy(), w_t1)
    np.testing.assert_array_equal(sd["t4.weight"].numpy(), w_t4)
    np.testing.assert_array_equal(sd["lin.weight"].numpy(), lin)
    np.testing.assert_array_equal(sd["q.codebook.weight"].numpy(), lin)
    assert tuple(sd["s.alpha"].shape) == (1, 5, 1)


def test_fold_weight_norm_matches_jax(rng):
    from neuralcodecs_tpu.core.importer import fold_weight_norm as jfold

    sd = {"a.weight_g": _rand(rng, 6, 1, 1), "a.weight_v": _rand(rng, 6, 3, 7),
          "b.parametrizations.weight.original0": _rand(rng, 4, 1, 1),
          "b.parametrizations.weight.original1": _rand(rng, 4, 2, 5),
          "c.bias": _rand(rng, 6)}
    want, got = jfold(sd), fold_weight_norm(sd)
    assert set(got) == set(want) == {"a.weight", "b.weight", "c.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_linear_resample_matches_jax(rng):
    from neuralcodecs_tpu.dsp.resample import linear_resample as jresample

    from neuralcodecs_tpu_torch.dsp.resample import linear_resample

    x = _rand(rng, 2, 1000)
    for src, dst in ((16000, 24000), (44100, 24000), (24000, 24000)):
        want = np.asarray(jresample(x, src, dst))
        got = linear_resample(_t(x), src, dst).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_disable_tf32():
    from neuralcodecs_tpu_torch.ops.precision import disable_tf32, tf32_disabled

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        disable_tf32()
        assert tf32_disabled()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_import_turns_tf32_off():
    """A fresh process: torch's defaults leave cuDNN's TF32 on; importing
    the port turns both flags off."""
    code = ("import torch\n"
            "assert torch.backends.cudnn.allow_tf32\n"
            "import neuralcodecs_tpu_torch\n"
            "from neuralcodecs_tpu_torch.ops.precision import tf32_disabled\n"
            "assert tf32_disabled()\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


LOADER_MODULES = ("cache", "events", "export", "files", "importer", "interfaces", "loader",
                  "operations", "registry", "repos", "retry", "safetensors_io", "torch_pickle",
                  "validation", "weights", "zoo")


def test_port_imports_without_jax():
    """The facade, every core module of the loader stack and every other
    module of the port import with no JAX and nothing of the JAX package."""
    code = ("import sys, pkgutil, importlib, neuralcodecs_tpu_torch as p\n"
            "from neuralcodecs_tpu_torch import (load_model, load_snac, load_dac, load_encodec,\n"
            "    load_dia, load_pretrained, save_pretrained, load_zoo_model, zoo_models,\n"
            "    ModelLoader, ModelRegistry, registry)\n"
            f"for name in {LOADER_MODULES!r}:\n"
            "    importlib.import_module('neuralcodecs_tpu_torch.core.' + name)\n"
            "assert registry.architectures() == ['dac', 'dia', 'encodec', 'snac']\n"
            "for m in pkgutil.walk_packages(p.__path__, 'neuralcodecs_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'neuralcodecs_tpu.'))"
            " or m == 'neuralcodecs_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
