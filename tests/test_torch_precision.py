"""The port's codec precision modes against the JAX package's, on the CPU.

SNAC, DAC and Encodec take ``compute_dtype`` (the encoder's input dtype)
and ``decoder_dtype`` (the decoder's, default ``compute_dtype``), as the
JAX models do. JAX's semantics make each mode bf16 for one conv a stage
only: the conv casts its weight to the input's dtype and then adds the f32
bias, and jnp promotes bf16 + f32 to f32 (``neuralcodecs_tpu/ops/conv.py``).
The port reproduces that, so on the tiny configs of the JAX package's own
tests:

- the codes of the mixed mode (``decoder_dtype=bf16``) are JAX's and the
  port's own f32 mode's, bit for bit; those of the full bf16 mode
  (``compute_dtype=bf16``) are JAX's: its first conv rounds the same bf16
  products on both sides, and on these inputs no code lies at a near-tie
  (the test counts the codes that differ: none);
- the decoded audio is within twice the mode's own bf16 error (JAX's mode
  against JAX's f32) of JAX's audio, plus the f32 tolerance: XLA fuses a
  cast to bf16 into the ops around it and may keep the f32 value there
  (its CPU fusions allow excess precision), where torch rounds at every
  cast, so the two differ by at most about the bf16 rounding itself;
- the dtype flow is JAX's: the convs and products the port dispatches,
  counted by dtype with a ``TorchDispatchMode``, equal those of JAX's
  traced jaxpr (a scan's body counted once a step), one bf16 conv a stage;
- no kernel wrapper (codebook, residual unit, LSTM) is handed anything but
  f32.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
from neuralcodecs_tpu.ops.conv import conv1d as jconv1d
from neuralcodecs_tpu.ops.conv import conv_transpose1d as jconv_transpose1d
from neuralcodecs_tpu.ops.conv import torch_conv_transpose_weight_to_hio, torch_conv_weight_to_hio
from neuralcodecs_tpu_torch import load_dac, load_encodec, load_snac
from neuralcodecs_tpu_torch.core.export import save_pretrained
from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models import layers as port_layers
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.encodec import Encodec, seanet
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from neuralcodecs_tpu_torch.ops import conv as port_conv
from neuralcodecs_tpu_torch.ops import vq as port_vq
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dac import tiny_kwargs as dac_kwargs
from test_torch_encodec import port_config as encodec_port_config
from test_torch_snac import tiny_kwargs as snac_kwargs

BF16 = torch.bfloat16
MODES = {"mixed": "decoder_dtype", "bf16": "compute_dtype"}
F32_ATOL = 1e-5
PRODUCTS = {"mm", "bmm", "addmm", "mv", "dot", "addmv", "baddbmm", "addbmm"}


def _audio(shape, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def jaxpr_counts(closed) -> dict:
    """{(kind, dtype): n} of the convs and dot products in a traced jaxpr,
    inner jaxprs included; a scan's body counts once for each of its steps."""
    out: dict = {}

    def walk(jaxpr, mult):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name in ("conv_general_dilated", "dot_general"):
                key = ("conv" if name.startswith("conv") else "dot",
                       str(eqn.invars[0].aval.dtype))
                out[key] = out.get(key, 0) + mult
            inner = mult * (eqn.params["length"] if name == "scan" else 1)
            for value in eqn.params.values():
                for sub in value if isinstance(value, (tuple, list)) else [value]:
                    sub = getattr(sub, "jaxpr", sub)   # a ClosedJaxpr's Jaxpr
                    if hasattr(sub, "eqns"):
                        walk(sub, inner)

    walk(closed.jaxpr, 1)
    return out


class DispatchCounts(TorchDispatchMode):
    """{(kind, dtype): n} of the convolutions and matrix products dispatched."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        kind = "conv" if name == "convolution" else "dot" if name in PRODUCTS else None
        if kind:
            key = (kind, str(args[0].dtype).removeprefix("torch."))
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def kernel_dtypes(monkeypatch):
    """Every dtype handed to the three kernel wrappers the codecs call."""
    seen = set()

    def record(module, name):
        plain = getattr(module, name)

        def wrapper(*args, **kw):
            seen.update(a.dtype for a in args if isinstance(a, torch.Tensor))
            return plain(*args, **kw)
        monkeypatch.setattr(module, name, wrapper)

    record(port_layers, "fused_residual_unit")
    record(port_vq, "codebook_argmin")
    record(seanet, "lstm_scan")
    return seen


# ------------------------------------------------------------- per family
# Each family: the seeded JAX model in a mode and the port with its weights,
# then (encode, decode) on each side. Encode takes padded audio and gives
# codes; decode takes JAX's codes and gives audio in the port's layout.


def _snac(mode_kw: dict):
    kwargs = snac_kwargs()
    jmodel = JSNAC(JSNACConfig(**kwargs), seed=0, **mode_kw["jax"])
    port = SNAC(SNACConfig(**kwargs), device="cpu", **mode_kw["port"])
    port.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                                         transposed_groups(port)), strict=True)
    audio = _audio((2, 1000))
    jpad, _ = jmodel._prepare(audio)
    ppad, _ = port._prepare(audio)
    return {
        "jax": jmodel, "port": port.eval(), "audio": audio,
        "jax_encode": (lambda p: jmodel._encode_fn(p, jpad)),
        "jax_decode": (lambda p, codes: jmodel._decode_fn(p, codes, None)),
        "port_encode": lambda: [c.numpy() for c in port._encode_fn(ppad)],
        "port_decode": lambda codes: port._decode_fn(
            [torch.from_numpy(np.array(c)) for c in codes], None)[:, 0].numpy(),
        "to_port_audio": lambda a: np.asarray(a)[:, :, 0],
    }


def _dac(mode_kw: dict):
    kwargs = dac_kwargs()
    jmodel = JDAC(JDACConfig(**kwargs), seed=0, **mode_kw["jax"])
    port = DAC(DACConfig(**kwargs), device="cpu", **mode_kw["port"])
    port.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                                         transposed_groups(port)), strict=True)
    audio = _audio((2, 85))
    jpad, _ = jmodel._prepare(audio)
    ppad, _ = port._prepare(audio)
    return {
        "jax": jmodel, "port": port.eval(), "audio": audio,
        "jax_encode": lambda p: jmodel._encode_fn(p, jpad, None)[1],
        "jax_decode": lambda p, codes: jmodel._decode_fn(p, jmodel._from_codes_fn(p, codes)),
        "port_encode": lambda: port._encode_fn(ppad, None)[1].numpy(),
        "port_decode": lambda codes: port._decode_fn(port.quantizer.from_codes(
            torch.from_numpy(np.array(codes))))[:, 0].numpy(),
        "to_port_audio": lambda a: np.asarray(a)[:, :, 0],
    }


def _encodec(mode_kw: dict):
    jcfg = encodec_tiny_config()
    jmodel = JEncodec(jcfg, seed=0, **mode_kw["jax"])
    port = Encodec(encodec_port_config(jcfg), device="cpu", **mode_kw["port"])
    port.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                                         transposed_groups(port)), strict=True)
    audio = _audio((2, 1, 2000))
    n_q = port._n_q()
    encode = jmodel._encode_frame_fn(n_q, jmodel.config.normalize)
    return {
        "jax": jmodel, "port": port.eval(), "audio": audio,
        "jax_encode": lambda p: encode(p, jnp.asarray(audio.transpose(0, 2, 1)))[0],
        "jax_decode": lambda p, codes: jmodel._decode_frame_fn(p, codes, None),
        "port_encode": lambda: port._encode_frame(torch.from_numpy(audio), n_q).codes.numpy(),
        "port_decode": lambda codes: port._decode_frame(torch.from_numpy(np.array(codes)),
                                                        None).numpy(),
        "to_port_audio": lambda a: np.asarray(a).transpose(0, 2, 1),
    }


FAMILIES = {"snac": _snac, "dac": _dac, "encodec": _encodec}


def _mode(mode: str | None) -> dict:
    if mode is None:
        return {"jax": {}, "port": {}}
    return {"jax": {MODES[mode]: jnp.bfloat16}, "port": {MODES[mode]: BF16}}


@functools.lru_cache(maxsize=None)
def _family(family: str, mode: str | None) -> dict:
    """A family's pair in a mode (None: f32), built once a test process,
    with its JAX encode and decode jitted once."""
    run = FAMILIES[family](_mode(mode))
    run["jax_encode_jit"] = jax.jit(run["jax_encode"])
    run["jax_decode_jit"] = jax.jit(run["jax_decode"])
    return run


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_codec_precision_mode_matches_jax(family, mode, kernel_dtypes):
    f32, run = _family(family, None), _family(family, mode)
    params = run["jax"].params
    with torch.no_grad():
        # codes: JAX's in this mode, the port's in this mode, the port's f32
        want = run["jax_encode_jit"](params)
        with DispatchCounts() as enc_counts:
            got = run["port_encode"]()
        got_f32 = f32["port_encode"]()
        want_list = want if isinstance(want, (list, tuple)) else [want]
        got_list = got if isinstance(got, list) else [got]
        differ = sum(int((np.asarray(w) != g).sum()) for w, g in zip(want_list, got_list))
        assert differ == 0, f"{differ} codes differ from JAX's {mode} codes"
        if mode == "mixed":
            for g, g32 in zip(got_list, got_f32 if isinstance(got_f32, list) else [got_f32]):
                np.testing.assert_array_equal(g, g32, err_msg="mixed codes != f32 codes")
        # audio from JAX's codes, against JAX's in this mode and in f32
        want_audio = run["to_port_audio"](run["jax_decode_jit"](params, want))
        want_f32 = f32["to_port_audio"](f32["jax_decode_jit"](f32["jax"].params, want))
        with DispatchCounts() as dec_counts:
            got_audio = run["port_decode"](want)
    assert got_audio.dtype == np.float32 and got_audio.shape == want_audio.shape
    bf16_err = float(np.abs(want_audio - want_f32).max())
    assert bf16_err > 0, "the mode left the audio unchanged"
    assert float(np.abs(got_audio - want_audio).max()) <= 2 * bf16_err + F32_ATOL
    # the dtype flow: one bf16 conv a bf16 stage, everything else f32
    jax_enc = jaxpr_counts(jax.make_jaxpr(run["jax_encode"])(params))
    jax_dec = jaxpr_counts(jax.make_jaxpr(run["jax_decode"])(params, want))
    assert enc_counts.counts == jax_enc
    assert dec_counts.counts == jax_dec
    assert dec_counts.counts[("conv", "bfloat16")] == 1
    assert enc_counts.counts.get(("conv", "bfloat16"), 0) == (mode == "bf16")
    assert kernel_dtypes == {torch.float32}, kernel_dtypes


def _arrays(out) -> list[np.ndarray]:
    """A model's forward output as a flat list of numpy arrays."""
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        return [a for item in out for a in _arrays(item)]
    return [out.numpy()]


LOADERS = {"snac": (load_snac, "decoder_dtype"), "dac": (load_dac, "compute_dtype"),
           "encodec": (load_encodec, "decoder_dtype")}


@pytest.mark.parametrize("family", list(LOADERS))
def test_loader_carries_the_precision_mode(family, tmp_path):
    """load_* hands compute_dtype / decoder_dtype to the model, as the JAX
    loader does: the loaded model's forward is the mode's, and its
    parameters stay f32."""
    load, key = LOADERS[family]
    run = _family(family, "mixed" if key == "decoder_dtype" else "bf16")
    save_pretrained(run["port"], tmp_path)
    loaded = load(str(tmp_path), device="cpu", **{key: BF16}).eval()
    f32 = _family(family, None)["port"]
    assert getattr(loaded, key) == BF16
    assert loaded.decoder_dtype == BF16
    assert loaded.compute_dtype == (BF16 if key == "compute_dtype" else torch.float32)
    assert all(v.dtype != BF16 for v in loaded.state_dict().values())
    with torch.no_grad():
        want = _arrays(run["port"].forward(run["audio"]))
        got = _arrays(loaded.forward(run["audio"]))
        plain = _arrays(f32.forward(run["audio"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(g.dtype == np.float32 and not np.array_equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("transposed", [False, True])
def test_conv_promotes_as_jnp(transposed):
    """A bf16 input against f32 weights and bias: the weight cast to bf16,
    the conv in bf16, then the f32 bias, which promotes to f32 as jnp's
    ``out + bias`` does; the values of the JAX conv."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 20)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    xb = jnp.asarray(x.transpose(0, 2, 1)).astype(jnp.bfloat16)
    if transposed:
        w = rng.standard_normal((6, 4, 4)).astype(np.float32)     # [Cin, Cout, K]
        want = jconv_transpose1d(xb, jnp.asarray(torch_conv_transpose_weight_to_hio(w)),
                                 jnp.asarray(b), stride=2)
        got = port_conv.conv_transpose1d(torch.from_numpy(x).to(BF16), torch.from_numpy(w),
                                         torch.from_numpy(b), stride=2)
    else:
        w = rng.standard_normal((4, 6, 3)).astype(np.float32)     # [Cout, Cin, K]
        want = jconv1d(xb, jnp.asarray(torch_conv_weight_to_hio(w)), jnp.asarray(b),
                       padding=1)
        got = port_conv.conv1d(torch.from_numpy(x).to(BF16), torch.from_numpy(w),
                               torch.from_numpy(b), padding=1)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mode_defaults_match_jax(family):
    """decoder_dtype defaults to compute_dtype, which defaults to f32, in
    the port as in the JAX package."""
    for mode in (None, "mixed", "bf16"):
        run = _family(family, mode)
        for key in ("compute_dtype", "decoder_dtype"):
            assert str(getattr(run["port"], key)).removeprefix("torch.") == jnp.dtype(
                getattr(run["jax"], key)).name
