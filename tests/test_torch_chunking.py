"""The port's chunked execution against the JAX package's, on the CPU.

``neuralcodecs_tpu_torch/ops/chunking.py`` against ``neuralcodecs_tpu/ops/
chunking.py`` (the plan math field by field, split / stitch on the
transposed layout), and SNAC's and DAC's staged, chunk-batched functions
against JAX's at the same chunk count n: the port's seeded parameters go
through ``to_jax_params`` (the exact inverse of ``from_jax_params``) into
the JAX models, the same numpy audio through both, noise off, the JAX side
jitted. Codes must be bit-exact and audio within rtol
1e-4 / atol 1e-5 (test_torch_snac.py's and test_torch_dac.py's bar: the two
frameworks sum the convolutions in different orders). The port's public
paths run n = 1 on every device; they must give the outputs of JAX's public
paths, which chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu.models.snac import SNAC as JSNAC
from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
from neuralcodecs_tpu.ops import chunking as jchunking
from neuralcodecs_tpu_torch.core.weights import to_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig
from neuralcodecs_tpu_torch.ops import chunking

TOL = dict(rtol=1e-4, atol=1e-5)


def _audio(shape, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------- plan math


def test_plan_chunks_matches_jax_fuzz():
    """Every field of every plan, and every refusal, over a seeded fuzz."""
    rng = np.random.default_rng(17)
    seen = {"refused": 0, "planned": 0, "degenerate": 0}
    cases = [(int(rng.integers(-2, 6000)), int(rng.integers(0, 12)),
              int(rng.integers(0, 400)), int(rng.choice([1, 2, 4, 8, 16, 32])))
             for _ in range(4000)]
    # small streams on a coarse lattice give degenerate (empty-core) tails
    cases += [(int(rng.integers(1, 400)), int(rng.integers(2, 12)), int(rng.integers(0, 3)),
               int(rng.choice([8, 16, 32]))) for _ in range(2000)]
    for total, n, halo, align in cases:
        want = jchunking.plan_chunks(total, n, halo, align)
        got = chunking.plan_chunks(total, n, halo, align)
        if want is None:
            assert got is None, (total, n, halo, align)
            seen["refused"] += 1
            continue
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (total, n, halo, align)
        seen["planned"] += 1
        seen["degenerate"] += 0 in want.core_lens
    assert min(seen.values()) > 20, seen


def _preset_rates() -> list[tuple[list[int], list[int]]]:
    cfgs = [SNACConfig.snac_24khz(), SNACConfig.snac_32khz(), SNACConfig.snac_44khz(),
            DACConfig.dac_44khz(), DACConfig.dac_24khz(), DACConfig.dac_16khz()]
    return [(list(c.encoder_rates), list(c.decoder_rates)) for c in cfgs]


@pytest.mark.parametrize("enc_rates,dec_rates", _preset_rates())
def test_receptive_fields_match_jax(enc_rates, dec_rates):
    for k in range(len(enc_rates) + 1):
        for last in (None, 3):
            assert chunking.conv_stack_receptive_field(7, enc_rates[:k], last_kernel=last) \
                == jchunking.conv_stack_receptive_field(7, enc_rates[:k], last_kernel=last)
    for k in range(len(dec_rates) + 1):
        for conv_in in (True, False):
            assert chunking.decoder_receptive_field_frames(
                dec_rates[k:], include_input_conv=conv_in) \
                == jchunking.decoder_receptive_field_frames(
                    dec_rates[k:], include_input_conv=conv_in)


PLANS = {"8-windows": (862, 8, 16, 1), "degenerate-tail": (49, 8, 0, 1),
         "aligned": (3456, 8, 10, 32)}


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("scale", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 3])
def test_split_stitch_match_jax(plan_name, scale, batch):
    """JAX's [B, T, C] split / stitch transposed equal the port's on
    [B, C, T]; stitch(split(x)) is x; outputs are contiguous."""
    plan = chunking.plan_chunks(*PLANS[plan_name])
    jplan = jchunking.plan_chunks(*PLANS[plan_name])
    assert plan is not None and (0 in plan.core_lens) == (plan_name == "degenerate-tail")
    x = _audio((batch, 3, plan.total * scale), seed=scale)
    jx = np.ascontiguousarray(x.transpose(0, 2, 1))
    split = chunking.split_chunks(torch.from_numpy(x), plan, scale)
    jsplit = np.asarray(jchunking.split_chunks(jx, jplan, scale))
    assert split.is_contiguous()
    np.testing.assert_array_equal(split.numpy().transpose(0, 2, 1), jsplit)
    y = _audio(tuple(split.shape), seed=7)
    stitched = chunking.stitch_chunks(torch.from_numpy(y), plan, scale)
    assert stitched.is_contiguous()
    np.testing.assert_array_equal(
        stitched.numpy().transpose(0, 2, 1),
        np.asarray(jchunking.stitch_chunks(np.ascontiguousarray(y.transpose(0, 2, 1)),
                                           jplan, scale)))
    np.testing.assert_array_equal(chunking.stitch_chunks(split, plan, scale).numpy(), x)


# -------------------------------------------------------- models vs JAX


def snac_kwargs(**over) -> dict:
    base = dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 4],
                decoder_dim=64, decoder_rates=[4, 2], attn_window_size=None,
                codebook_size=64, codebook_dim=8, vq_strides=[2, 1],
                noise=False, depthwise=False)
    base.update(over)
    return base


def dac_kwargs(**over) -> dict:
    base = dict(sample_rate=16000, encoder_dim=16, encoder_rates=[2, 4], decoder_dim=64,
                decoder_rates=[4, 2], n_codebooks=3, codebook_size=32, codebook_dim=4)
    base.update(over)
    return base


SNAC_CONFIGS = {
    "plain": snac_kwargs(),
    # LocalMHA in the unchunked stages, depthwise units, an odd stride
    "mha-depthwise": snac_kwargs(attn_window_size=8, encoder_dim=32, decoder_dim=128,
                                 encoder_rates=[2, 3, 2], decoder_rates=[2, 3, 2],
                                 vq_strides=[4, 2, 1], depthwise=True),
}


def _jax_params(port) -> dict:
    """The port's weights in the JAX package's layouts (JAX's own seeded
    init takes seconds a model on the CPU)."""
    return {k: jnp.asarray(v) for k, v in
            to_jax_params(port.state_dict(), transposed_groups(port)).items()}


@pytest.fixture(scope="module")
def snac_pairs():
    pairs = {}
    for seed, (name, kw) in enumerate(SNAC_CONFIGS.items()):
        port = SNAC(SNACConfig(**kw), device="cpu", seed=seed).eval()
        pairs[name] = JSNAC(JSNACConfig(**kw), params=_jax_params(port)), port
    return pairs


@pytest.fixture(scope="module")
def dac_pair():
    port = DAC(DACConfig(**dac_kwargs()), device="cpu", seed=2).eval()
    return JDAC(JDACConfig(**dac_kwargs()), params=_jax_params(port)), port


def _codes_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"stage {i}")


# (config, samples, n): n = 8 and n = 2 chunk both stages; n = 8 on a short
# stream is refused by both plans (the staged functions' plan-None paths)
SNAC_CASES = {"plain-n8": ("plain", 2048 + 37, 8), "plain-n2": ("plain", 1024, 2),
              "plain-short-n8": ("plain", 200, 8), "mha-depthwise-n8": ("mha-depthwise", 4000, 8)}


@pytest.mark.parametrize("case", list(SNAC_CASES))
def test_snac_chunked_matches_jax(snac_pairs, case):
    name, samples, n = SNAC_CASES[case]
    jmodel, port = snac_pairs[name]
    audio = _audio((2, samples), seed=samples)
    ja, length = jmodel._prepare(audio)
    pa, _ = port._prepare(audio)
    short = port._auto_chunks(pa.shape[-1]) == 1
    assert short == (case == "plain-short-n8")
    want_audio, want_codes = jmodel._jit_forward(jmodel.params, ja, None, n)
    want_enc = jmodel._jit_encode(jmodel.params, ja, n)
    want_dec = jmodel._jit_decode(jmodel.params, want_codes, None, n)
    with torch.no_grad():
        got_audio, got_codes = port._forward_chunked_fn(pa, None, n)
        got_enc = port._encode_chunked_fn(pa, n)
        got_dec = port._decode_chunked_fn([torch.tensor(np.asarray(c)) for c in want_codes],
                                          None, n)
        ref_audio, ref_codes = port._forward_fn(pa, None)
    _codes_equal(got_codes, want_codes)
    _codes_equal(got_enc, want_enc)
    np.testing.assert_allclose(got_audio[:, 0].numpy(), np.asarray(want_audio)[..., 0], **TOL)
    np.testing.assert_allclose(got_dec[:, 0].numpy(), np.asarray(want_dec)[..., 0], **TOL)
    # the chunked port against the unchunked port: the same function
    _codes_equal(got_codes, ref_codes)
    np.testing.assert_allclose(got_audio.numpy(), ref_audio.numpy(), **TOL)


def test_dac_chunked_matches_jax(dac_pair):
    jmodel, port = dac_pair
    n = 8
    audio = _audio((2, port.hop_length * 600 + 5), seed=3)
    ja, _ = jmodel._prepare(audio)
    pa, _ = port._prepare(audio)
    assert port._auto_chunks(pa.shape[-1] // port.hop_length) == n
    want = jmodel._jit_forward(jmodel.params, ja, None, n)
    want_enc = jmodel._jit_encode(jmodel.params, ja, 2, n)
    want_dec = jmodel._jit_decode(jmodel.params, want["z"], n)
    with torch.no_grad():
        got = port._forward_chunked_fn(pa, None, n)
        got_enc = port._encode_chunked_fn(pa, 2, n)
        got_dec = port._decode_chunked_fn(torch.tensor(np.asarray(want["z"])).transpose(1, 2)
                                          .contiguous(), n)
        ref = port._forward_fn(pa, None)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_array_equal(got_enc[1].numpy(), np.asarray(want_enc[1]))
    np.testing.assert_allclose(got["audio"][:, 0].numpy(), np.asarray(want["audio"])[..., 0],
                               **TOL)
    np.testing.assert_allclose(got["z"].transpose(1, 2).numpy(), np.asarray(want["z"]), **TOL)
    np.testing.assert_allclose(got["latents"].transpose(1, 2).numpy(),
                               np.asarray(want["latents"]), **TOL)
    for key in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    np.testing.assert_allclose(got_dec[:, 0].numpy(), np.asarray(want_dec)[..., 0], **TOL)
    # the chunked port against the unchunked port
    np.testing.assert_array_equal(got["codes"].numpy(), ref["codes"].numpy())
    np.testing.assert_allclose(got["audio"].numpy(), ref["audio"].numpy(), **TOL)


# ----------------------------------------------- the public paths


def _record_chunks(monkeypatch, jmodel, log: list) -> None:
    """Wrap JAX's jitted ``_jit_*`` so that each call appends its chunk
    count (the last argument) to ``log``."""
    for name in ("_jit_forward", "_jit_encode", "_jit_decode"):
        def wrapper(*args, _fn=getattr(jmodel, name)):
            log.append(args[-1])
            return _fn(*args)
        monkeypatch.setattr(jmodel, name, wrapper, raising=False)


def test_snac_public_paths_match_jax_chunked(snac_pairs, monkeypatch):
    """forward / encode / decode run n = 1 and give the codes and audio of
    JAX's, which run chunked (n = 8) on this stream (test_torch_snac.py
    holds the two where JAX runs n = 1)."""
    jmodel, port = snac_pairs["plain"]
    jax_n: list = []
    _record_chunks(monkeypatch, jmodel, jax_n)
    audio = _audio(2100, seed=2100)
    want_audio, want_codes = jmodel.forward(audio)
    got_audio, got_codes = port.forward(audio)
    _codes_equal(got_codes, want_codes)
    np.testing.assert_allclose(got_audio.numpy(), np.asarray(want_audio), **TOL)
    _codes_equal(port.encode(audio), jmodel.encode(audio))
    np.testing.assert_allclose(port.decode([np.asarray(c) for c in want_codes]).numpy(),
                               np.asarray(jmodel.decode(want_codes)), **TOL)
    assert set(jax_n) == {8}, jax_n


def test_dac_public_paths_match_jax_chunked(dac_pair, monkeypatch):
    """forward / encode / decode / from_codes / from_latents run n = 1 and
    give the codes and audio of JAX's, which run chunked (n = 8) at 600
    frames (test_torch_dac.py holds the two where JAX runs n = 1)."""
    jmodel, port = dac_pair
    jax_n: list = []
    _record_chunks(monkeypatch, jmodel, jax_n)
    audio = _audio(600 * port.hop_length - 3, seed=600)
    want = jmodel.forward(audio)
    got = port.forward(audio)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want["audio"]), **TOL)
    np.testing.assert_array_equal(port.encode(audio)[1].numpy(),
                                  np.asarray(jmodel.encode(audio)[1]))
    np.testing.assert_allclose(port.decode(np.asarray(want["z"])).numpy(),
                               np.asarray(jmodel.decode(want["z"])), **TOL)
    np.testing.assert_allclose(port.from_codes(np.asarray(want["codes"])).numpy(),
                               np.asarray(jmodel.from_codes(want["codes"])), **TOL)
    np.testing.assert_allclose(port.from_latents(np.asarray(want["latents"])).numpy(),
                               np.asarray(jmodel.from_latents(want["latents"])), **TOL)
    assert set(jax_n) == {8}, jax_n


@pytest.mark.parametrize("codec", ["snac", "dac"])
def test_auto_chunks_match_jax_at_preset_rates(codec):
    """_auto_chunks at the presets' rates (tiny widths) over lengths that
    give 1, 2, 4 and 8."""
    if codec == "snac":
        kw = snac_kwargs(encoder_dim=8, decoder_dim=64, encoder_rates=[2, 4, 8, 8],
                         decoder_rates=[8, 8, 4, 2], vq_strides=[4, 2, 1])
        jmodel, port = JSNAC(JSNACConfig(**kw), params={}), SNAC(SNACConfig(**kw), device="cpu")
        lengths = [port._pad_length(int(s * 24000)) for s in np.geomspace(0.05, 12, 60)]
    else:
        kw = dac_kwargs(sample_rate=44100, encoder_dim=8, decoder_dim=64,
                        encoder_rates=[2, 4, 8, 8], decoder_rates=[8, 8, 4, 2])
        jmodel, port = JDAC(JDACConfig(**kw), params={}), DAC(DACConfig(**kw), device="cpu")
        lengths = sorted({int(f) for f in np.geomspace(2, 1200, 60)})
    got = [port._auto_chunks(t) for t in lengths]
    assert got == [jmodel._auto_chunks(t) for t in lengths]
    assert set(got) == {1, 2, 4, 8}


# ------------------------------------------------------ the port alone


def test_batched_chunked_matches_each_stream(snac_pairs, dac_pair):
    """Three streams chunked in one batch give each stream's codes and audio
    alone (the windows of all streams share the batch axis)."""
    _, snac = snac_pairs["mha-depthwise"]
    batch = _audio((3, 4000), seed=5)
    pa, _ = snac._prepare(batch)
    _, dac = dac_pair
    da, _ = dac._prepare(_audio((3, dac.hop_length * 600), seed=6))
    with torch.no_grad():
        audio, codes = snac._forward_chunked_fn(pa, None, 8)
        out = dac._forward_chunked_fn(da, None, 8)
        for b in range(3):
            one_audio, one_codes = snac._forward_chunked_fn(pa[b:b + 1], None, 8)
            _codes_equal([c[b:b + 1] for c in codes], one_codes)
            np.testing.assert_allclose(audio[b:b + 1].numpy(), one_audio.numpy(), **TOL)
            one = dac._forward_chunked_fn(da[b:b + 1], None, 8)
            np.testing.assert_array_equal(out["codes"][b:b + 1].numpy(), one["codes"].numpy())
            np.testing.assert_allclose(out["audio"][b:b + 1].numpy(), one["audio"].numpy(),
                                       **TOL)


MODES = {"mixed": "decoder_dtype", "bf16": "compute_dtype"}
F32_ATOL = 1e-5  # test_torch_precision.py's f32 tolerance


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("codec", ["snac", "dac"])
def test_precision_mode_chunked_matches_jax(snac_pairs, dac_pair, codec, mode):
    """A precision mode chunked at n = 8 against JAX's chunked functions in
    the same mode, by test_torch_precision.py's rule: codes equal to JAX's
    (and, in the mixed mode, to the f32 mode's); audio decoded from JAX's
    codes within twice the mode's own bf16 error (JAX's mode against JAX's
    f32) plus the f32 tolerance of JAX's audio in that mode. In the bf16
    mode JAX's codes come from its encode run eagerly: jitted, XLA's CPU
    fusions may keep f32 values across the mode's bf16 casts (excess
    precision), which flips DAC codes whose top-two scores lie 1e-4 apart
    on this input; eager JAX rounds at every cast, as the port does."""
    n, dtype = 8, {MODES[mode]: torch.bfloat16}
    if codec == "snac":
        jf32, f32 = snac_pairs["plain"]
        port = SNAC(f32.config, device="cpu", **dtype)
        jmodel = JSNAC(jf32.config, params=jf32.params, **{MODES[mode]: jnp.bfloat16})
        x = _audio((2, 2048 + 37), seed=2048 + 37)  # plain-n8's input: JAX's f32 jits reused
    else:
        jf32, f32 = dac_pair
        port = DAC(f32.config, device="cpu", **dtype)
        jmodel = JDAC(jf32.config, params=jf32.params, **{MODES[mode]: jnp.bfloat16})
        x = _audio((2, f32.hop_length * 600 + 5), seed=3)  # test_dac_chunked_matches_jax's
    port.load_state_dict(f32.state_dict())
    port.eval()
    (a, _), (ja, _) = f32._prepare(x), jmodel._prepare(x)
    with torch.no_grad():
        if codec == "snac":
            encode = jmodel._encode_chunked_fn if mode == "bf16" else jmodel._jit_encode
            want_codes = encode(jmodel.params, ja, n)
            got_codes = port._encode_chunked_fn(a, n)
            f32_codes = f32._encode_chunked_fn(a, n)
            want_audio, want_f32 = (np.asarray(m._jit_decode(m.params, want_codes, None, n))
                                    [..., 0] for m in (jmodel, jf32))
            got_audio = port._decode_chunked_fn(
                [torch.tensor(np.asarray(c)) for c in want_codes], None, n)[:, 0].numpy()
        else:
            encode = jmodel._encode_chunked_fn if mode == "bf16" else jmodel._jit_encode
            want_codes = [encode(jmodel.params, ja, None, n)[1]]
            got_codes = [port._encode_chunked_fn(a, None, n)[1]]
            f32_codes = [f32._encode_chunked_fn(a, None, n)[1]]
            z_q = {m: m._jit_from_codes(m.params, want_codes[0]) for m in (jmodel, jf32)}
            want_audio, want_f32 = (np.asarray(m._jit_decode(m.params, z_q[m], n))[..., 0]
                                    for m in (jmodel, jf32))
            got_audio = port._decode_chunked_fn(
                port.quantizer.from_codes(torch.tensor(np.asarray(want_codes[0]))),
                n)[:, 0].numpy()
    differ = sum(int((np.asarray(w) != g.numpy()).sum()) for w, g in zip(want_codes, got_codes))
    assert differ == 0, f"{differ} codes differ from JAX's {mode} codes"
    if mode == "mixed":
        _codes_equal(got_codes, f32_codes)
    assert got_audio.dtype == np.float32 and got_audio.shape == want_audio.shape
    bf16_err = float(np.abs(want_audio - want_f32).max())
    assert bf16_err > 0, "the mode left the audio unchanged"
    assert float(np.abs(got_audio - want_audio).max()) <= 2 * bf16_err + F32_ATOL


def test_noise_runs_through_the_chunked_tail():
    """With decoder noise on, the generator runs from the head into the
    chunked tail: a finite round trip with the noise-free codes, and the
    same draws for the same seed."""
    kw = snac_kwargs(noise=True, depthwise=True)
    port = SNAC(SNACConfig(**kw), device="cpu").eval()
    a, _ = port._prepare(_audio((1, 2048), seed=9))
    with torch.no_grad():
        draws = [port._forward_chunked_fn(a, torch.Generator().manual_seed(3), 8)
                 for _ in range(2)]
        _, quiet = port._forward_chunked_fn(a, None, 8)
    assert torch.isfinite(draws[0][0]).all() and draws[0][0].shape == a.shape
    assert torch.equal(draws[0][0], draws[1][0])
    _codes_equal(draws[0][1], quiet)


def test_state_dict_keys_unchanged(snac_pairs, dac_pair):
    """The staged split registers no module: the keys are JAX's parameter
    names, and SNAC-24k keeps its 198."""
    for jmodel, port in (*snac_pairs.values(), dac_pair):
        assert set(port.state_dict()) == set(jmodel.params)
    assert len(SNAC(SNACConfig.snac_24khz(), device="cpu").state_dict()) == 198
