"""Dia's bf16 mode in the port against the JAX package's, on the CPU.

``Dia(compute_dtype=torch.bfloat16)`` is the JAX package's serving mode:
f32 parameters cast to bf16 at each product (the port keeps the cast copy),
bf16 activations and self-attention caches, and attention scores, norms and
RoPE in f32. The two frameworks do not round at the same points (XLA's CPU
fusions keep f32 across the bf16 casts inside a fusion, torch rounds at
every op), so bf16 results are held to the port's f64 reference mode:
the port's error against f64 at most twice the JAX package's. Sampled
codes are held to JAX's with its Gumbel draws replayed: the runs may part
only where the sampler's pick was a near-tie, its score gap (in logit
units) at most twice the measured bf16 noise of the CFG logits between the
two frameworks (the ``bf16_noise`` fixture).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.dia import Dia as JDia
from neuralcodecs_tpu.models.dia.config import DiaDataConfig as JDataConfig
from neuralcodecs_tpu.models.dia.layers import sdpa_gqa as jax_sdpa_gqa
from neuralcodecs_tpu_torch.core.export import save_pretrained
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dia import Dia
from neuralcodecs_tpu_torch.models.dia import model as dia_model
from neuralcodecs_tpu_torch.models.dia.layers import DenseGeneral, sdpa_gqa
from test_dia import tiny_config
from test_torch_dia import (
    CASES,
    TEXTS,
    JaxNoise,
    _np_params,
    _setup,
    _write_wav,
    port_config,
)

BF16 = torch.bfloat16
# error ratio the port may reach against JAX's, both against the f64 port
ERR_FACTOR = 2.0


@pytest.fixture
def jax_noise(monkeypatch):
    stub = JaxNoise()
    monkeypatch.setattr(dia_model, "gumbel_noise", stub)
    return stub


def _pair(jcfg=None, seed: int = 0):
    """(JAX f32 params, JAX bf16 Dia, port bf16 Dia, port f64 Dia) on one
    seed's JAX parameters."""
    jcfg = jcfg or tiny_config()
    params = JDia(jcfg, seed=seed).params
    jb = JDia(jcfg, params=dict(params), compute_dtype=jnp.bfloat16)
    ports = []
    for dtype in (BF16, torch.float64):
        port = Dia(port_config(jcfg), device="cpu", compute_dtype=dtype)
        port.load_state_dict(_np_params(params))
        ports.append(port)
    return params, jb, *ports


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_sdpa_gqa_bf16_scores_in_f32(scale):
    """bf16 q / k / v: the scores and the softmax in f32, the weights cast
    to bf16 for the weighted sum, as JAX's ``preferred_element_type=f32``;
    bit for bit JAX's on the CPU (scores rounded to bf16 before the softmax
    miss it)."""
    rng = np.random.default_rng(0)
    q = (scale * rng.standard_normal((2, 24, 4, 16))).astype(np.float32)
    k = (scale * rng.standard_normal((2, 24, 2, 16))).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    mask = rng.random((2, 24, 24)) < 0.8
    mask[:, :, 0] = True
    mask[1, 3] = False                       # a fully masked row gives zeros
    want = jax_sdpa_gqa(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                        jnp.asarray(mask))
    got = sdpa_gqa(*(torch.from_numpy(a).to(BF16) for a in (q, k, v)), torch.from_numpy(mask))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    assert not got[1, 3].float().any()


# ------------------------------------------------------------- logits


def _cfg_batch(dia: Dia, texts) -> np.ndarray:
    text = dia._pad_text([dia.encode_text(t) for t in texts])
    return np.stack([np.zeros_like(text), text], axis=1).reshape(2 * len(texts), -1)


def _forced(dia_or_jax, text, delayed, prefill_steps, tokens, kv_int8):
    """Prefill caches, then teacher-forced decode steps' logits (f64 numpy,
    [steps, 2B, 1, C, V]) and the prefill's self caches. The JAX side runs
    jitted, as its generation does (XLA keeps f32 inside its fusions)."""
    b, max_tokens = len(text), 16
    if isinstance(dia_or_jax, Dia):
        dia = dia_or_jax
        st = dia._start_state(text, delayed, prefill_steps, 0, np.ones(b, bool),
                              max_tokens=max_tokens, kv_int8=kv_int8)
        out = []
        for n in range(tokens.shape[1]):
            step = st.step + n
            y = dia._embed_tokens(torch.from_numpy(tokens[:, n:n + 1]))
            pos = torch.full((2 * b, 1), step)
            for layer, sc, cc in zip(dia.decoder.layers, st.self_caches, st.cross_caches):
                y = layer.step(y, pos, step, sc, cc, st.cross_mask)
            out.append(dia._decoder_logits(y).double().numpy())
        return np.stack(out), st.self_caches
    jd = dia_or_jax
    carry, j_cross, j_mask = jd._generate_start_jit(
        jd.params, jnp.asarray(text), jnp.asarray(delayed.numpy()), jnp.asarray(prefill_steps),
        jax.random.key(0), jnp.ones(b, bool), max_tokens=max_tokens, kv_int8=kv_int8)
    slots = jnp.arange(max_tokens)

    @jax.jit
    def step_fn(params, caches, tok, step):
        # one decode step through every layer, compiled as the JAX loop is
        x = jd._embed_tokens(params, tok)
        position = jnp.full((2 * b, 1), step, jnp.int32)
        mask = jnp.broadcast_to((slots <= step)[None, None, :], (2 * b, 1, max_tokens))
        new = []
        for i, layer in enumerate(jd.dec_layers):
            x, cache = layer.step(params, x, position, step, caches[i], mask, j_cross[i], j_mask)
            new.append(cache)
        return jd._decoder_logits(params, x), new

    caches, out = list(carry[5]), []
    for n in range(tokens.shape[1]):
        logits, caches = step_fn(jd.params, caches, jnp.asarray(tokens[:, n:n + 1]),
                                 int(carry[0]) + n)
        out.append(np.asarray(logits).astype(np.float64))
    return np.stack(out), list(carry[5])


@functools.lru_cache(maxsize=None)
def _forced_runs(setup: str | None):
    """Teacher-forced logits of the JAX bf16, port bf16 and port f64 models
    with int8 or int4 weights (quantised alike in all three, from the same
    f32 values), or the int8 KV cache, or neither."""
    _, jb, pb, p64 = _pair()
    for model in (jb, pb, p64):
        if setup == "int8":
            model.quantize_int8()
        elif setup == "int4":
            model.quantize_int4(group_size=8)
    b = 2
    text = pb._pad_text([pb.encode_text(t) for t in TEXTS[:b]])
    delayed, prefill_steps = pb._prefill([np.full((3, 3), 5), None], b)
    tokens = np.random.default_rng(0).integers(0, 32, size=(2 * b, 6, 3))
    return {name: _forced(m, text, delayed, prefill_steps, tokens, setup == "kv-int8")
            for name, m in (("jax", jb), ("port", pb), ("f64", p64))}


def _cfg_noise(runs) -> float:
    """Max |port - JAX| of the CFG-combined logits (cond + 3 (cond - uncond)
    over rows 2i + 1 and 2i), the quantity the sampler draws from."""
    d = runs["port"][0] - runs["jax"][0]
    return float(np.abs(4.0 * d[:, 1::2] - 3.0 * d[:, 0::2]).max())


@pytest.mark.parametrize("setup", [None, "kv-int8", "int8", "int4"])
def test_bf16_logits_within_twice_jax_error(setup):
    """The prefill's caches and 6 teacher-forced steps' logits in bf16: the
    port's error against the port's f64 reference mode is at most twice the
    JAX package's error against the same f64 values; int8 / int4 weights
    dequantise in bf16 on both sides and in f64 in the reference."""
    runs = _forced_runs(setup)
    f64 = runs["f64"][0]
    err = {name: float(np.abs(runs[name][0] - f64).max()) for name in ("jax", "port")}
    assert np.isfinite(runs["port"][0]).all()
    assert 0 < err["port"] <= ERR_FACTOR * err["jax"], err
    for cache in runs["port"][1]:
        assert cache.k.dtype == (torch.int8 if setup == "kv-int8" else BF16)
    if setup == "kv-int8":
        assert runs["port"][1][0].k_scale.dtype == torch.float32


def test_bf16_encoder_within_twice_jax_error():
    params, jb, pb, p64 = _pair()
    enc_input = _cfg_batch(pb, TEXTS[:2])
    mask = enc_input != 0
    want = np.asarray(jax.jit(jb._encode_fn)(jb.params, jnp.asarray(enc_input),
                                             jnp.asarray(mask))).astype(np.float64)
    got = pb._encode_fn(torch.from_numpy(enc_input), torch.from_numpy(mask))
    ref = p64._encode_fn(torch.from_numpy(enc_input), torch.from_numpy(mask)).numpy()
    assert got.dtype == BF16
    err_port = float(np.abs(got.double().numpy() - ref).max())
    err_jax = float(np.abs(want - ref).max())
    assert 0 < err_port <= ERR_FACTOR * err_jax, (err_port, err_jax)


# ------------------------------------------------------------- generation


@pytest.fixture(scope="module")
def bf16_noise() -> float:
    """The measured bf16 noise of the CFG logits, port against JAX, on the
    teacher-forced steps of the plain bf16 model (0.24 at the time of
    writing, against logits of magnitude up to 3.3)."""
    return _cfg_noise(_forced_runs(None))


class _Scores:
    """Records the sampler's inputs each step: the score it takes the argmax
    of is ``logits / T + noise`` (``logits`` greedy), in logit units
    ``logits + T · noise``."""

    def __init__(self):
        self.plain = dia_model._sample_next_token
        self.steps: list[torch.Tensor] = []

    def __call__(self, logits, noise, temperature, *args):
        score = logits if noise is None else logits + temperature * noise
        self.steps.append(score.double())
        return self.plain(logits, noise, temperature, *args)


REPLAY = ["greedy", "default-sampling", "int8-weights", "int4-weights", "int8-kv-blocked-dot"]


@pytest.mark.parametrize("name", REPLAY)
def test_generate_codes_bf16_matches_jax(name, jax_noise, bf16_noise, monkeypatch):
    """generate_codes in bf16 with the JAX loop's own draws replayed. Where
    the step-aligned code buffers part, the first step that does is a
    near-tie: for each code that differs, the port's score of its own pick
    over JAX's pick is at most twice the bf16 noise (each score may move by
    the noise)."""
    make_config, texts, kw, setup = CASES[name]
    _, jb, pb, _ = _pair(make_config())
    _setup(jb, pb, setup)
    scores = _Scores()
    monkeypatch.setattr(dia_model, "_sample_next_token", scores)
    generated = []
    jb._generate_jit = lambda *a, **k: generated.append(JDia._generate_jit(jb, *a, **k)) \
        or generated[-1]
    want, want_len = jb.generate_codes(texts, **kw)
    st, prefill_steps, b = pb._generate(texts, **kw)
    got, got_len, _ = pb._codes(st, prefill_steps, b)
    mine, theirs = st.generated.numpy(), np.asarray(generated[0][0])
    differ = mine != theirs
    if not differ.any():
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got_len, np.asarray(want_len))
        return
    slot = int(np.nonzero(differ.any(axis=(0, 2)))[0][0])
    score = scores.steps[slot - int(prefill_steps.min())]
    channels = mine.shape[2]
    gaps = [float(score[r * channels + c, mine[r, slot, c]]
                  - score[r * channels + c, theirs[r, slot, c]])
            for r, c in zip(*np.nonzero(differ[:, slot]))]
    assert all(0 <= g <= 2 * bf16_noise for g in gaps), (slot, gaps, bf16_noise)


def test_bf16_entry_points(tmp_path):
    """generate through the f32 DAC vocoder with a voice-clone prompt,
    generate_stream and generate_codes_stream in bf16: the codes cross the
    bridge as integers, so the audio is the vocoder's own decode of the bf16
    codes, and the stream is the one-shot generation."""
    jcfg = tiny_config(tgt_vocab_size=1028, data=JDataConfig(
        text_length=16, audio_length=32, channels=3, delay_pattern=[0, 1, 2]))
    dia = Dia(port_config(jcfg), device="cpu", seed=2, compute_dtype=BF16)
    dac = DAC(DACConfig(encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32,
                        decoder_rates=[2, 2], n_codebooks=3, codebook_size=1024,
                        codebook_dim=4, sample_rate=44100), device="cpu").eval()
    dia.set_dac_model(dac)
    wav = tmp_path / "prompt.wav"
    _write_wav(wav, 0.002)
    kw = dict(max_tokens=40, seed=3)   # the prompt takes 22 frames of them
    prompt = dia.load_audio_prompt(wav)
    codes, lengths = dia.generate_codes(["[S1]hello there"], audio_prompts=[prompt], **kw)
    assert lengths[0] > 0
    audio = dia.generate(["[S1]hello there"], audio_prompt_paths=[str(wav)], **kw)[0]
    with torch.no_grad():
        want = dac.from_codes(codes[:1, :int(lengths[0])].transpose(0, 2, 1))[0].numpy()
    assert dia._speed_factor(len("[S1]hello there")) == 1.0
    assert audio.dtype == np.float32 and np.isfinite(audio).all()
    np.testing.assert_array_equal(audio, want)
    blocks = [b for b, _ in dia.generate_codes_stream("[S1]hello there", segment_tokens=5,
                                                      audio_prompt=prompt, **kw)]
    np.testing.assert_array_equal(np.concatenate(blocks), codes[0, :int(lengths[0])])
    chunks = [c for _, c in dia.generate_stream("[S1]hello there", segment_tokens=6,
                                                audio_prompt_path=str(wav), **kw)]
    np.testing.assert_allclose(np.concatenate(chunks), want, atol=1e-5, rtol=0)


# ------------------------------------------------------------- weights


def test_bf16_export_is_the_f32_export(tmp_path):
    """A bf16 Dia's parameters are f32: after a generation (which made the
    bf16 copies) its save_pretrained writes the f32 Dia's bytes."""
    params, _, pb, _ = _pair()
    f32 = Dia(port_config(), device="cpu")
    f32.load_state_dict(_np_params(params))
    pb.generate_codes(TEXTS[:1], max_tokens=8, temperature=0.0)
    assert all(v.dtype == torch.float32 for v in pb.state_dict().values())
    save_pretrained(pb, tmp_path / "bf16")
    save_pretrained(f32, tmp_path / "f32")
    files = sorted(p.name for p in (tmp_path / "f32").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "bf16").iterdir())
    for name in files:
        if name.endswith(".safetensors"):
            assert (tmp_path / "bf16" / name).read_bytes() == (tmp_path / "f32" / name).read_bytes()


def test_bf16_weight_copy_follows_the_weight():
    """The bf16 copy each DenseGeneral keeps is exactly weight.to(bf16), is
    made again after load_state_dict writes new weights, is no part of the
    state dict, and goes when the layer is quantised."""
    params, _, pb, _ = _pair()
    enc_input = torch.from_numpy(_cfg_batch(pb, TEXTS[:2]))
    mask = enc_input != 0
    pb._encode_fn(enc_input, mask)
    dense = pb.encoder.layers[0].self_attention.q_proj
    first = dense._cast[1]
    assert first.dtype == BF16 and torch.equal(first, dense.weight.to(BF16))
    pb._encode_fn(enc_input, mask)
    assert dense._cast[1] is first                      # kept between calls
    other = JDia(tiny_config(), seed=1).params
    pb.load_state_dict(_np_params(other))
    got = pb._encode_fn(enc_input, mask)
    assert torch.equal(dense._cast[1], dense.weight.to(BF16))
    assert not torch.equal(dense._cast[1], first)
    fresh = Dia(port_config(), device="cpu", compute_dtype=BF16)
    fresh.load_state_dict(_np_params(other))
    assert torch.equal(got, fresh._encode_fn(enc_input, mask))
    assert not any("_cast" in k for k in pb.state_dict())
    pb.quantize_int8()
    assert all("_cast" not in m.__dict__ for m in pb.modules() if isinstance(m, DenseGeneral))
    assert math.isfinite(float(pb._encode_fn(enc_input, mask).float().abs().max()))
