"""The PyTorch port's Dia against the JAX package's Dia, on the CPU.

Seeded JAX parameters load into the port as they are: Dia keeps them in
the port's layouts, so they need no conversion. Encoder output and decoder logits agree within
rtol 1e-5 / atol 1e-5: two layers of f32 sums taken in other orders differ
by up to 6.6e-6 at values near 1, where the port's f64 run lies 2.5e-6 from
the JAX package's f32 encoder and 6.1e-6 from the port's. Generations must give JAX's codes exactly: greedy,
and at temperature > 0 with the JAX loop's own Gumbel draws replayed into
the port's sampler (``JaxNoise`` replaces ``gumbel_noise``). The frozen
``dia_golden.npz`` and ``dia_ladder_golden.npz`` hold the port to the
codes the JAX package froze.
"""

import dataclasses
import functools
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.models.dac import DAC as JDAC
from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
from neuralcodecs_tpu.models.dia import Dia as JDia
from neuralcodecs_tpu.models.dia.config import DiaDataConfig as JDataConfig
from neuralcodecs_tpu_torch.core.exceptions import LoadError
from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
from neuralcodecs_tpu_torch.models.dia import Dia, DiaConfig
from neuralcodecs_tpu_torch.models.dia import model as dia_model
from neuralcodecs_tpu_torch.models.dia.config import (
    DiaDataConfig,
    DiaDecoderConfig,
    DiaEncoderConfig,
)
from test_dia import tiny_config

GOLDENS = Path(__file__).resolve().parent / "goldens"
TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["[S1]hello there", "[S2]ok", "[S1]third"]


def port_config(jcfg=None) -> DiaConfig:
    """The port's DiaConfig with a JAX DiaConfig's values (tiny_config's
    by default)."""
    jcfg = jcfg or tiny_config()
    sections = {"data": DiaDataConfig, "encoder": DiaEncoderConfig, "decoder": DiaDecoderConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(DiaConfig) if f.init}
    kw.update({name: cls(**dataclasses.asdict(getattr(jcfg, name)))
               for name, cls in sections.items()})
    return DiaConfig(**kw)


def _np_params(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def load_port(jcfg, params: dict) -> Dia:
    port = Dia(port_config(jcfg), device="cpu")
    port.load_state_dict(params)
    return port


def build_pair(jcfg=None, seed: int = 0) -> tuple[JDia, Dia]:
    jcfg = jcfg or tiny_config()
    jdia = JDia(jcfg, seed=seed)
    return jdia, load_port(jcfg, _np_params(jdia.params))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_row_gumbel(sample_key, rows: int, shape: tuple):
    keys = jax.vmap(lambda i: jax.random.fold_in(sample_key, i))(jnp.arange(rows))
    return jax.vmap(lambda k: jax.random.gumbel(k, shape, jnp.float32))(keys)


class JaxNoise:
    """Stands in for ``gumbel_noise``: step n of a generation seeded s gets
    the JAX loop's draws, the n-th split of key(s) folded in by row, then
    ``jax.random.gumbel`` over [C, V] (what ``jax.random.categorical`` adds
    to the logits)."""

    def __init__(self):
        self.sample_keys: dict[int, list] = {}
        self.calls = 0

    def __call__(self, noise, shape):
        keys = self.sample_keys.setdefault(noise.seed, [])
        rng = jax.random.key(noise.seed) if not keys else keys[-1][0]
        while len(keys) <= noise.draws:
            rng, sample_key = jax.random.split(rng)
            keys.append((rng, sample_key))
        self.calls += 1
        return torch.from_numpy(np.asarray(
            _jax_row_gumbel(keys[noise.draws][1], noise.rows, tuple(shape))))


@pytest.fixture
def jax_noise(monkeypatch):
    stub = JaxNoise()
    monkeypatch.setattr(dia_model, "gumbel_noise", stub)
    return stub


# ------------------------------------------------------------- model parts


def _cfg_batch(dia: Dia, texts) -> np.ndarray:
    text = dia._pad_text([dia.encode_text(t) for t in texts])
    return np.stack([np.zeros_like(text), text], axis=1).reshape(2 * len(texts), -1)


def test_encoder_output_matches_jax():
    jdia, dia = build_pair()
    enc_input = _cfg_batch(dia, TEXTS[:2])
    mask = enc_input != 0
    want = jdia._encode_fn(jdia.params, jnp.asarray(enc_input), jnp.asarray(mask))
    got = dia._encode_fn(torch.from_numpy(enc_input), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decoder_prefill_and_step_logits_match_jax(kv_int8):
    """Prefill caches, then 6 teacher-forced decode steps' logits."""
    jdia, dia = build_pair()
    data = dia.config.data
    b, max_tokens = 2, 16
    text = dia._pad_text([dia.encode_text(t) for t in TEXTS[:b]])
    delayed, prefill_steps = dia._prefill([np.full((3, 3), 5), None], b)
    carry, j_cross, j_mask = jdia._start_state(
        jdia.params, jnp.asarray(text), jnp.asarray(delayed.numpy()),
        jnp.asarray(prefill_steps), jax.random.key(0), jnp.ones(b, bool),
        max_tokens=max_tokens, kv_int8=kv_int8)
    st = dia._start_state(text, delayed, prefill_steps, 0, np.ones(b, bool),
                          max_tokens=max_tokens, kv_int8=kv_int8)
    assert st.step == int(carry[0])
    np.testing.assert_array_equal(st.generated.numpy(), np.asarray(carry[1]))
    for jc, tc in zip(carry[5] + j_cross, st.self_caches + st.cross_caches):
        for key in ("k", "v", "k_scale", "v_scale"):
            if getattr(jc, key) is not None:
                np.testing.assert_allclose(getattr(tc, key).numpy().astype(np.float32),
                                           np.asarray(getattr(jc, key)).astype(np.float32),
                                           **TOL)
    j_caches = list(carry[5])
    tokens = np.random.default_rng(0).integers(0, data.audio_eos_value,
                                               size=(2 * b, 6, data.channels))
    slots = jnp.arange(max_tokens)
    for n in range(6):
        step = st.step + n
        tok = tokens[:, n:n + 1]
        x = jdia._embed_tokens(jdia.params, jnp.asarray(tok))
        position = jnp.full((2 * b, 1), step, jnp.int32)
        self_mask = jnp.broadcast_to((slots <= step)[None, None, :], (2 * b, 1, max_tokens))
        for i, layer in enumerate(jdia.dec_layers):
            x, j_caches[i] = layer.step(jdia.params, x, position, step, j_caches[i], self_mask,
                                        j_cross[i], j_mask)
        want = jdia._decoder_logits(jdia.params, x)
        y = dia._embed_tokens(torch.from_numpy(tok))
        pos = torch.full((2 * b, 1), step)
        for layer, sc, cc in zip(dia.decoder.layers, st.self_caches, st.cross_caches):
            y = layer.step(y, pos, step, sc, cc, st.cross_mask)
        got = dia._decoder_logits(y)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")


# ------------------------------------------------------------- goldens


def test_dia_golden_codes(jax_noise):
    """dia_golden.npz: temperature 1.2, seed 7, the JAX loop's noise."""
    g = np.load(GOLDENS / "dia_golden.npz")
    dia = load_port(tiny_config(), {k[3:]: g[k] for k in g.files if k.startswith("sd/")})
    codes, lengths = dia.generate_codes(["[S1]golden fixture"], max_tokens=24, seed=7)
    assert jax_noise.calls > 0
    np.testing.assert_array_equal(codes.astype(np.int16), g["codes"])
    np.testing.assert_array_equal(lengths, g["lengths"])


def _ladder_config():
    jcfg = tiny_config()
    jcfg.data.audio_length = 64
    return jcfg


def test_dia_serving_ladder_golden(jax_noise):
    """dia_ladder_golden.npz: the int8 cache, blocked read (16) and int8
    dots, greedy and at temperature 1.2 / top-k 32 with the JAX noise; the
    quality gate recomputed on the port's own f32 greedy run."""
    from make_goldens import DIA_LADDER_KW, DIA_LADDER_TEXTS

    g = np.load(GOLDENS / "dia_ladder_golden.npz")
    dia = load_port(_ladder_config(), {k[3:]: g[k] for k in g.files if k.startswith("sd/")})
    greedy_kw = dict(DIA_LADDER_KW, temperature=0.0)
    ref, _ = dia.generate_codes(DIA_LADDER_TEXTS, **greedy_kw)
    dia.enable_int8_kv_cache()
    dia.kv_read_block = 16
    dia.kv_dot_int8 = True
    assert dia._resolve_kv_block(64) == 16 and dia._resolve_kv_dot(64) is True
    ladder, lengths = dia.generate_codes(DIA_LADDER_TEXTS, **greedy_kw)
    np.testing.assert_array_equal(ladder.astype(np.int16), g["ladder_codes"])
    np.testing.assert_array_equal(lengths, g["ladder_lengths"])
    served, served_len = dia.generate_codes(DIA_LADDER_TEXTS, **DIA_LADDER_KW)
    np.testing.assert_array_equal(served.astype(np.int16), g["served_codes"])
    np.testing.assert_array_equal(served_len, g["served_lengths"])
    n = min(ref.shape[1], ladder.shape[1])
    for b in range(ref.shape[0]):
        eq = (ref[b, :n] == ladder[b, :n]).all(axis=-1)
        first_div = int(np.argmin(eq)) if not eq.all() else n
        assert first_div >= 8, f"row {b}: the ladder leaves the f32 greedy run at {first_div}"


# ------------------------------------------------------------- generation


def _text_length_256():
    return tiny_config(data=JDataConfig(
        text_length=256, audio_length=32, channels=3, audio_eos_value=32, audio_pad_value=33,
        audio_bos_value=34, delay_pattern=[0, 1, 2]))


SAMPLED = dict(temperature=1.3, top_k=8)
CASES = {
    # name: (JAX config, texts, generate_codes kwargs, model setup)
    "greedy": (tiny_config, TEXTS[:2], dict(max_tokens=20, seed=3, temperature=0.0), None),
    "default-sampling": (tiny_config, TEXTS[:2], dict(max_tokens=24, seed=1), None),
    "batch-padding-greedy": (tiny_config, TEXTS, dict(max_tokens=20, seed=3, temperature=0.0,
                                                      pad_batch_to=4), None),
    "batch-padding-sampled": (tiny_config, TEXTS, dict(max_tokens=20, seed=11, pad_tokens_to=32,
                                                       pad_text_to=64, pad_batch_to=8, **SAMPLED),
                              None),
    "text-full-length": (_text_length_256, TEXTS[:2], dict(max_tokens=20, seed=3,
                                                           pad_text_to=256, **SAMPLED), None),
    "text-bucket": (_text_length_256, TEXTS[:2], dict(max_tokens=20, seed=3, **SAMPLED), None),
    "token-bucket": (tiny_config, TEXTS[:2], dict(max_tokens=20, seed=5, pad_tokens_to=32), None),
    "audio-prompt": (tiny_config, ["[S1]x", "[S2]yz"],
                     dict(max_tokens=24, seed=2, audio_prompts=[
                         np.random.default_rng(1).integers(0, 32, (4, 3)),
                         np.random.default_rng(2).integers(0, 32, (2, 3))]), None),
    "int8-weights": (tiny_config, TEXTS[:2], dict(max_tokens=16, seed=5, temperature=0.0),
                     "int8"),
    "int4-weights": (tiny_config, TEXTS[:2], dict(max_tokens=16, seed=5, temperature=0.0),
                     "int4"),
    "int8-kv-blocked-dot": (tiny_config, TEXTS[:2], dict(max_tokens=20, seed=3, **SAMPLED),
                            "ladder"),
}


def _setup(jdia: JDia, dia: Dia, setup: str | None) -> None:
    if setup == "int8":
        jdia.quantize_int8()
        dia.quantize_int8()
    elif setup == "int4":
        jdia.quantize_int4(group_size=8)
        dia.quantize_int4(group_size=8)
    elif setup == "ladder":
        for m in (jdia, dia):
            m.enable_int8_kv_cache()
            m.kv_read_block = 8
            m.kv_dot_int8 = True


@pytest.mark.parametrize("name", list(CASES))
def test_generate_codes_matches_jax(name, jax_noise):
    make_config, texts, kw, setup = CASES[name]
    jdia, dia = build_pair(make_config())
    _setup(jdia, dia, setup)
    want, want_len = jdia.generate_codes(texts, **kw)
    got, got_len = dia.generate_codes(texts, **kw)
    assert (jax_noise.calls > 0) == (kw.get("temperature", 1.2) > 0)
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sync_every_changes_no_state(monkeypatch):
    """Reading the stop test every step or every 32 steps gives the same
    final state: the steps run after the last row finished change nothing."""
    dia = build_pair()[1]
    kw = dict(max_tokens=24, seed=1, pad_tokens_to=32)
    runs = {}
    for every in (1, 32):
        monkeypatch.setattr(dia_model, "_SYNC_EVERY", every)
        st, _, _ = dia._generate(TEXTS, **kw)
        runs[every] = (st, dia.generate_codes(TEXTS, **kw))
    (st1, (c1, l1)), (st32, (c32, l32)) = runs[1], runs[32]
    assert st32.step > st1.step  # steps did run past the end
    for key in ("generated", "finished", "countdown", "eos_detected"):
        assert torch.equal(getattr(st1, key), getattr(st32, key)), key
    np.testing.assert_array_equal(c1, c32)
    np.testing.assert_array_equal(l1, l32)


@pytest.mark.parametrize("ladder", [False, True])
def test_stream_codes_match_oneshot(ladder):
    dia = build_pair()[1]
    if ladder:
        dia.enable_int8_kv_cache()
        dia.kv_read_block = 8
        dia.kv_dot_int8 = True
    codes, lengths = dia.generate_codes(["[S1]stream me"], max_tokens=24, seed=11)
    for segment_tokens in (5, 64):
        blocks, dones = zip(*dia.generate_codes_stream("[S1]stream me",
                                                       segment_tokens=segment_tokens,
                                                       max_tokens=24, seed=11))
        assert dones[-1] and not any(dones[:-1])
        streamed = np.concatenate(blocks, axis=0)
        assert streamed.shape[0] == int(lengths[0])
        np.testing.assert_array_equal(streamed, codes[0, :int(lengths[0])])


# ------------------------------------------------------------- vocoder


def _dac_pair():
    kw = dict(encoder_dim=8, encoder_rates=[2, 2], decoder_dim=32, decoder_rates=[2, 2],
              n_codebooks=3, codebook_size=1024, codebook_dim=4, sample_rate=44100)
    jdac = JDAC(JDACConfig(**kw), seed=0)
    dac = DAC(DACConfig(**kw), device="cpu")
    dac.load_state_dict(from_jax_params(_np_params(jdac.params), transposed_groups(dac)))
    return jdac, dac.eval()


def _write_wav(path: Path, seconds: float, sr: int = 44100) -> None:
    t = np.arange(int(seconds * sr)) / sr
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


@pytest.mark.parametrize("slowdown", ["dynamic", "static"])
def test_generate_vocoder_matches_jax(slowdown, jax_noise, tmp_path):
    """Text -> codes -> the port's DAC against the JAX package's DAC, with a
    voice-clone prompt from a WAV; the static slowdown resamples. Dia's
    audio vocabulary is the real one (1024 codes, then EOS / PAD / BOS) so
    that DAC's codes are Dia's tokens."""
    jcfg = tiny_config(slowdown_mode=slowdown, tgt_vocab_size=1028, data=JDataConfig(
        text_length=16, audio_length=32, channels=3, delay_pattern=[0, 1, 2]))
    jdia, dia = build_pair(jcfg)
    jdac, dac = _dac_pair()
    jdia.set_dac_model(jdac)
    dia.set_dac_model(dac)
    assert "dac.decoder.model.0.weight" not in dia.state_dict()
    wav = tmp_path / "prompt.wav"
    _write_wav(wav, 0.002)
    prompt = dia.load_audio_prompt(wav)
    np.testing.assert_array_equal(prompt, np.asarray(jdia.load_audio_prompt(wav)))
    kw = dict(max_tokens=20, seed=3)
    texts = ["[S1]hello there", "[S2]ok"]
    want = jdia.generate(texts, audio_prompt_paths=[str(wav), str(wav)], **kw)
    got = dia.generate(texts, audio_prompt_paths=[str(wav), str(wav)], **kw)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-4)


def test_generate_stream_matches_generate():
    dia = build_pair()[1]
    dia.set_dac_model(_dac_pair()[1])
    ref = dia.generate(["[S1]hello there"], max_tokens=20, seed=3)[0]
    chunks = [c for _, c in dia.generate_stream("[S1]hello there", segment_tokens=6,
                                                max_tokens=20, seed=3)]
    streamed = np.concatenate(chunks)
    assert streamed.shape == ref.shape
    np.testing.assert_allclose(streamed, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------- loading, device


def test_upstream_names_and_missing_key():
    jdia, dia = build_pair()
    sd = {f"model.{k}": np.asarray(v) for k, v in jdia.params.items()}
    other = Dia(port_config(), device="cpu", seed=1)
    other.load_state_dict(sd)
    for key, value in dia.state_dict().items():
        assert torch.equal(other.state_dict()[key], value), key
    del sd["model.decoder.norm.weight"]
    with pytest.raises(LoadError, match="decoder.norm.weight"):
        Dia(port_config(), device="cpu").load_state_dict(sd)


def test_device_and_unported_modes(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dia(port_config())
    bf16 = Dia(port_config(), device="cpu", compute_dtype=torch.bfloat16)
    assert bf16.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in bf16.state_dict().values())
    with pytest.raises(NotImplementedError, match="torch.bfloat16"):
        Dia(port_config(), device="cpu", compute_dtype=torch.float16)
    dia = Dia(port_config(), device="cpu")
    with pytest.raises(LoadError, match="not found"):
        dia.load_dac_model(str(tmp_path / "absent.safetensors"))
    with pytest.raises(RuntimeError, match="No DAC vocoder"):
        dia.generate(["[S1]x"], max_tokens=8)


@pytest.mark.parametrize("kv_block", [0, 4])
def test_f64_reference_mode(kv_block):
    """compute_dtype=torch.float64 widens the f32 draws of the seed, and on
    the JAX parameters runs the prefill and the decode steps (the blocked
    read included) in f64, within TOL of the f32 port."""
    f32 = Dia(port_config(), device="cpu", seed=3)
    f64 = Dia(port_config(), device="cpu", seed=3, compute_dtype=torch.float64)
    for key, value in f32.state_dict().items():
        assert torch.equal(f64.state_dict()[key], value.double()), key
    jdia, f32 = build_pair()
    f64.load_state_dict(_np_params(jdia.params))
    b = 2
    text = f32._pad_text([f32.encode_text(t) for t in TEXTS[:b]])
    data = f32.config.data
    tokens = np.random.default_rng(3).integers(0, data.audio_eos_value,
                                               size=(2 * b, 4, data.channels))
    logits = []
    for dia in (f32, f64):
        delayed, prefill_steps = dia._prefill([None] * b, b)
        st = dia._start_state(text, delayed, prefill_steps, 0, np.ones(b, bool), max_tokens=16)
        for cache in st.self_caches + st.cross_caches:
            assert cache.k.dtype == cache.v.dtype == dia.compute_dtype
        for n in range(tokens.shape[1]):
            x = dia._embed_tokens(torch.from_numpy(tokens[:, n:n + 1]))
            pos = torch.full((2 * b, 1), st.step + n)
            for layer, sc, cc in zip(dia.decoder.layers, st.self_caches, st.cross_caches):
                x = layer.step(x, pos, st.step + n, sc, cc, st.cross_mask, kv_block=kv_block)
            logits.append(dia._decoder_logits(x))
    n = tokens.shape[1]
    for got, want in zip(logits[n:], logits[:n]):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.double().numpy(), **TOL)


def test_quantize_in_place_keeps_jax_keys():
    jdia, dia = build_pair()
    jdia.quantize_int4(group_size=8)
    dia.quantize_int4(group_size=8)
    assert sorted(dia.state_dict()) == sorted(jdia.params)
    for key, value in dia.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jdia.params[key]), err_msg=key)


# ------------------------------------------------------------- weights


def test_jax_params_load_with_layouts_unchanged():
    """Dia's JAX parameters load with no conversion: every tensor equals
    its JAX array, DenseGeneral kernels stay [in..., out...] and
    embeddings [V, D]."""
    jdia, dia = build_pair()
    got = dia.state_dict()
    assert got.keys() == jdia.params.keys()
    for key, value in jdia.params.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    assert tuple(got["decoder.layers.0.self_attention.o_proj.weight"].shape) == (4, 8, 32)
    assert tuple(got["decoder.embeddings.0.weight"].shape) == (36, 32)
