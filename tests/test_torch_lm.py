"""The port's Encodec language model and LM-coded .ecdc path, on the CPU.

The frozen LM of ``ecdc_golden.npz`` (dimension 32, 2 layers, 4 heads)
crosses into the port with ``from_jax_params``; its pdfs, teacher-forced
over the golden's 4 x 200 codes, must be within rtol 1e-5 / atol 1e-7 of
the JAX LM's (the two sum their products in different orders). Those pdfs
cannot be asked to give equal CDFs: the CDF quantisation turns a one-ulp
difference into a different entry often enough to desync a stream. So the
golden ``blob_lm`` is reproduced through the port's compressor driven by
the JAX LM's own pdfs, and the port's LM is held to lossless round trips
through itself.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.models.encodec.lm import EncodecLanguageModel as JLM
from neuralcodecs_tpu.models.encodec.lm import EncodecLMConfig as JLMConfig
from neuralcodecs_tpu_torch.core.exceptions import CodecError, LoadError
from neuralcodecs_tpu_torch.core.weights import from_jax_params
from neuralcodecs_tpu_torch.models.encodec import Encodec, ecdc
from neuralcodecs_tpu_torch.models.encodec import compressor
from neuralcodecs_tpu_torch.models.encodec.lm import EncodecLanguageModel, EncodecLMConfig
from test_encodec import tiny_config
from test_torch_encodec import GOLDEN, _golden_port, port_config

GOLDEN_LM = dict(codebook_size=32, num_codebooks=4, dimension=32, num_heads=4, num_layers=2,
                 past_context=16)
PDF_TOL = dict(rtol=1e-5, atol=1e-7)


def _golden_lms():
    """The golden's JAX LM and the port's LM with its weights."""
    g = np.load(GOLDEN)
    params = {k[3:]: g[k] for k in g.files if k.startswith("lm/")}
    jlm = JLM(JLMConfig(**GOLDEN_LM), params={k: jnp.asarray(v) for k, v in params.items()})
    lm = EncodecLanguageModel(EncodecLMConfig(**GOLDEN_LM), device="cpu")
    lm.load_state_dict(from_jax_params(params))
    return jlm, lm


def _golden_inputs() -> np.ndarray:
    """The golden's codes, +1-shifted and delayed one step as the
    compressor feeds them: [1, 4, 200]."""
    model, g = _golden_port()
    codes = model.encode(g["audio"])[0].codes.numpy()
    inputs = np.zeros_like(codes, dtype=np.int64)
    inputs[..., 1:] = codes[..., :-1] + 1
    return inputs


class ReplayLM:
    """Stands in for the port's LM in the compressor: each step runs the JAX
    LM on the same inputs and hands back its pdfs."""

    device = torch.device("cpu")

    def __init__(self, jlm):
        self.jlm = jlm

    def init_state(self, batch: int):
        return self.jlm.init_state(batch)

    def step(self, indices, state):
        probas, state = self.jlm.step(np.asarray(torch.as_tensor(indices)), state)
        return torch.from_numpy(np.array(probas)), state


def test_lm_step_and_full_match_jax():
    jlm, lm = _golden_lms()
    inputs = _golden_inputs()
    np.testing.assert_allclose(lm.forward_full(inputs).numpy(),
                               np.asarray(jlm.forward_full(inputs)), **PDF_TOL)
    jstate, state = jlm.init_state(1), lm.init_state(1)
    for t in range(inputs.shape[-1]):
        want, jstate = jlm.step(inputs[..., t:t + 1], jstate)
        got, state = lm.step(torch.from_numpy(inputs[..., t:t + 1]), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PDF_TOL,
                                   err_msg=f"step {t}")
    assert state.offset == inputs.shape[-1]
    np.testing.assert_allclose(state.buffers.numpy(), np.asarray(jstate.buffers),
                               rtol=1e-4, atol=1e-5)


def test_lm_step_matches_full():
    """The rolling-buffer steps against the full-sequence forward, past the
    context (tests/test_encodec_compress.py's tolerance: the two attend
    over differently shaped key sets)."""
    cfg = EncodecLMConfig(codebook_size=16, num_codebooks=2, dimension=32, num_heads=4,
                          num_layers=2, past_context=8)
    lm = EncodecLanguageModel(cfg, device="cpu", seed=1)
    codes = np.random.default_rng(0).integers(0, 17, size=(2, 2, 12))
    full = lm.forward_full(codes).numpy()
    assert full.shape == (2, 16, 2, 12)
    state, steps = lm.init_state(2), []
    for t in range(12):
        probas, state = lm.step(codes[..., t:t + 1], state)
        steps.append(probas.numpy()[..., 0])
    np.testing.assert_allclose(np.stack(steps, axis=-1), full, rtol=2e-3, atol=1e-5)


def test_lm_step_row_locality():
    """At a fixed batch shape each row's pdfs depend on that row's inputs
    only, bit for bit: permuting rows permutes the outputs, and zero co-rows
    (the decoder's padding) leave a row unchanged."""
    cfg = EncodecLMConfig(codebook_size=16, num_codebooks=3, dimension=32, num_heads=2,
                          num_layers=2, past_context=8)
    lm = EncodecLanguageModel(cfg, device="cpu", seed=1)
    b, k, t = 4, 3, 11
    seq = np.random.default_rng(1).integers(0, 17, size=(b, k, t))

    def run(rows):
        state, outs = lm.init_state(b), []
        inp = np.zeros((b, k, 1), np.int64)
        for step in range(t):
            probas, state = lm.step(inp, state)
            outs.append(probas.numpy())
            inp = np.stack([r[:, step:step + 1] for r in rows])
        return np.stack(outs)

    base = run(list(seq))
    perm = [2, 0, 3, 1]
    permuted = run([seq[p] for p in perm])
    for i, p in enumerate(perm):
        np.testing.assert_array_equal(permuted[:, i], base[:, p])
    zeros = np.zeros((k, t), np.int64)
    np.testing.assert_array_equal(run([seq[0], zeros, zeros, zeros])[:, 0], base[:, 0])


def test_lm_loads_upstream_names_and_matches_torch_oracle():
    """An upstream-named state dict (``model.`` prefix, torch layouts) loads
    strictly, and the LM matches the independent torch oracle built on
    nn.MultiheadAttention / nn.LayerNorm (tests/oracles.py)."""
    from oracles import EncodecLMOracle

    card, n_q, d, heads, layers, past = 17, 3, 32, 4, 2, 6
    torch.manual_seed(0)
    oracle = EncodecLMOracle(card, n_q, d, heads, 4 * d, layers, past).eval()
    sd = {f"model.{k}": v.numpy() for k, v in oracle.state_dict().items()}
    lm = EncodecLanguageModel(EncodecLMConfig(codebook_size=card, num_codebooks=n_q, dimension=d,
                                              num_heads=heads, num_layers=layers,
                                              past_context=past), device="cpu", seed=1)
    assert lm.load_state_dict(sd) is lm
    for k, v in oracle.state_dict().items():
        torch.testing.assert_close(lm.state_dict()[k], v, rtol=0, atol=0)
    codes = np.random.default_rng(2).integers(0, card + 1, size=(2, n_q, 11))
    ref = oracle(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(lm.forward_full(codes).numpy(), ref, rtol=2e-4, atol=2e-5)
    # fewer codebooks than the LM has: upstream embeds the K given (the
    # oracle too) and the port predicts those K
    ref = oracle(torch.from_numpy(codes[:, :2])).numpy()[:, :, :2]
    got = lm.forward_full(codes[:, :2]).numpy()
    assert got.shape == (2, card, 2, 11)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError):
        lm.forward_full(np.zeros((1, n_q + 1, 3), np.int64))
    with pytest.raises(RuntimeError):
        EncodecLanguageModel(lm.config, device="cpu").load_state_dict(
            {k: v for k, v in sd.items() if "linear2" not in k})


def test_from_jax_params_lm_layouts():
    jlm, lm = _golden_lms()
    sd = from_jax_params({k: np.asarray(v) for k, v in jlm.params.items()})
    assert tuple(sd["emb.0.weight"].shape) == (33, 32)
    np.testing.assert_array_equal(sd["emb.0.weight"].numpy(),
                                  np.asarray(jlm.params["emb.0.weight"]))
    p = "transformer.layers.1."
    for key, shape in (("self_attn.in_proj_weight", (96, 32)),
                       ("self_attn.out_proj.weight", (32, 32)),
                       ("linear1.weight", (128, 32)), ("linear2.weight", (32, 128))):
        assert tuple(sd[p + key].shape) == shape
        np.testing.assert_array_equal(sd[p + key].numpy(), np.asarray(jlm.params[p + key]).T)
    assert sorted(sd) == sorted(lm.state_dict())


def test_golden_blob_lm_from_jax_pdfs():
    """Driven by the JAX LM's pdfs, the port's compressor writes the
    golden's LM-coded stream byte for byte and decodes it to the golden's
    codes and the direct decode."""
    jlm, _ = _golden_lms()
    model, g = _golden_port()
    audio, blob_lm = g["audio"], g["blob_lm"].tobytes()
    assert model.compress(audio, use_lm=True, lm=ReplayLM(jlm)) == blob_lm
    metadata, frame_meta, payloads = compressor._parse_stream(model, blob_lm)
    codes = compressor._lm_decode_entries(ReplayLM(jlm), payloads, [frame_meta[0][0]],
                                          int(metadata["nc"]), 1)
    np.testing.assert_array_equal(codes[0], model.encode(audio)[0].codes.numpy()[0])
    direct = model.decode(model.encode(audio))[..., : audio.shape[0]]
    assert torch.equal(model.decompress(blob_lm, lm=ReplayLM(jlm)), direct)


def _tiny(**over) -> Encodec:
    return Encodec(port_config(tiny_config(**over)), device="cpu").eval()


def _small_lm(model, extra_heads: int = 0, seed: int = 3) -> EncodecLanguageModel:
    return EncodecLanguageModel(EncodecLMConfig(
        codebook_size=model.config.codebook_size, num_codebooks=model.num_codebooks + extra_heads,
        dimension=32, num_heads=2, num_layers=2, past_context=8), device="cpu", seed=seed)


def _audio(n: int, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _direct(model, audio) -> torch.Tensor:
    return model.decode(model.encode(audio))[..., : audio.shape[-1]]


def test_compress_lm_roundtrip_is_lossless():
    """A stream written through the port's LM decodes to the exact codes;
    the LM has two more codebooks than the stream carries, as the 24 kHz LM
    (32) has over a 6 kbps stream (8)."""
    model = _tiny()
    model.set_language_model(_small_lm(model, extra_heads=2))
    audio = _audio(800)
    blob = model.compress(audio, use_lm=True)
    header = ecdc.read_header(io.BytesIO(blob))
    assert header["lm"] is True and "lmb" not in header and "lp" not in header
    assert torch.equal(model.decompress(blob), _direct(model, audio))
    assert blob != model.compress(audio, use_lm=False)


@pytest.mark.parametrize("lm_batch", [1, 4, None])
def test_compress_batch_lm_roundtrip(lm_batch):
    model = _tiny()
    lm = _small_lm(model)
    audios = [_audio(n, seed=n) for n in (400, 320, 400)]
    blobs = model.compress_batch(audios, use_lm=True, lm=lm, lm_batch=lm_batch)
    header = ecdc.read_header(io.BytesIO(blobs[0]))
    assert header.get("lmb", 1) == (lm_batch or 4)  # None: next pow2 of 3 entries
    for blob, audio in zip(blobs, audios):
        assert torch.equal(model.decompress(blob, lm=lm), _direct(model, audio))
    for out, blob in zip(model.decompress_batch(blobs, lm=lm), blobs):
        assert torch.equal(out, model.decompress(blob, lm=lm))


@pytest.mark.parametrize("lm_batch", [1, 4])
def test_compress_lm_segmented_roundtrip(lm_batch):
    """A chunked model length-prefixes each frame's payload ('lp'); at
    lm_batch 4 its own frames share the LM steps."""
    model = _tiny(chunk_length_s=0.05, overlap=0.01, use_causal_conv=False)
    lm = _small_lm(model)
    audio = _audio(1800, seed=4)
    blob = model.compress(audio, use_lm=True, lm=lm, lm_batch=lm_batch)
    header = ecdc.read_header(io.BytesIO(blob))
    assert header["lp"] is True and header.get("lmb", 1) == lm_batch
    out = model.decompress(blob, lm=lm)
    assert torch.equal(out, _direct(model, audio))
    assert torch.equal(model.decompress_batch([blob], lm=lm)[0], out)
    stripped = _rewrite_header(blob, lp=False)
    with pytest.raises(CodecError, match="lp"):
        model.decompress(stripped, lm=lm)


def test_decompress_batch_mixed_bandwidths_and_raw():
    model = _tiny()
    lm = _small_lm(model)
    a1, a2 = _audio(800, seed=1), _audio(640, seed=2)
    model.set_target_bandwidth(20.0)
    b1 = model.compress(a1, use_lm=True, lm=lm)
    model.set_target_bandwidth(80.0)
    b2 = model.compress(a2, use_lm=True, lm=lm)
    b3 = model.compress(a2, use_lm=False)
    refs = [model.decompress(b, lm=lm) for b in (b1, b2, b3)]
    for out, ref in zip(model.decompress_batch([b1, b2, b3], lm=lm), refs):
        assert torch.equal(out, ref)
    assert refs[0].shape == (1, 1, 800)


def _rewrite_header(blob: bytes, **updates) -> bytes:
    stream = io.BytesIO(blob)
    metadata = ecdc.read_header(stream)
    metadata.update(updates)
    out = io.BytesIO()
    ecdc.write_header(out, metadata)
    out.write(stream.read())
    return out.getvalue()


def test_lmb_bounds_and_refusals():
    """'lmb' comes from an untrusted header and sizes the decoder's state:
    out of [1, MAX_LM_BATCH] or not a number is a CodecError on decode, and
    lm_batch outside it one on encode."""
    model = _tiny()
    lm = _small_lm(model)
    audio = _audio(800)
    blob = model.compress(audio, use_lm=True, lm=lm)
    for bad in (-1, 0, 10 ** 9, "abc", None, compressor.MAX_LM_BATCH + 1):
        tampered = _rewrite_header(blob, lmb=bad)
        with pytest.raises(CodecError):
            model.decompress(tampered, lm=lm)
        with pytest.raises(CodecError):
            model.decompress_batch([tampered], lm=lm)
    assert compressor._lmb_from_metadata({"lmb": compressor.MAX_LM_BATCH}) == 64
    assert compressor._lmb_from_metadata({}) == 1
    for bad in (0, -4, compressor.MAX_LM_BATCH + 1):
        with pytest.raises(CodecError):
            model.compress(audio, use_lm=True, lm=lm, lm_batch=bad)
    assert model.compress_batch([], use_lm=True) == []
    with pytest.raises(CodecError):
        model.compress(np.zeros((2, 800), np.float32), use_lm=True, lm=lm)


def test_get_language_model():
    """At 24 kHz the LM is the pretrained one's width (dimension 200, 8
    heads, 5 layers, past context int(3.5 x 75) = 262); download=True
    refuses, naming the loader's ROADMAP item; the LM is built once, lives
    on the model's device and stays out of the model's state dict."""
    model = _tiny(sampling_rate=24000, upsampling_ratios=[8, 5, 4, 2])
    with pytest.raises(LoadError, match="ROADMAP"):
        model.get_language_model()
    keys = sorted(model.state_dict())
    lm = model.get_language_model(download=False)
    cfg = lm.config
    assert (cfg.dimension, cfg.num_heads, cfg.num_layers, cfg.past_context) == (200, 8, 5, 262)
    assert (cfg.num_codebooks, cfg.codebook_size) == (model.num_codebooks, 32)
    assert model.get_language_model() is lm and lm.device == model.device
    assert sorted(model.state_dict()) == keys
    other = _small_lm(model)
    model.set_language_model(other)
    assert model.get_language_model() is other
    # the seed alone fixes the weights
    again = EncodecLanguageModel(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm.state_dict().values(),
                                                 again.state_dict().values()))
