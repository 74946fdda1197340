"""The plain Dia reference against the port's CPU path at a tiny width.

The port in float32 on the CPU, with the reference's seeded weights: its
prefill pass over the first tokens and then its cached decode steps, one
position at a time, teacher-forced on the same tokens, must give the
reference's full forward's logits within 1e-4 absolute (logits of order 1;
both are f32, and differ only in the order of sums and in the cache's
path, ~1e-6). A greedy generation's served tokens are then exactly the
reference's argmax (gap 0) at every served position, and a sampled one's
lie in the support of the reference's sampler, whose kept set is the
port's sampler's, token for token.
"""

import numpy as np
import pytest
import torch

from benchmarks.drivers import tts_generate
from benchmarks.reference import dia as ref
from benchmarks.tests.tiny import DIA, TEXTS

CFG = dict(DIA, compute_dtype="float32")


def _port(weights, dtype=torch.float32):
    from neuralcodecs_tpu_torch.models.dia import Dia

    model = Dia(tts_generate._port_config(CFG), device="cpu", compute_dtype=dtype)
    model.load_state_dict(weights)
    return model.eval()


def test_param_shapes_are_the_checkpoint_keys():
    own = _port(ref.draw_weights(CFG, 0, "cpu")).state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == ref.param_shapes(CFG)


def test_text_tokens_are_the_ports():
    model = _port(ref.draw_weights(CFG, 0, "cpu"))
    for text in TEXTS + ["[S1] été [S2] café"]:
        assert np.array_equal(ref.text_tokens(CFG, text), model.encode_text(text))


@torch.no_grad()
def _port_prefill_then_steps(model, text: np.ndarray, tokens: np.ndarray, prefill: int):
    """[2, P, C, V] logits: the port's prefill pass over tokens[:prefill],
    then one cached decode step a position."""
    from neuralcodecs_tpu_torch.models.dia.layers import KVCacheSlot

    d = model.config.decoder
    txt = torch.as_tensor(text)[None]
    enc_input = torch.cat([torch.zeros_like(txt), txt])
    mask = enc_input != 0
    enc = model._encode_fn(enc_input, mask)
    pos_enc = torch.arange(enc_input.shape[1])[None]
    cross = [layer.cross_attention.precompute_cross_cache(enc, pos_enc, mask)
             for layer in model.decoder.layers]
    caches = [KVCacheSlot.zeros(2, tokens.shape[0], d.kv_heads, d.gqa_head_dim)
              for _ in model.decoder.layers]
    tok = torch.as_tensor(tokens)[None].expand(2, -1, -1)
    x = model._embed_tokens(tok[:, :prefill])
    positions = torch.arange(prefill)[None]
    causal = torch.ones(prefill, prefill, dtype=torch.bool).tril()[None].expand(2, -1, -1)
    for layer, cc, sc in zip(model.decoder.layers, cross, caches):
        x = layer.prefill(x, positions, causal, cc, mask[:, None, :].expand(2, prefill, -1), sc)
    out = [model._decoder_logits(x)]
    for p in range(prefill, tokens.shape[0]):
        x = model._embed_tokens(tok[:, p:p + 1])
        position = torch.full((2, 1), p)
        for layer, cc, sc in zip(model.decoder.layers, cross, caches):
            x = layer.step(x, position, p, sc, cc, mask[:, None, :])
        out.append(model._decoder_logits(x))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("seed,text", [(1, TEXTS[0]), (2, TEXTS[3])])
def test_prefill_and_cached_steps_match_the_reference(seed, text):
    w = ref.draw_weights(CFG, seed, "cpu")
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1024, size=(20, CFG["data"]["channels"]))
    tokens = ref.delayed_tokens(CFG, codes)
    txt = ref.text_tokens(CFG, text)
    want = ref.logits(w, CFG, txt, tokens)
    got = _port_prefill_then_steps(_port(w), txt, tokens, prefill=5)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def test_delayed_tokens_follow_the_delay_pattern():
    codes = np.arange(12).reshape(4, 3)
    tok = ref.delayed_tokens(CFG, codes)
    bos, eos, pad = 1026, 1024, 1025
    assert tok.shape == (6, 3)
    assert tok[:, 0].tolist() == [bos, 0, 3, 6, 9, eos]
    assert tok[:, 1].tolist() == [bos, bos, 1, 4, 7, 10]
    assert tok[:, 2].tolist() == [bos, bos, bos, 2, 5, 8]
    del pad


def test_greedy_served_tokens_are_the_reference_argmax():
    w = ref.draw_weights(CFG, 3, "cpu")
    model = _port(w)
    texts = TEXTS[:2]
    codes, lengths = model.generate_codes(texts, max_tokens=24, temperature=0.0, seed=5)
    assert (lengths == 24 - max(CFG["data"]["delay_pattern"]) - 1).all()
    for r, text in enumerate(texts):
        length = int(lengths[r])
        scores = ref.guided(CFG, ref.logits(w, CFG, ref.text_tokens(CFG, text),
                                            ref.delayed_tokens(CFG, codes[r, :length])))
        pos, chan, served = tts_generate._served(CFG, codes[r], length)
        assert float(tts_generate._gaps(scores, pos, chan, served).max()) == 0.0


@pytest.mark.parametrize("scale", [0.3, 3.0, 30.0])
def test_sampler_support_is_the_ports(scale):
    """Token v is in the port's kept set where a noise spike on v alone
    makes the port's sampler draw v: that set is where the reference's
    log-probabilities are finite, at flat scores (top-k decides), middling
    and peaked ones (top-p decides)."""
    from neuralcodecs_tpu_torch.models.dia.model import _sample_next_token

    gen = torch.Generator().manual_seed(int(scale * 10))
    logits = torch.randn(2, 1, 3, 1028, generator=gen) * scale
    scores = ref.guided(CFG, torch.cat([logits * 0.9, logits]))[0]      # [3, V]
    lp = ref.sampler_logprobs(CFG, scores)
    v = scores.shape[-1]
    for c in range(scores.shape[0]):
        rows = scores[c].expand(v, v)
        spike = torch.eye(v) * 1e6
        drawn = _sample_next_token(rows, spike, CFG["temperature"], CFG["top_k"],
                                   CFG["top_p"], CFG["data"]["audio_eos_value"])
        kept = drawn == torch.arange(v)
        assert torch.equal(kept, torch.isfinite(lp[c])), c
        assert 1 <= int(kept.sum()) <= CFG["top_k"]


def test_sampled_served_tokens_lie_in_the_reference_support():
    """f32 sampling: every served token is one the reference's sampler can
    draw, and the call's steps are the decode steps the loop took."""
    w = ref.draw_weights(CFG, 4, "cpu")
    model = _port(w)
    taken = []
    advance = model._advance
    model._advance = lambda st, s: (taken.append(1), advance(st, s))
    # 32 tokens: the loop's last step is a stop test's (every 32 steps)
    codes, lengths = model.generate_codes(TEXTS[:2], max_tokens=32, seed=9)
    assert tts_generate.steps(CFG, lengths) == len(taken)
    for r, text in enumerate(TEXTS[:2]):
        length = int(lengths[r])
        scores = ref.guided(CFG, ref.logits(w, CFG, ref.text_tokens(CFG, text),
                                            ref.delayed_tokens(CFG, codes[r, :length])))
        pos, chan, served = tts_generate._served(CFG, codes[r], length)
        lp = ref.sampler_logprobs(CFG, scores[torch.as_tensor(pos), torch.as_tensor(chan)])
        assert torch.isfinite(lp.gather(-1, torch.as_tensor(served).long()[:, None])).all()
