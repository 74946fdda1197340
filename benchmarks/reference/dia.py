"""Plain Dia 1.6B in float32 PyTorch: the benchmark's reference.

Written from the published model (github.com/nari-labs/dia, ``dia/layers.py``
and ``dia/model.py``; huggingface.co/nari-labs/Dia-1.6B ``config.json``)
under its checkpoint's parameter names, with every width read from a
configuration dict (``configs/*.json``). Nothing of the program under test is
imported: the text bytes, the delay pattern, the weights and the guidance
are worked out here again.

    encoder: byte embedding -> n_layer x [x + SA(rms(x)), x + MLP(rms(x))]
             -> rms; SA is full attention among the real (non-pad) bytes
    decoder: the channels' embeddings summed -> n_layer x [x + causal GQA
             SA(rms(x)), x + cross-attention to the encoder (keys of pad
             bytes masked), x + MLP(rms(x))] -> rms -> logits [C, V] a
             position
    attention: RoPE (split halves, timescale min * (max / min)^(2i / d)) on
             q and k, scores at scale 1 (the q projection holds 1 / sqrt(d)),
             softmax in f32; a row with every key masked gives zeros
    MLP: silu(x W_gate) * (x W_up), then W_out

``logits`` is a full teacher-forced forward, the decode loop's function of
the tokens so far at every position at once; ``guided`` applies
classifier-free guidance (cond + s (cond - uncond)), the per-channel
vocabulary mask and the EOS scale, as the sampler sees the logits;
``sampler_logprobs`` is the distribution the sampler draws a token from at
each position (EOS only where it is the best score; temperature, top-k,
top-p).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, name -> shape ([in..., out...] for projections), in
    a fixed order."""
    e, d, data = cfg["encoder"], cfg["decoder"], cfg["data"]
    s: dict[str, tuple[int, ...]] = {"encoder.embedding.weight": (cfg["vocab_size"], e["n_embd"])}
    for i in range(e["n_layer"]):
        p, h, hd, n = f"encoder.layers.{i}", e["n_head"], e["head_dim"], e["n_embd"]
        s.update({f"{p}.pre_sa_norm.weight": (n,),
                  f"{p}.self_attention.q_proj.weight": (n, h, hd),
                  f"{p}.self_attention.k_proj.weight": (n, h, hd),
                  f"{p}.self_attention.v_proj.weight": (n, h, hd),
                  f"{p}.self_attention.o_proj.weight": (h, hd, n),
                  f"{p}.post_sa_norm.weight": (n,),
                  f"{p}.mlp.wi_fused.weight": (n, 2, e["n_hidden"]),
                  f"{p}.mlp.wo.weight": (e["n_hidden"], n)})
    s["encoder.norm.weight"] = (e["n_embd"],)
    for c in range(data["channels"]):
        s[f"decoder.embeddings.{c}.weight"] = (cfg["tgt_vocab_size"], d["n_embd"])
    for i in range(d["n_layer"]):
        p, n, hd = f"decoder.layers.{i}", d["n_embd"], d["gqa_head_dim"]
        hq, hkv, hc, hcd = d["gqa_query_heads"], d["kv_heads"], d["cross_query_heads"], \
            d["cross_head_dim"]
        s.update({f"{p}.pre_sa_norm.weight": (n,),
                  f"{p}.self_attention.q_proj.weight": (n, hq, hd),
                  f"{p}.self_attention.k_proj.weight": (n, hkv, hd),
                  f"{p}.self_attention.v_proj.weight": (n, hkv, hd),
                  f"{p}.self_attention.o_proj.weight": (hq, hd, n),
                  f"{p}.pre_ca_norm.weight": (n,),
                  f"{p}.cross_attention.q_proj.weight": (n, hc, hcd),
                  f"{p}.cross_attention.k_proj.weight": (e["n_embd"], hc, hcd),
                  f"{p}.cross_attention.v_proj.weight": (e["n_embd"], hc, hcd),
                  f"{p}.cross_attention.o_proj.weight": (hc, hcd, n),
                  f"{p}.pre_mlp_norm.weight": (n,),
                  f"{p}.mlp.wi_fused.weight": (n, 2, d["n_hidden"]),
                  f"{p}.mlp.wo.weight": (d["n_hidden"], n)})
    s["decoder.norm.weight"] = (d["n_embd"],)
    s["decoder.logits_dense.weight"] = (d["n_embd"], data["channels"], cfg["tgt_vocab_size"])
    return s


def _scale(key: str, shape: tuple[int, ...]) -> float:
    """The draw's standard deviation: 0.02 for embeddings, 1 / sqrt(fan_in)
    for projections, times 1 / sqrt(head_dim) for every q projection (a
    trained Dia folds the attention scale into it)."""
    if ".embedding" in key:
        return 0.02
    fan_in = shape[0] * shape[1] if key.endswith("o_proj.weight") else shape[0]
    std = fan_in ** -0.5
    return std * shape[-1] ** -0.5 if key.endswith("q_proj.weight") else std


def draw_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded f32 weights on ``device`` from one normal draw, sliced and
    scaled (``_scale``); norms 1. Channel 0's EOS column of the logits head
    is zero, so EOS is never the argmax and every row runs to the forced
    EOS at its token limit: each seed does the same work."""
    shapes = param_shapes(cfg)
    drawn = [k for k in shapes if not k.endswith("norm.weight")]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=device)
    out, at = {}, 0
    for k in drawn:
        n = math.prod(shapes[k])
        out[k] = z[at:at + n].view(shapes[k]).mul_(_scale(k, shapes[k]))
        at += n
    for k in shapes:
        if k.endswith("norm.weight"):
            out[k] = torch.ones(shapes[k], device=device)
    out["decoder.logits_dense.weight"][:, 0, cfg["data"]["audio_eos_value"]] = 0.0
    return {k: out[k] for k in shapes}


@contextlib.contextmanager
def precision():
    """float32 products with TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def text_tokens(cfg: dict, text: str) -> np.ndarray:
    """UTF-8 bytes, [S1] -> 1 and [S2] -> 2, at most text_length."""
    raw = text.encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]", b"\x02")
    return np.frombuffer(raw[: cfg["data"]["text_length"]], np.uint8).astype(np.int64)


def delayed_tokens(cfg: dict, codes: np.ndarray) -> np.ndarray:
    """The decoder's input sequence [L + max_delay, C] for ``codes`` [L, C]
    generated until the token limit forced EOS: channel c holds BOS at
    positions 0..delay[c], code t at 1 + delay[c] + t, then EOS, then PAD."""
    data = cfg["data"]
    length, channels = codes.shape
    delays = data["delay_pattern"]
    out = np.empty((length + max(delays), channels), np.int64)
    for c, dly in enumerate(delays):
        col = np.full(out.shape[0], data["audio_pad_value"], np.int64)
        col[: dly + 1] = data["audio_bos_value"]
        n = min(length, out.shape[0] - dly - 1)
        col[dly + 1: dly + 1 + n] = codes[:n, c]
        if dly + 1 + length < out.shape[0]:
            col[dly + 1 + length] = data["audio_eos_value"]
        out[:, c] = col
    return out


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x [B, T, H, D], positions [T]."""
    d = x.shape[-1]
    lo, hi = cfg["rope_min_timescale"], cfg["rope_max_timescale"]
    timescale = lo * (hi / lo) ** (2.0 * torch.arange(d // 2, device=x.device) / d)
    angle = positions.to(torch.float32)[:, None, None] / timescale
    sin, cos = torch.sin(angle), torch.cos(angle)
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q [B, T, Hq, D], k / v [B, S, Hkv, D] (each kv head serves Hq / Hkv
    consecutive q heads), mask [B, T, S] True = attend -> [B, T, Hq, D]."""
    group = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    scores = scores.masked_fill(~mask[:, None], -math.inf)
    weights = torch.nan_to_num(torch.softmax(scores, dim=-1))
    return torch.einsum("bhts,bshd->bthd", weights, v)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] with w [D, ...]."""
    return torch.tensordot(x, w, dims=1)


def _out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H, D] with w [H, D, N]."""
    return torch.tensordot(x, w, dims=2)


def _mlp(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    h = _proj(x, w[f"{p}.mlp.wi_fused.weight"])
    return _proj(F.silu(h[..., 0, :]) * h[..., 1, :], w[f"{p}.mlp.wo.weight"])


def encode(w: dict, cfg: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Text tokens [B, S] (0 = pad) -> (encoder output [B, S, N], real [B, S])."""
    eps = cfg["normalization_layer_epsilon"]
    real = tokens != cfg["data"]["text_pad_value"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    mask = real[:, :, None] & real[:, None, :]
    x = w["encoder.embedding.weight"][tokens]
    for i in range(cfg["encoder"]["n_layer"]):
        p = f"encoder.layers.{i}"
        h = rms(x, w[f"{p}.pre_sa_norm.weight"], eps)
        a = f"{p}.self_attention"
        q = rope(_proj(h, w[f"{a}.q_proj.weight"]), pos, cfg)
        k = rope(_proj(h, w[f"{a}.k_proj.weight"]), pos, cfg)
        x = x + _out(attend(q, k, _proj(h, w[f"{a}.v_proj.weight"]), mask),
                     w[f"{a}.o_proj.weight"])
        x = x + _mlp(w, p, rms(x, w[f"{p}.post_sa_norm.weight"], eps))
    return rms(x, w["encoder.norm.weight"], eps), real


@torch.no_grad()
def logits(w: dict, cfg: dict, text: np.ndarray, tokens: np.ndarray) -> torch.Tensor:
    """One request's logits [2, P, C, V] (row 0 unconditional: no text; row
    1 conditioned on ``text`` [S]), teacher-forced on the decoder input
    ``tokens`` [P, C]: position p's logits predict position p + 1."""
    dev = w["decoder.norm.weight"].device
    eps = cfg["normalization_layer_epsilon"]
    txt = torch.as_tensor(text, device=dev)
    enc, real = encode(w, cfg, torch.stack([torch.zeros_like(txt), txt]))
    tok = torch.as_tensor(tokens, device=dev)
    length = tok.shape[0]
    x = sum(w[f"decoder.embeddings.{c}.weight"][tok[:, c]] for c in range(tok.shape[1]))
    x = x[None].expand(2, -1, -1)
    pos = torch.arange(length, device=dev)
    causal = torch.ones(length, length, dtype=torch.bool, device=dev).tril()
    causal = causal[None].expand(2, -1, -1)
    cross_mask = real[:, None, :].expand(2, length, real.shape[1])
    enc_pos = torch.arange(enc.shape[1], device=dev)
    for i in range(cfg["decoder"]["n_layer"]):
        p = f"decoder.layers.{i}"
        h = rms(x, w[f"{p}.pre_sa_norm.weight"], eps)
        a = f"{p}.self_attention"
        q = rope(_proj(h, w[f"{a}.q_proj.weight"]), pos, cfg)
        k = rope(_proj(h, w[f"{a}.k_proj.weight"]), pos, cfg)
        x = x + _out(attend(q, k, _proj(h, w[f"{a}.v_proj.weight"]), causal),
                     w[f"{a}.o_proj.weight"])
        h = rms(x, w[f"{p}.pre_ca_norm.weight"], eps)
        a = f"{p}.cross_attention"
        q = rope(_proj(h, w[f"{a}.q_proj.weight"]), pos, cfg)
        k = rope(_proj(enc, w[f"{a}.k_proj.weight"]), enc_pos, cfg)
        k = torch.where(real[:, :, None, None], k, 0.0)
        x = x + _out(attend(q, k, _proj(enc, w[f"{a}.v_proj.weight"]), cross_mask),
                     w[f"{a}.o_proj.weight"])
        x = x + _mlp(w, p, rms(x, w[f"{p}.pre_mlp_norm.weight"], eps))
    return _proj(rms(x, w["decoder.norm.weight"], eps), w["decoder.logits_dense.weight"])


def guided(cfg: dict, logits2: torch.Tensor) -> torch.Tensor:
    """[2, P, C, V] -> the sampler's scores [P, C, V]: cond + cfg_scale
    (cond - uncond); tokens past EOS, and EOS itself on channels other than
    the first, at -inf; the first channel's EOS times 0.8."""
    eos = cfg["data"]["audio_eos_value"]
    uncond, cond = logits2[0].float(), logits2[1].float()
    out = cond + cfg["cfg_scale"] * (cond - uncond)
    vocab = torch.arange(out.shape[-1], device=out.device)
    first = torch.arange(out.shape[1], device=out.device)[:, None] == 0
    invalid = (vocab > eos) | (~first & (vocab >= eos))
    out = out.masked_fill(invalid, -math.inf)
    out[:, 0, eos] *= 0.8
    return out


def sampler_logprobs(cfg: dict, scores: torch.Tensor) -> torch.Tensor:
    """Guided scores [..., V] -> the log-probabilities [..., V] of the token
    that temperature / top-k / top-p sampling draws: EOS only where it is the
    best score; the scores over ``temperature``; the ``top_k`` best kept
    (ties with the k-th too); of those, the fewest best whose probabilities
    sum past ``top_p`` (the one that passes it included), ties with the last
    one kept; -inf outside."""
    eos = cfg["data"]["audio_eos_value"]
    z = scores.float().clone()
    z[..., eos] = torch.where(z.argmax(-1) == eos, z[..., eos], -math.inf)
    z = z / cfg["temperature"]
    if cfg["top_k"] > 0:
        kth = torch.topk(z, min(cfg["top_k"], z.shape[-1]), dim=-1).values[..., -1:]
        z = z.masked_fill(z < kth, -math.inf)
    if cfg["top_p"] < 1.0:
        probs = torch.softmax(z, dim=-1)
        ranked = torch.sort(probs, dim=-1, descending=True).values
        cut = (torch.cumsum(ranked, dim=-1) <= cfg["top_p"]).sum(-1, keepdim=True)
        z = z.masked_fill(probs < ranked.gather(-1, cut.clamp(max=z.shape[-1] - 1)), -math.inf)
    return torch.log_softmax(z, dim=-1)
