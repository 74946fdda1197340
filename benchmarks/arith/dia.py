"""Operations and bytes of Dia's generation, from the configuration's shapes.

A configuration is the dict of ``configs/<name>.json``. ``rows`` counts the
classifier-free-guidance rows (two a request). FLOPs count two a
multiply-add of the projections and of attention's two products; norms,
RoPE, softmax and sampling are left out.

A decode step reads every decoder projection it multiplies (self q / k / v
/ o, cross q / o, the MLP, the logits head) in the compute dtype, the
self-attention K/V of the ``live`` positions written so far and the cross
K/V of the text bucket; the cross K/V projections ran once, at the start.
"""

from __future__ import annotations


def _decoder_layer_step_params(cfg: dict) -> int:
    d = cfg["decoder"]
    q = d["n_embd"] * d["gqa_query_heads"] * d["gqa_head_dim"]
    kv = 2 * d["n_embd"] * d["kv_heads"] * d["gqa_head_dim"]
    cross_q = d["n_embd"] * d["cross_query_heads"] * d["cross_head_dim"]
    mlp = 3 * d["n_embd"] * d["n_hidden"]
    return 2 * q + kv + 2 * cross_q + mlp   # q, o; k, v; cross q, o; wi (2 I), wo


def logits_params(cfg: dict) -> int:
    return cfg["decoder"]["n_embd"] * cfg["data"]["channels"] * cfg["tgt_vocab_size"]


def step_params(cfg: dict) -> int:
    """Parameters a decode step multiplies."""
    return cfg["decoder"]["n_layer"] * _decoder_layer_step_params(cfg) + logits_params(cfg)


def step_bytes(cfg: dict, rows: int, text_len: int, live: int, act_bytes: int = 2) -> float:
    """Bytes a decode step must read: the projections in the compute dtype
    (``act_bytes``), the self K/V of ``live`` positions and the cross K/V
    of ``text_len``, all in the compute dtype."""
    d = cfg["decoder"]
    kv = d["n_layer"] * 2 * rows * live * d["kv_heads"] * d["gqa_head_dim"] * act_bytes
    cross = (d["n_layer"] * 2 * rows * text_len * d["cross_query_heads"] * d["cross_head_dim"]
             * act_bytes)
    return step_params(cfg) * act_bytes + kv + cross


def step_flops(cfg: dict, rows: int, text_len: int, live: int) -> float:
    d = cfg["decoder"]
    attn = d["n_layer"] * 4.0 * rows * (d["gqa_query_heads"] * d["gqa_head_dim"] * live
                                        + d["cross_query_heads"] * d["cross_head_dim"]
                                        * text_len)
    return 2.0 * step_params(cfg) * rows + attn


def encoder_flops(cfg: dict, rows: int, text_len: int) -> float:
    """The encoder over the text bucket, then every decoder layer's cross
    K/V projection of its output."""
    e, d = cfg["encoder"], cfg["decoder"]
    per_token = 4 * e["n_embd"] * e["n_head"] * e["head_dim"] + 3 * e["n_embd"] * e["n_hidden"]
    attn = 4.0 * rows * text_len * text_len * e["n_head"] * e["head_dim"]
    cross_kv = 2 * e["n_embd"] * d["cross_query_heads"] * d["cross_head_dim"]
    return e["n_layer"] * (2.0 * rows * text_len * per_token + attn) \
        + d["n_layer"] * 2.0 * rows * text_len * cross_kv


def generate_flops(cfg: dict, rows: int, text_len: int, prefill: int, steps: int) -> float:
    """Encoder, a prefill of ``prefill`` positions, and ``steps`` decode
    steps from position 0, the step at position p reading p + 1 slots."""
    total = encoder_flops(cfg, rows, text_len)
    total += sum(step_flops(cfg, rows, text_len, p + 1) for p in range(prefill))
    return total + sum(step_flops(cfg, rows, text_len, p + 1) for p in range(steps))
