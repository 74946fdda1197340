"""The port's streaming Encodec sessions against the JAX package's, on the CPU.

The parameters of ``ecdc_golden.npz`` (``tiny_config()``: causal, mono,
hop 8) drive both packages. The port's ``StreamingEncoder`` must give the
JAX session's codes (at least 99% equal, as tests/test_streaming.py asks of
a session against the full encode), its ``StreamingDecoder`` the JAX
session's audio within rtol 1e-4 / atol 1e-5, and both the full forward
once the first push is long enough. A first push reflects its own samples
at each conv's left edge, and a conv whose input is no longer than its
context takes the short-input fallback there, which the full forward does
not: here, and in Encodec-24k, a first push of fewer than 7 hops does (the
last encoder conv and the first decoder conv, k = 7, see one frame a hop).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.encodec import streaming as jstreaming
from neuralcodecs_tpu_torch.core.exceptions import CodecError
from neuralcodecs_tpu_torch.models.encodec import (
    StreamingDecoder,
    StreamingEncoder,
    stream_roundtrip,
    streaming,
)
from neuralcodecs_tpu_torch.models.encodec.seanet import SConv1d, SConvTranspose1d, SLSTM
from test_encodec import tiny_config
from test_torch_encodec import _golden_port, port_config

AUDIO_TOL = dict(rtol=1e-4, atol=1e-5)
HOPS = 40


@pytest.fixture(scope="module")
def pair():
    """The JAX Encodec and the port with the golden's weights."""
    port, g = _golden_port()
    params = {k[3:]: jnp.asarray(g[k]) for k in g.files if k.startswith("sd/")}
    return JEncodec(tiny_config(), params=params), port


def _audio(n: int, seed: int = 0, batch: int | None = None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def _pushes(first: int, chunk: int, total: int) -> list[tuple[int, int]]:
    """(start, end) in hops: a first push, then pushes of ``chunk``."""
    return [(0, first)] + [(o, min(o + chunk, total)) for o in range(first, total, chunk)]


def _encode(session, audio: np.ndarray, hop: int, pushes) -> np.ndarray:
    return np.concatenate([np.asarray(session.push(audio[..., a * hop: b * hop]))
                           for a, b in pushes], axis=-1)


def _decode(session, codes: np.ndarray, pushes) -> np.ndarray:
    return np.concatenate([np.asarray(session.push(codes[..., a:b])) for a, b in pushes], axis=1)


def _full_decode(model, codes: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        out = model.decoder(model.quantizer.decode(torch.from_numpy(codes)))
    return out.transpose(1, 2).numpy()


@pytest.mark.parametrize("first,chunk", [(1, 1), (8, 1), (12, 12)])
def test_streaming_matches_jax_and_full(pair, first, chunk):
    """One-hop pushes from the start, one-hop pushes after an 8-hop first
    push, and 12-hop pushes: codes and audio against the JAX sessions at the
    same pushes, and against the full forward where the first push is long
    enough."""
    jmodel, port = pair
    hop = port.encoder.hop_length
    audio = _audio(HOPS * hop)
    pushes = _pushes(first, chunk, HOPS)
    n_q = port._n_q()
    got = _encode(StreamingEncoder(port, n_q=n_q), audio, hop, pushes)
    want = _encode(jstreaming.StreamingEncoder(jmodel, n_q=n_q), audio, hop, pushes)
    assert got.shape == want.shape == (1, n_q, HOPS) and got.dtype == np.int32
    assert (got == want).mean() >= 0.99
    audio_out = _decode(StreamingDecoder(port), got, pushes)
    np.testing.assert_allclose(audio_out, _decode(jstreaming.StreamingDecoder(jmodel), got, pushes),
                               **AUDIO_TOL)
    assert audio_out.shape == (1, HOPS * hop, 1)
    if first >= 7:
        assert (got == port.encode(audio)[0].codes.numpy()).mean() >= 0.99
        np.testing.assert_allclose(audio_out, _full_decode(port, got), **AUDIO_TOL)


def test_streaming_batch_of_sessions(pair):
    """A [B, T] push runs B sessions as one batch, each as if alone; a
    [B, T, C] push is the same chunk."""
    _, port = pair
    hop = port.encoder.hop_length
    audio = _audio(16 * hop, seed=1, batch=3)
    pushes = _pushes(8, 2, 16)
    batch = _encode(StreamingEncoder(port), audio, hop, pushes)
    assert batch.shape[0] == 3
    for i in range(3):
        np.testing.assert_array_equal(batch[i: i + 1],
                                      _encode(StreamingEncoder(port), audio[i], hop, pushes))
    enc = StreamingEncoder(port)
    np.testing.assert_array_equal(enc.push(audio[..., :8 * hop, None]).numpy(), batch[..., :8])


def test_block_hops_decomposition_and_warm(pair):
    """``block_hops`` splits every push after the first into sub-steps of
    the given sizes; the codes and audio equal whole-chunk pushes, and a
    ``warm()`` in the middle of a session leaves its state alone."""
    _, port = pair
    hop = port.encoder.hop_length
    audio = _audio(30 * hop, seed=3)
    ref, blocked = StreamingEncoder(port), StreamingEncoder(port, block_hops=(4, 1))
    assert blocked.block_hops == (4, 1)
    ref_codes, got_codes = [], []
    for a, b in ((0, 8), (8, 23), (23, 30)):  # 15 hops -> 4 + 4 + 4 + 1 + 1 + 1
        ref_codes.append(ref.push(audio[a * hop: b * hop]).numpy())
        got_codes.append(blocked.push(audio[a * hop: b * hop]).numpy())
        blocked.warm()
    ref_codes, got_codes = np.concatenate(ref_codes, -1), np.concatenate(got_codes, -1)
    assert (ref_codes == got_codes).mean() >= 0.99
    dec_ref, dec_blk = StreamingDecoder(port), StreamingDecoder(port, block_hops=(4, 1))
    dec_blk.warm()
    for sl in (slice(0, 8), slice(8, 23), slice(23, 30)):
        np.testing.assert_allclose(dec_blk.push(ref_codes[..., sl]).numpy(),
                                   dec_ref.push(ref_codes[..., sl]).numpy(), **AUDIO_TOL)


@pytest.mark.parametrize("total,blocks", [(0, (1,)), (15, (4, 1)), (23, (8, 3, 1)), (7, (8, 1))])
def test_decompose_and_norm_blocks_match_jax(total, blocks):
    assert streaming._decompose(total, blocks) == jstreaming._decompose(total, blocks)
    for raw in (blocks, list(reversed(blocks)) + [0, -2], None, (), (8, 4)):
        assert streaming._norm_blocks(raw) == jstreaming._norm_blocks(raw)


def test_reset_restarts_the_session(pair):
    _, port = pair
    hop = port.encoder.hop_length
    audio = _audio(16 * hop, seed=4)
    enc, dec = StreamingEncoder(port), StreamingDecoder(port)
    c1 = enc.push(audio[: 8 * hop])
    a1 = dec.push(c1)
    enc.push(audio[8 * hop:])
    dec.push(c1)
    enc.reset()
    dec.reset()
    assert torch.equal(enc.push(audio[: 8 * hop]), c1)
    assert torch.equal(dec.push(c1), a1)


def test_stream_roundtrip_ragged_tail_matches_jax(pair):
    """A tail off the hop grid is zero-padded, pushed, and the output
    trimmed back to the input length."""
    jmodel, port = pair
    hop = port.encoder.hop_length
    audio = _audio(24 * hop + 3, seed=5)
    out, codes = stream_roundtrip(port, audio, chunk_samples=8 * hop)
    want_out, want_codes = jstreaming.stream_roundtrip(jmodel, audio, chunk_samples=8 * hop)
    assert out.shape == (1, 24 * hop + 3, 1) and len(codes) == len(want_codes) == 4
    assert [c.shape[-1] for c in codes] == [8, 8, 8, 1]
    got = torch.cat(codes, -1).numpy()
    assert (got == np.concatenate([np.asarray(c) for c in want_codes], -1)).mean() >= 0.99
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **AUDIO_TOL)
    with pytest.raises(CodecError):
        stream_roundtrip(port, audio, chunk_samples=hop + 1)


@pytest.mark.parametrize("over", [dict(use_causal_conv=False), dict(normalize=True),
                                  dict(norm_type="time_group_norm"),
                                  dict(chunk_length_s=0.05, overlap=0.01)])
def test_check_streamable_refusals(over):
    from neuralcodecs_tpu_torch.models.encodec import Encodec

    model = Encodec(port_config(tiny_config(**over)), device="cpu")
    with pytest.raises(CodecError):
        StreamingEncoder(model)
    with pytest.raises(CodecError):
        StreamingDecoder(model)


def test_streaming_refuses_a_chunk_off_the_hop_grid(pair):
    _, port = pair
    with pytest.raises(CodecError, match="multiple of the hop"):
        StreamingEncoder(port).push(np.zeros(port.encoder.hop_length + 1, np.float32))


def test_layer_streams_equal_their_forward():
    """Each stateful layer pushed in pieces equals its full forward: the
    causal conv with dilation and stride, the transposed conv (its tail
    carried before the bias), and the SLSTM with its (h, c) [L, B, H]."""
    torch.manual_seed(0)
    x = torch.randn(2, 6, 24)
    cases = [(SConv1d(6, 5, 3, dilation=2, causal=True), 24, [8, 4, 12]),
             (SConv1d(6, 4, 8, stride=4, causal=True), 24, [8, 4, 12]),
             (SConvTranspose1d(6, 3, 8, stride=4, causal=True), 24, [1, 7, 16]),
             (SLSTM(6, 2), 24, [5, 1, 18])]
    for layer, t, pieces in cases:
        with torch.no_grad():
            want = layer(x[..., :t])
            state, outs, off = None, [], 0
            for n in pieces:
                out, state = layer.stream(x[..., off: off + n], state)
                outs.append(out)
                off += n
        torch.testing.assert_close(torch.cat(outs, -1), want, rtol=1e-5, atol=1e-6)
        if isinstance(layer, SLSTM):
            assert [tuple(s.shape) for s in state] == [(2, 2, 6), (2, 2, 6)]
    with pytest.raises(ValueError):
        SConv1d(6, 5, 3).stream(x, None)
    with pytest.raises(ValueError):
        SConvTranspose1d(6, 3, 8, stride=4, causal=True, trim_right_ratio=0.5).stream(x, None)
