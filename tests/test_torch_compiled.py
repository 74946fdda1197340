"""The port's compiled step paths against the JAX package's, on the CPU.

On a CUDA device Dia's decode step, Encodec's steady streaming pushes and
the LM step are CUDA graphs (``ops/graphs.py``) over static buffers. A CPU
has no graphs, but it runs the same programs uncaptured: with
``graphs_enabled`` forced on, a CPU model takes the graphed path's pooled
decode states, fixed block counts and copies in and out, and each "replay"
runs the captured function eagerly. Those paths must give the JAX
package's codes (Dia's ``_generate_jit``, with its Gumbel draws replayed),
the eager sessions' codes and audio, and the JAX LM's ``_jit_step`` pdfs,
within the tolerances of the existing tests; every state tensor a step
writes must keep its storage; and every change of the weights or the cache
mode must drop the captured programs.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralcodecs_tpu.models.encodec import Encodec as JEncodec
from neuralcodecs_tpu.models.encodec import streaming as jstreaming
from neuralcodecs_tpu_torch.diagnostics.profiler import trace
from neuralcodecs_tpu_torch.diagnostics.xplane import parse_trace, summarize_trace
from neuralcodecs_tpu_torch.models.dia import model as dia_model
from neuralcodecs_tpu_torch.models.dia import release_generation_caches
from neuralcodecs_tpu_torch.models.encodec import StreamingDecoder, StreamingEncoder, streaming
from neuralcodecs_tpu_torch.models.encodec import lm as lm_module
from neuralcodecs_tpu_torch.ops import graphs
from test_encodec import tiny_config as encodec_tiny_config
from test_torch_dia import TEXTS, JaxNoise, _np_params, _setup, build_pair
from test_torch_encodec import _golden_port
from test_torch_lm import PDF_TOL, _golden_inputs, _golden_lms
from test_torch_streaming import AUDIO_TOL, _audio, _pushes

SAMPLED = dict(temperature=1.2, top_p=0.95, top_k=50)


@pytest.fixture
def jax_noise(monkeypatch):
    stub = JaxNoise()
    monkeypatch.setattr(dia_model, "gumbel_noise", stub)
    return stub


@pytest.fixture
def graphed(monkeypatch):
    """The graphed paths' programs on the CPU: pooled states, static
    buffers, uncaptured replays."""
    for module in (dia_model, streaming, lm_module):
        monkeypatch.setattr(module, "graphs_enabled", lambda device: True)


# ------------------------------------------------------------------ Dia

# (setup, kw): the full read, the blocked read at 4 block counts (block 8
# over a 32-slot buffer), the int8 cache dequantised and read by integer dots
DIA_CASES = {
    "full-greedy": (None, dict(max_tokens=20, seed=1, temperature=0.0)),
    "full-sampled": (None, dict(max_tokens=20, seed=4, **SAMPLED)),
    "blocked-sampled": ("blocked", dict(max_tokens=30, seed=6, pad_tokens_to=32, **SAMPLED)),
    "int8-kv-blocked": ("int8-kv", dict(max_tokens=30, seed=2, pad_tokens_to=32, **SAMPLED)),
    "int8-kv-dot": ("ladder", dict(max_tokens=20, seed=3, **SAMPLED)),
}


def _dia_setup(jdia, dia, setup):
    if setup in ("blocked", "int8-kv"):
        for m in (jdia, dia):
            m.kv_read_block = 8
            if setup == "int8-kv":
                m.enable_int8_kv_cache()
    else:
        _setup(jdia, dia, setup)


@pytest.mark.parametrize("name", list(DIA_CASES))
def test_device_step_matches_jax(name, jax_noise, graphed):
    """The pooled device-step loop (fixed block counts, last block masked,
    step index and token limit on the device) gives JAX's codes, twice on
    one slot."""
    setup, kw = DIA_CASES[name]
    jdia, dia = build_pair()
    _dia_setup(jdia, dia, setup)
    want, want_len = jdia.generate_codes(TEXTS[:2], **kw)
    for _ in range(2):
        got, got_len = dia.generate_codes(TEXTS[:2], **kw)
        np.testing.assert_array_equal(got_len, np.asarray(want_len))
        np.testing.assert_array_equal(got, np.asarray(want))
    stats = dia.graph_stats()
    assert stats["slots"] == 1
    buffer = kw.get("pad_tokens_to") or dia_model._bucket(kw["max_tokens"],
                                                          dia.config.data.audio_length)
    block = dia._resolve_kv_block(buffer)
    assert stats["graphs"] == (buffer // block if block else 1)


def test_stream_on_pooled_state_matches_oneshot(jax_noise, graphed):
    """Segments of a pooled stream give the one-shot codes, and a stream
    closed half way gives its slot back."""
    jdia, dia = build_pair()
    kw = dict(max_tokens=24, seed=9, **SAMPLED)
    codes, lengths = dia.generate_codes([TEXTS[0]], **kw)
    blocks = [b for b, _ in dia.generate_codes_stream(TEXTS[0], segment_tokens=5, **kw)]
    np.testing.assert_array_equal(np.concatenate(blocks), codes[0][:lengths[0]])
    stream = dia.generate_codes_stream(TEXTS[0], segment_tokens=5, **kw)
    next(stream)
    stream.close()
    dia.generate_codes([TEXTS[0]], **kw)
    assert dia.graph_stats()["slots"] == 1


def test_decode_step_keeps_storage():
    """Every tensor of the loop state is written in place: caches,
    generated, countdown, the step index, the token limit, the noise."""
    jdia, dia = build_pair()
    dia.enable_int8_kv_cache()
    dia.kv_read_block = 8
    text = dia._pad_text([dia.encode_text(t) for t in TEXTS[:2]])
    delayed, steps = dia._prefill([None, None], 2)
    st = dia._start_state(text, delayed, steps, 0, np.ones(2, bool), max_tokens=32,
                          kv_int8=True)
    s = dia._sampling(32, 1.2, 50, 0.95, None)
    ptrs = [t.data_ptr() for t in dia_model._tensors(st)]
    gens = list(st.noise.generators)
    for _ in range(12):
        dia._advance(st, s)
    assert [t.data_ptr() for t in dia_model._tensors(st)] == ptrs
    assert st.noise.generators == gens and st.noise.draws == 12
    assert int(st.step_t) == st.step == int(steps.min()) - 1 + 12


def test_pooled_slot_refilled_in_place(graphed):
    """A second generation borrows the first one's slot and fills the same
    buffers; the first generation's codes come back unchanged."""
    dia = build_pair()[1]
    kw = dict(max_tokens=16, seed=2, temperature=0.0)
    first = dia.generate_codes(TEXTS[:2], **kw)
    pool = dia._state_pool()
    (slot,) = [st for free in pool.free.values() for st in free]
    ptrs = [t.data_ptr() for t in dia_model._tensors(slot)]
    again = dia.generate_codes(TEXTS[:2], **kw)
    assert [t.data_ptr() for t in dia_model._tensors(slot)] == ptrs
    np.testing.assert_array_equal(first[0], again[0])


@pytest.mark.parametrize("change", ["quantize_int8", "quantize_int4", "enable_int8_kv_cache",
                                    "load_state_dict", "to", "release_generation_caches"])
def test_weight_changes_drop_the_graphs(change, graphed):
    jdia, dia = build_pair()
    dia.generate_codes(TEXTS[:1], max_tokens=8, temperature=0.0)
    assert dia.graph_stats()["slots"] == 1
    if change == "load_state_dict":
        dia.load_state_dict(_np_params(jdia.params))
    elif change == "to":
        dia.to("cpu")
    elif change == "release_generation_caches":
        release_generation_caches()
    else:
        getattr(dia, change)()
    assert dia.graph_stats() == {"slots": 0, "state_gb": 0.0, "graphs": 0, "capture_s": 0.0}


# ------------------------------------------------------------ streaming


@pytest.fixture(scope="module")
def pair():
    """The JAX Encodec and the port with the golden's weights."""
    port, g = _golden_port()
    params = {k[3:]: jnp.asarray(g[k]) for k in g.files if k.startswith("sd/")}
    return JEncodec(encodec_tiny_config(), params=params), port


def _session_run(model, audio, pushes, hop, block_hops=None):
    enc = StreamingEncoder(model, block_hops=block_hops)
    dec = StreamingDecoder(model, block_hops=block_hops)
    codes, out, flats = [], [], set()
    for a, b in pushes:
        c = enc.push(audio[..., a * hop: b * hop])
        codes.append(c.numpy())
        out.append(dec.push(c).numpy())
        if enc._flat is not None:
            flats.add((enc._flat.data_ptr(), dec._flat.data_ptr()))
    return np.concatenate(codes, -1), np.concatenate(out, 1), flats


@pytest.mark.parametrize("first, chunk, blocks", [(1, 1, None), (8, 3, None), (8, 5, (2, 1))])
def test_static_pushes_match_eager_and_jax(pair, monkeypatch, first, chunk, blocks):
    """Steady pushes through the static programs (state copied in and out
    of one flat buffer) give the eager session's codes and audio bit for
    bit, and the JAX session's."""
    jmodel, port = pair
    hop = port.encoder.hop_length
    audio = _audio(24 * hop, seed=3, batch=2)
    pushes = _pushes(first, chunk, 24)
    codes, out, _ = _session_run(port, audio, pushes, hop, blocks)
    monkeypatch.setattr(streaming, "graphs_enabled", lambda device: True)
    port.release_graphs()
    g_codes, g_out, flats = _session_run(port, audio, pushes, hop, blocks)
    np.testing.assert_array_equal(g_codes, codes)
    np.testing.assert_array_equal(g_out, out)
    assert len(flats) == 1  # the sessions' flat states keep their storage
    jenc = jstreaming.StreamingEncoder(jmodel, n_q=codes.shape[1])
    want = np.concatenate([np.asarray(jenc.push(audio[..., a * hop: b * hop]))
                           for a, b in pushes], -1)
    assert np.mean(g_codes == want) >= 0.99
    jdec = jstreaming.StreamingDecoder(jmodel)
    j_out = np.concatenate([np.asarray(jdec.push(g_codes[..., a:b])) for a, b in pushes], 1)
    np.testing.assert_allclose(g_out, j_out, **AUDIO_TOL)


def test_static_push_buffers_and_sharing(pair, monkeypatch):
    """Two sessions of one shape share one program per side, whose static
    buffers keep their storage; ``warm`` builds them and leaves a live
    session alone; ``.to()`` drops them."""
    _, port = pair
    monkeypatch.setattr(streaming, "graphs_enabled", lambda device: True)
    port.release_graphs()
    hop = port.encoder.hop_length
    audio = _audio(12 * hop, seed=5)
    enc = StreamingEncoder(port, block_hops=(2, 1))
    enc.warm()
    assert enc._state is None
    programs = dict(streaming._graphs(port).graphs)
    assert len(programs) == 2
    ptrs = {k: [a.data_ptr() for a in p.args] for k, p in programs.items()}
    a, b = StreamingEncoder(port), StreamingEncoder(port)
    for s in (a, b):
        s.push(audio[:4 * hop])
        for off in range(4, 12, 2):
            s.push(audio[off * hop:(off + 2) * hop])
    assert streaming._graphs(port).graphs.keys() == programs.keys()
    assert {k: [x.data_ptr() for x in p.args] for k, p in programs.items()} == ptrs
    assert sum(p.graph.replays for p in programs.values()) == 2 + 8
    port.to("cpu")
    assert port.__dict__["_graph_cache"] is None


# ------------------------------------------------------------------ LM


def test_static_lm_step_matches_jax(graphed):
    """The device-offset step through the static program gives the JAX LM's
    ``_jit_step`` pdfs and buffers; the caller's state keeps its storage."""
    jlm, lm = _golden_lms()
    inputs = _golden_inputs()
    jstate, state = jlm.init_state(1), lm.init_state(1)
    ptrs = (state.buffers.data_ptr(), state.offset.data_ptr())
    for t in range(inputs.shape[-1]):
        want, jstate = jlm.step(inputs[..., t:t + 1], jstate)
        got, state = lm.step(torch.from_numpy(inputs[..., t:t + 1]), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PDF_TOL,
                                   err_msg=f"step {t}")
    assert (state.buffers.data_ptr(), state.offset.data_ptr()) == ptrs
    assert int(state.offset) == int(jstate.offset) == inputs.shape[-1]
    np.testing.assert_allclose(state.buffers.numpy(), np.asarray(jstate.buffers),
                               rtol=1e-4, atol=1e-5)
    (program,) = lm._graphs().graphs.values()
    assert program.graph.replays == inputs.shape[-1]


def test_static_lm_step_equals_eager_step(graphed, monkeypatch):
    """Static and eager steps of a batch-2 LM agree bit for bit (the .ecdc
    coder's condition), and a weight load drops the program."""
    _, lm = _golden_lms()
    rng = np.random.default_rng(4)
    inputs = torch.as_tensor(rng.integers(0, 33, size=(20, 2, 4, 1)))
    runs = {}
    for mode in (True, False):
        monkeypatch.setattr(lm_module, "graphs_enabled", lambda device, m=mode: m)
        state = lm.init_state(2)
        runs[mode] = torch.stack([lm.step(inputs[t], state)[0] for t in range(20)])
    assert torch.equal(runs[True], runs[False])
    lm.load_state_dict(lm.state_dict())
    assert lm.__dict__["_graph_cache"] is None


# ------------------------------------------------------------------ switches


def test_graphs_disabled_nests():
    assert not graphs.graphs_enabled("cpu")
    with graphs.graphs_disabled():
        with graphs.graphs_disabled():
            assert not graphs.graphs_enabled("cuda")
        assert not graphs.graphs_enabled("cuda")
    assert graphs.graphs_enabled("cuda")


def test_flatten_round_trip():
    t = [torch.zeros(2, 3), torch.ones(1)]
    tree = [t[0], None, [(t[1], t[0]), None]]
    leaves, spec = graphs.flatten(tree)
    assert len(leaves) == 3
    flat = torch.cat([x.reshape(-1) for x in leaves])
    back = graphs.unflatten(graphs.carve(flat, [x.shape for x in leaves]), spec)
    assert back[1] is None and isinstance(back[2][0], tuple)
    assert torch.equal(back[2][0][0], t[1]) and torch.equal(back[0], t[0])


# ------------------------------------------------------------------ xplane


def test_parse_trace_sums_device_events(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 0, "dur": 1.5},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 2.25},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 9, "dur": 0.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 10, "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0, "dur": 7.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert parse_trace(tmp_path / "a" / "1.pt.trace.json") == {
        "gemm": 3750, "Memset (Device)": 500, "Memcpy HtoD": 4000}
    assert summarize_trace(tmp_path) == [("Memcpy HtoD", 4.0e-3), ("gemm", 3.75e-3),
                                         ("Memset (Device)", 5.0e-4)]
    assert parse_trace(tmp_path / "a" / "1.pt.trace.json", ("CPU_OP",)) == {"aten::mm": 30000}
    with pytest.raises(FileNotFoundError):
        summarize_trace(tmp_path / "empty")


def test_summarize_a_cpu_profile(tmp_path):
    """A CPU trace of ``profiler.trace`` has no device events; its CPU ops
    are read by category, and the newest trace is the one summarised."""
    x = torch.randn(64, 64)
    with trace(tmp_path):
        torch.mm(x, x)
    with trace(tmp_path) as prof:
        for _ in range(3):
            torch.mm(x, x)
    assert summarize_trace(tmp_path) == []
    ops = dict(summarize_trace(tmp_path, ("cpu_op",)))
    assert ops["aten::mm"] > 0
    counted = {e.key: e.count for e in prof.key_averages()}
    assert counted["aten::mm"] == 3
    assert parse_trace(prof.trace_path, ("cpu_op",)).keys() == ops.keys()
