"""The arithmetic of the DSP recurrence kernels, emulated on the CPU.

The biquad-cascade kernel (csrc/biquad.cu) is a chunked scan: (1) chunk end
states from zero state in f64, (2) the carry s_{k+1} = Phi s_k + e_k in f64,
(3) each chunk re-run from its start state rounded to f32 with the plain
loop's f32 step. ``ops/kernels/biquad.py`` holds those three phases in
PyTorch (``chunk_end_states``, ``carry_states``, ``run_chunks``); here they
are held:
- bit for bit against the plain loop, given the loop's own states at the
  chunk starts (phase 3 is the loop's arithmetic), and wherever T fits one
  chunk;
- against the exact filter (scipy's lfilter in f64 with the f32
  coefficients): the emulation's max error at most 1.5 x the plain f32
  loop's, the gate chip_smoke.py puts on the kernel;
- Phi against the f64 recurrence stepped from the unit states;
- BS.1770 loudness through the emulation within 1e-4 LU of the plain loops.
A small chunk length keeps the CPU run short and puts many chunks in a row.

The envelope kernel (csrc/envelope.cu) computes both candidate levels and
selects last; emulated per op, that step equals the plain loop bit for bit,
ties |x| == level, zeros and subnormal levels included.
"""

import math

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from neuralcodecs_tpu_torch.dsp import filters, loudness
from neuralcodecs_tpu_torch.ops.kernels import biquad as bq
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow_plain

CHUNK = 16
K_WEIGHTING = [(loudness._HIGH_SHELF_B, loudness._HIGH_SHELF_A),
               (loudness._HIGH_PASS_B, loudness._HIGH_PASS_A)]


def _random_biquad():
    """tests/test_torch_dsp.py's random stable biquad (poles at radius 0.95)."""
    rng = np.random.default_rng(7)
    theta = rng.uniform(0.1, 3.0)
    return (0.5 * rng.standard_normal(3), np.array([1.0, -1.9 * math.cos(theta), 0.95 ** 2]))


FILTERS = {"k-weighting": K_WEIGHTING, "random": [_random_biquad()]}
SHAPES = [(n, t) for t in (1, CHUNK - 1, CHUNK, CHUNK + 1, 5000) for n in (1, 3, 7)]


def _x(n, t, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed + 1000 * n + t)
    return torch.from_numpy((0.25 * rng.standard_normal((n, t))).astype(np.float32))


def _plain_starts(x: torch.Tensor, sections, chunk: int) -> torch.Tensor:
    """[N, C, 2S] f32: the plain loop's own (z1, z2) of each section before
    sample k chunk, for every chunk k, from a copy of its arithmetic."""
    n, t = x.shape
    c = -(-t // chunk)
    states = torch.zeros(n, c, 2 * len(sections))
    u = x.t().contiguous()
    for i, (b, a) in enumerate(sections):
        b0, b1, b2, a1, a2 = (torch.tensor(np.float32(v)) for v in bq._coefs(b, a))
        z1, z2 = u.new_zeros(n), u.new_zeros(n)
        ys = torch.empty_like(u)
        for j in range(t):
            if j % chunk == 0:
                states[:, j // chunk, 2 * i], states[:, j // chunk, 2 * i + 1] = z1, z2
            y = b0 * u[j] + z1
            z1_new = b1 * u[j] - a1 * y + z2
            z2 = b2 * u[j] - a2 * y
            z1 = z1_new
            ys[j] = y
        u = ys
    return states


def _f64(x: torch.Tensor, sections) -> np.ndarray:
    y = x.numpy().astype(np.float64)
    for b0, b1, b2, a1, a2 in bq.section_coefs(sections):
        y = lfilter([b0, b1, b2], [1.0, a1, a2], y, axis=-1)
    return y


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_chunk_outputs_from_plain_states_equal_plain_loop(name, n, t):
    sections = FILTERS[name]
    x = _x(n, t)
    want = bq.biquad_cascade_plain(x, sections)
    got = bq.run_chunks(x, sections, _plain_starts(x, sections, CHUNK), CHUNK)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_chunked_scan_as_accurate_as_plain_loop(name, n, t):
    sections = FILTERS[name]
    x = _x(n, t, seed=1)
    plain = bq.biquad_cascade_plain(x, sections)
    got = bq.biquad_cascade_chunked(x, sections, CHUNK)
    if t <= CHUNK:  # one chunk from zero state: the loop itself
        assert torch.equal(got, plain)
        return
    exact = _f64(x, sections)
    err_plain = np.abs(plain.numpy() - exact).max()
    err_chunked = np.abs(got.numpy() - exact).max()
    assert err_chunked <= 1.5 * err_plain, (err_chunked, err_plain)


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("chunk", [1, CHUNK, 1024])
def test_phi_is_the_recurrence_over_a_chunk(name, chunk):
    """Column j of Phi is the state after ``chunk`` zero-input steps of the
    f64 recurrence from unit state j. Squaring and stepping round in other
    places; the high pass's double pole near z = 1 amplifies that to ~3e-10
    of its largest entries over 1024 steps, hence rtol 1e-8."""
    sections = FILTERS[name]
    coefs = bq.section_coefs(sections)
    d = 2 * len(coefs)
    want = np.zeros((d, d))
    for j in range(d):
        z = np.eye(d)[j].copy()
        for _ in range(chunk):
            u = 0.0
            for i, (b0, b1, b2, a1, a2) in enumerate(coefs):
                z1, z2 = z[2 * i], z[2 * i + 1]
                y = b0 * u + z1
                z[2 * i], z[2 * i + 1] = b1 * u - a1 * y + z2, b2 * u - a2 * y
                u = y
        want[:, j] = z
    np.testing.assert_allclose(bq.cascade_phi(sections, chunk), want, rtol=1e-8, atol=1e-15)
    if chunk == 1:
        np.testing.assert_array_equal(bq.cascade_step_matrix(sections), want)


def test_carry_states_are_the_exact_chunk_start_states():
    """Phases 1-2 give the f64 filter's own state at each chunk start (to
    f32 rounding): the state before sample k chunk is that of running the
    filter in f64 over the samples before it."""
    sections = K_WEIGHTING
    x = _x(3, 10 * CHUNK + 5, seed=2)
    starts = bq.carry_states(bq.chunk_end_states(x, sections, CHUNK),
                             bq.cascade_phi(sections, CHUNK))
    coefs = bq.section_coefs(sections)
    for k in range(starts.shape[1]):
        u = x[:, :k * CHUNK].numpy().astype(np.float64)
        want = []
        for b0, b1, b2, a1, a2 in coefs:
            zf = np.zeros((u.shape[0], 2))
            if u.shape[1]:
                y, zf = lfilter([b0, b1, b2], [1.0, a1, a2], u, axis=-1, zi=zf)
                u = y
            want.append(zf)
        want = np.concatenate(want, axis=-1)
        np.testing.assert_allclose(starts[:, k].numpy(), want, rtol=1e-6, atol=1e-7)


def test_loudness_through_the_chunked_scan(monkeypatch):
    """integrated_loudness with the K-weighting run by the chunked scan is
    within 1e-4 LU of the plain loops'."""
    rng = np.random.default_rng(3)
    audio = torch.from_numpy((0.25 * rng.standard_normal((2, 1, 12_000))).astype(np.float32))
    audio[1] *= 0.1
    want = loudness.integrated_loudness(audio, 24_000)
    monkeypatch.setattr(filters, "biquad_df2t",
                        lambda x, sections: bq.biquad_cascade_chunked(x, sections, 256))
    got = loudness.integrated_loudness(audio, 24_000)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4


def test_k_weighting_is_one_wrapper_call(monkeypatch):
    calls = []

    def spy(x, sections):
        calls.append(len(sections))
        return bq.biquad_cascade_plain(x, sections)

    monkeypatch.setattr(filters, "biquad_df2t", spy)
    loudness.integrated_loudness(torch.zeros(1, 1, 12_000), 24_000)
    assert calls == [2]


def test_cascade_takes_one_or_two_sections():
    x = _x(2, 40)
    with pytest.raises(ValueError):
        bq.biquad_df2t(x, [])
    with pytest.raises(ValueError):
        bq.biquad_df2t(x, K_WEIGHTING + K_WEIGHTING[:1])
    want = bq.biquad_df2t_plain(bq.biquad_df2t_plain(x, *K_WEIGHTING[0]), *K_WEIGHTING[1])
    assert torch.equal(bq.biquad_df2t(x, K_WEIGHTING), want)


# ------------------------------------------------------------ kernel 4


def _envelope_speculative(x: torch.Tensor, attack: float, release: float) -> torch.Tensor:
    """The kernel's step, one rounded op at a time: d = a - level, both
    candidates level + gain d, the one for a > level kept."""
    xt = x.abs().t().contiguous()
    att = torch.tensor(np.float32(attack))
    rel = torch.tensor(np.float32(release))
    level = xt.new_zeros(xt.shape[1])
    env = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        a = xt[t]
        d = a - level
        up = level + att * d
        down = level + rel * d
        level = torch.where(a > level, up, down)
        env[t] = level
    return env.t().contiguous()


def _envelope_cases() -> list:
    rng = np.random.default_rng(4)
    noise = (0.25 * rng.standard_normal((3, 3000))).astype(np.float32)
    # a burst, then silence long enough for the level to decay through the
    # subnormals to zero, then a burst again
    burst = np.zeros((2, 600), np.float32)
    burst[:, :40] = rng.standard_normal((2, 40))
    burst[:, 400:420] = -rng.standard_normal((2, 20))
    return [("noise, compressor gains", noise, 1 - math.exp(-1 / 120), 1 - math.exp(-1 / 1200)),
            ("bursts into subnormal levels", burst, 0.9, 0.5),
            ("equal gains", noise[:1, :500], 0.3, 0.3)]


@pytest.mark.parametrize("case", range(3))
def test_envelope_speculative_step_equals_plain_loop(case):
    label, x, attack, release = _envelope_cases()[case]
    x = torch.from_numpy(x)
    want = envelope_follow_plain(x, attack, release)
    assert torch.equal(_envelope_speculative(x, attack, release), want), label
    if case == 1:
        lv = want[want != 0].abs()
        assert bool((lv < torch.finfo(torch.float32).tiny).any())  # subnormal levels were hit


def test_envelope_speculative_step_on_ties():
    """|x| equal to the level it meets (so a > level is false and the
    release gain applies), and zeros: the input is built step by step from
    the plain loop's own level."""
    attack, release = 0.25, 0.125
    rng = np.random.default_rng(5)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 400))).astype(np.float32))
    att, rel = torch.tensor(np.float32(attack)), torch.tensor(np.float32(release))
    level = torch.zeros(2)
    for t in range(x.shape[1]):
        if t % 3 == 1:
            x[:, t] = level * torch.tensor([1.0, -1.0])
        elif t % 7 == 2:
            x[:, t] = 0.0
        a = x[:, t].abs()
        level = level + torch.where(a > level, att, rel) * (a - level)
    want = envelope_follow_plain(x, attack, release)
    prev = torch.cat([torch.zeros(2, 1), want[:, :-1]], 1)
    assert int((x.abs() == prev).sum()) >= 2 * (400 // 3)
    assert torch.equal(_envelope_speculative(x, attack, release), want)
