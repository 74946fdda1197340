"""The PyTorch port's DSP library against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``neuralcodecs_tpu_torch.dsp``. On the CPU the envelope
and biquad wrappers run their plain loops, which are held against the JAX
scans and the interpreted Pallas kernels; the CUDA kernels themselves are
held bit-exact against those plain loops on the GPU by ``chip_smoke.py``.

Tolerances:
- the numpy constants (windows, filterbanks, filter prototypes, BS.1770
  coefficients, PCM conversions) are bit-equal copies;
- the envelope follower within 1e-7 of the JAX scan (XLA on the CPU
  contracts the step's multiply-add into an FMA, eager torch rounds each
  op: measured 3e-8 at T = 48 000); the biquad within rtol 1e-5 / atol 1e-5
  (measured 1.3e-6 at T = 48 000);
- audio-valued outputs rtol 1e-4 / atol 1e-5, as in the codec tests;
  spectra and mel / MFCC values relative to their largest magnitude, at
  1e-5 (the two FFTs sum in different orders);
- loudness within 1e-3 LU.
"""

import dataclasses
import math
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralcodecs_tpu.dsp import audio_utils as jau
from neuralcodecs_tpu.dsp import effects as jeffects
from neuralcodecs_tpu.dsp import filters as jfilters
from neuralcodecs_tpu.dsp import loudness as jloudness
from neuralcodecs_tpu.dsp import mel as jmel
from neuralcodecs_tpu.dsp import resample as jresample
from neuralcodecs_tpu.dsp import stft as jstft
from neuralcodecs_tpu.dsp.signal import AudioSignal as JAudioSignal
from neuralcodecs_tpu_torch.dsp import AudioSignal
from neuralcodecs_tpu_torch.dsp import audio_utils as au
from neuralcodecs_tpu_torch.dsp import effects, filters, loudness, mel, resample, stft
from neuralcodecs_tpu_torch.ops.kernels.biquad import biquad_df2t_plain
from neuralcodecs_tpu_torch.ops.kernels.envelope import envelope_follow_plain

AUDIO_TOL = dict(rtol=1e-4, atol=1e-5)
WINDOWS = ["hann", "hamming", "blackman", "bartlett", "sqrt_hann", "average", "ones"]


def _noise(rng, *shape, scale=0.25) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_rel(got, want, rel=1e-5):
    """Within rel of the largest magnitude of want (spectra, mel, MFCC)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _stable_biquad(rng) -> tuple[np.ndarray, np.ndarray]:
    theta = rng.uniform(0.1, 3.0)
    return 0.5 * rng.standard_normal(3), np.array([1.0, -1.9 * math.cos(theta), 0.95 ** 2])


BIQUADS = {
    "k-shelf": (jloudness._HIGH_SHELF_B, jloudness._HIGH_SHELF_A),
    "k-highpass": (jloudness._HIGH_PASS_B, jloudness._HIGH_PASS_A),
    "random": _stable_biquad(np.random.default_rng(7)),
}


# ------------------------------------------------------------ kernel 4


def test_envelope_plain_matches_jax_follower(rng):
    x = _noise(rng, 2, 3, 4000)
    a, r = 1 - math.exp(-1 / 120), 1 - math.exp(-1 / 1200)
    want = np.asarray(jfilters.one_pole_follower(jnp.asarray(x), a, r))
    got = envelope_follow_plain(_t(x).reshape(6, -1), a, r).reshape(x.shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_envelope_plain_matches_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.envelope import TIME_BLOCK, envelope_pallas

    t, n = 2 * TIME_BLOCK, 8
    x = _noise(rng, n, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(envelope_pallas(jnp.asarray(np.abs(x).T), attack_gain=0.13,
                                          release_gain=0.003)).T
    got = envelope_follow_plain(_t(x), 0.13, 0.003).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


# ------------------------------------------------------------ kernel 5


@pytest.mark.parametrize("name", list(BIQUADS))
def test_biquad_plain_matches_jax_biquad(rng, name):
    b, a = BIQUADS[name]
    x = _noise(rng, 2, 2, 4000)
    want = np.asarray(jfilters.biquad(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a)))
    got = filters.biquad(_t(x), b, a).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(BIQUADS))
def test_biquad_plain_matches_pallas_interpret(rng, name):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.biquad import TIME_BLOCK, biquad_pallas

    b, a = BIQUADS[name]
    t, n = 2 * TIME_BLOCK, 8
    x = _noise(rng, n, t)
    coefs = jnp.concatenate([jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(biquad_pallas(jnp.asarray(x.T), coefs)).T
    got = biquad_df2t_plain(_t(x), b, a).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- numpy copies, bit-equal


@pytest.mark.parametrize("window", WINDOWS)
def test_window_copy_is_bit_equal(window):
    for n in (64, 2048):
        np.testing.assert_array_equal(stft.get_window(window, n), jstft.get_window(window, n))


def test_numpy_constants_are_bit_equal():
    f = np.linspace(0, 12000, 17)
    np.testing.assert_array_equal(mel.hz_to_mel(f), jmel.hz_to_mel(f))
    np.testing.assert_array_equal(mel.mel_to_hz(f), jmel.mel_to_hz(f))
    for args in ((24000, 80, 2048), (16000, 40, 512, 50.0, 7000.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(mel.dct_matrix(40, 80), jmel.dct_matrix(40, 80))
    for order, cut, hp in ((51, 0.1, True), (50, 0.2, False)):
        np.testing.assert_array_equal(effects._windowed_sinc(order, cut, hp),
                                      jeffects._windowed_sinc(order, cut, hp))
    np.testing.assert_array_equal(resample._kaiser_sinc_filter(24, 80, 0.5),
                                  jresample._kaiser_sinc_filter(24, 80, 0.5))
    for name in ("_HIGH_SHELF_B", "_HIGH_SHELF_A", "_HIGH_PASS_B", "_HIGH_PASS_A", "GAIN_FACTOR"):
        assert getattr(loudness, name) == getattr(jloudness, name)
    np.testing.assert_array_equal(loudness._K_WEIGHTS, jloudness._K_WEIGHTS)
    assert effects._COMB_DELAYS == jeffects._COMB_DELAYS
    assert effects._ALLPASS_DELAYS == jeffects._ALLPASS_DELAYS
    assert stft.STFTParams().__dict__ == jstft.STFTParams().__dict__
    for args in ((1000, 256, 64, True), (1000, 256, 64, False), (777, 2048, 512, True)):
        assert stft.compute_stft_padding(*args) == jstft.compute_stft_padding(*args)


def test_pcm_converters_are_bit_equal(rng):
    x = _noise(rng, 500, scale=0.7)
    x[:3] = (-1.5, 1.5, 0.0)
    assert au.float_to_pcm16(x) == jau.float_to_pcm16(x)
    raw16 = jau.float_to_pcm16(x)
    np.testing.assert_array_equal(au.pcm16_to_float(raw16), jau.pcm16_to_float(raw16))
    ints = rng.integers(-(1 << 23), 1 << 23, 300).astype("<i4")
    raw24 = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    np.testing.assert_array_equal(au.pcm24_to_float(raw24), jau.pcm24_to_float(raw24))
    raw32 = rng.integers(-(1 << 31), (1 << 31) - 1, 300).astype("<i4").tobytes()
    np.testing.assert_array_equal(au.pcm32_to_float(raw32), jau.pcm32_to_float(raw32))
    stereo = _noise(rng, 2, 100)
    np.testing.assert_array_equal(au.interleave(stereo), jau.interleave(stereo))
    inter = au.interleave(stereo)
    np.testing.assert_array_equal(au.deinterleave(inter, 2), jau.deinterleave(inter, 2))
    np.testing.assert_array_equal(au.to_mono(stereo), jau.to_mono(stereo))
    db = np.array([-60.0, -6.0, 0.0, 3.0])
    np.testing.assert_array_equal(au.db_to_linear(db), jau.db_to_linear(db))
    lin = np.array([0.0, 1e-3, 0.5, 2.0])
    np.testing.assert_array_equal(au.linear_to_db(lin), jau.linear_to_db(lin))


@pytest.mark.parametrize("which", ["time", "frequency"])
def test_masks_zero_one_stripe(rng, which):
    spec = torch.from_numpy(np.abs(_noise(rng, 2, 40, 100, scale=1.0)) + 0.1)
    fn = au.mask_time if which == "time" else au.mask_frequency
    out = fn(spec, torch.Generator().manual_seed(0), max_width=10)
    again = fn(spec, torch.Generator().manual_seed(0), max_width=10)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    # the zeroed stripe: whole columns (time) or whole rows (frequency)
    zeroed = (out == 0).all(dim=0).all(dim=-2 if which == "time" else -1)
    width = int(zeroed.sum())
    assert 1 <= width < 10 and out.shape == spec.shape
    idx = torch.nonzero(zeroed).flatten()
    assert int(idx[-1] - idx[0]) + 1 == width  # one contiguous stripe
    mask = zeroed if which == "time" else zeroed[:, None]
    torch.testing.assert_close(torch.where(mask, spec, out), spec, rtol=0, atol=0)


# ------------------------------------------------------------ STFT / ISTFT


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_stft_istft_match_jax(rng, window, center):
    x = _noise(rng, 2, 1500)
    kw = dict(n_fft=256, hop_length=64, window_type=window, center=center)
    want = np.array(jstft.stft(jnp.asarray(x), **kw))  # writable, for torch.from_numpy
    got = stft.stft(_t(x), **kw)
    _assert_rel(got, want)
    length = 1400 if center else None
    want_inv = np.asarray(jstft.istft(jnp.asarray(want), length=length, **kw))
    got_inv = stft.istft(torch.from_numpy(want), length=length, **kw).numpy()
    assert got_inv.shape == want_inv.shape
    # uncentred, the first and last samples are divided by a window-square
    # sum near 0, which magnifies the two FFTs' rounding differences: those
    # samples are compared where the sum reaches 1e-3 of its largest value
    w2 = stft.get_window(window, 256).astype(np.float64) ** 2
    norm = np.zeros(256 + 64 * (want.shape[-1] - 1))
    for i in range(want.shape[-1]):
        norm[64 * i: 64 * i + 256] += w2
    keep = (norm >= 1e-3 * norm.max())[128 if center else 0:][: got_inv.shape[-1]]
    np.testing.assert_allclose(got_inv[..., keep], want_inv[..., keep], **AUDIO_TOL)


# ------------------------------------------------------------ mel / MFCC


@pytest.mark.parametrize("power,n_mels,f_max", [(1.0, 80, None), (2.0, 40, 6000.0)])
def test_mel_spectrogram_matches_jax(rng, power, n_mels, f_max):
    x = _noise(rng, 2, 1, 6000)
    kw = dict(n_mels=n_mels, n_fft=512, hop_length=128, power=power, f_max=f_max)
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), 16000, **kw))
    _assert_rel(mel.mel_spectrogram(_t(x), 16000, **kw), want)


def test_mfcc_matches_jax(rng):
    x = _noise(rng, 2, 6000)
    kw = dict(n_mfcc=20, n_mels=40, n_fft=512, hop_length=128)
    want = np.asarray(jmel.mfcc(jnp.asarray(x), 16000, **kw))
    _assert_rel(mel.mfcc(_t(x), 16000, **kw), want)


# ------------------------------------------------------------ loudness


@pytest.mark.parametrize("shape,sr", [((2, 1, 24000), 24000), ((1, 2, 16000), 48000),
                                      ((5, 8000), 16000), ((3000,), 16000)])
def test_integrated_loudness_matches_jax(rng, shape, sr):
    x = _noise(rng, *shape)
    if len(shape) == 3:
        x[0] *= 0.05  # one quieter item
    want = np.asarray(jloudness.integrated_loudness(jnp.asarray(x), sr))
    got = loudness.integrated_loudness(_t(x), sr).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    want_n = np.asarray(jloudness.normalize_loudness(jnp.asarray(x), sr, -20.0))
    np.testing.assert_allclose(loudness.normalize_loudness(_t(x), sr, -20.0).numpy(), want_n,
                               **AUDIO_TOL)


def test_k_weighting_matches_jax(rng):
    x = _noise(rng, 2, 1, 3000)
    want = np.asarray(jloudness.k_weighting(jnp.asarray(x)))
    # the high pass (poles at radius 0.995) magnifies the shelf stage's
    # ulp-level differences: JAX and the port are each ~7e-5 of the peak
    # from a float64 evaluation of the chain, so they are held to 2e-4
    _assert_rel(loudness.k_weighting(_t(x)), want, rel=2e-4)


# ------------------------------------------------------------ filters


def test_fir_filter_matches_jax(rng):
    x = _noise(rng, 2, 3, 500)
    h = _noise(rng, 9, scale=1.0)
    for padding in (None, 2):
        want = np.asarray(jfilters.fir_filter(jnp.asarray(x), jnp.asarray(h), padding))
        got = filters.fir_filter(_t(x), h, padding).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **AUDIO_TOL)


@pytest.mark.parametrize("name", ["comb", "allpass", "variable_delay"])
def test_recursive_filters_match_jax(rng, name):
    x = _noise(rng, 2, 1200)
    if name == "comb":
        args = (37, 0.7, 0.3)
        want = jfilters.comb_filter(jnp.asarray(x), *args)
        got = filters.comb_filter(_t(x), *args)
    elif name == "allpass":
        want = jfilters.allpass_filter(jnp.asarray(x), 23, 0.5)
        got = filters.allpass_filter(_t(x), 23, 0.5)
    else:
        delays = (10 * (1 + np.sin(np.arange(1200) / 50.0))).astype(np.float32)
        want = jfilters.variable_delay_line(jnp.asarray(x), jnp.asarray(delays), 20, 0.6)
        got = filters.variable_delay_line(_t(x), _t(delays), 20, 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AUDIO_TOL)


# ------------------------------------------------------------ effects

SR = 8000
EFFECTS = {
    "compressor": (lambda m, x: m.apply_compressor(x, SR, threshold=-20.0, ratio=4.0,
                                                   makeup_gain=2.0)),
    "delay": lambda m, x: m.apply_delay(x, SR, delay_time=0.03),
    "distortion": lambda m, x: m.apply_distortion(x, amount=0.4, wet_level=0.8),
    "flanger": lambda m, x: m.apply_flanger(x, SR, rate=2.0),
    "highpass": lambda m, x: m.apply_highpass(x, SR, cutoff_freq=1500.0),
    "lowpass": lambda m, x: m.apply_lowpass(x, SR, cutoff_freq=1500.0, filter_order=30),
    "reverb": lambda m, x: m.apply_reverb(x, room_size=0.7),
    "tremolo": lambda m, x: m.apply_tremolo(x, SR, rate=7.0),
    "chorus": lambda m, x: m.apply_chorus(x, SR, rate=2.0),
    "phaser": lambda m, x: m.apply_phaser(x, SR, rate=1.5),
    "pitch_shift": lambda m, x: m.apply_pitch_shift(x, SR, semitones=3.0),
}


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_matches_jax(rng, name):
    x = _noise(rng, 2, 1, 2400, scale=0.5)
    fn = EFFECTS[name]
    want = np.asarray(fn(jeffects, jnp.asarray(x)))
    got = fn(effects, _t(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **AUDIO_TOL)


def test_effects_keep_input_rank(rng):
    for shape in ((600,), (2, 600)):
        x = _noise(rng, *shape)
        assert tuple(effects.apply_compressor(_t(x), SR).shape) == shape
        assert tuple(effects.apply_tremolo(_t(x), SR).shape) == shape
    assert tuple(effects.apply_pitch_shift(_t(x), SR, 0.0).shape) == (2, 600)


# ------------------------------------------------------------ devices

FREE_FUNCTIONS = {
    "integrated_loudness": lambda x: loudness.integrated_loudness(x, 16000),
    "normalize_loudness": lambda x: loudness.normalize_loudness(x, 16000),
    "linear_resample": lambda x: resample.linear_resample(x, 16000, 24000),
    "resample_poly": lambda x: resample.resample_poly(x, 16000, 24000),
    "stft": lambda x: stft.stft(x, n_fft=256, hop_length=64),
    "apply_compressor": lambda x: effects.apply_compressor(x, 16000),
    "apply_pitch_shift": lambda x: effects.apply_pitch_shift(x, 16000, 0.0),
}


@pytest.mark.parametrize("name", list(FREE_FUNCTIONS))
def test_numpy_input_goes_to_the_card(monkeypatch, rng, name):
    """An array is put on "cuda", as jnp.asarray puts it on the accelerator:
    without a card that raises instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FREE_FUNCTIONS[name](_noise(rng, 2, 1, 4000))


@pytest.mark.parametrize("name", list(FREE_FUNCTIONS))
def test_cpu_tensor_stays_on_the_cpu(monkeypatch, rng, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = FREE_FUNCTIONS[name](_t(_noise(rng, 2, 1, 4000)))
    assert out.device == torch.device("cpu")


# ------------------------------------------------------------ AudioSignal


def test_audio_signal_dsp_methods_match_jax(rng):
    x = _noise(rng, 2, 2, 9000)
    sr = 16000
    j, p = JAudioSignal(x, sr), AudioSignal(x, sr, device="cpu")
    _assert_rel(p.stft(window_length=512, hop_length=128),
                j.stft(window_length=512, hop_length=128))
    spec = np.array(j.stft())
    np.testing.assert_allclose(p.istft(torch.from_numpy(spec)).audio_data.numpy(),
                               np.asarray(j.istft(jnp.asarray(spec)).audio_data), **AUDIO_TOL)
    _assert_rel(p.mel_spectrogram(n_mels=40, window_length=512, hop_length=128),
                j.mel_spectrogram(n_mels=40, window_length=512, hop_length=128))
    _assert_rel(p.mfcc(n_mfcc=13, n_mels=40), j.mfcc(n_mfcc=13, n_mels=40))
    np.testing.assert_allclose(p.loudness().numpy(), np.asarray(j.loudness()), rtol=0, atol=1e-3)
    np.testing.assert_allclose(p.normalize(-18.0).audio_data.numpy(),
                               np.asarray(j.normalize(-18.0).audio_data), **AUDIO_TOL)
    for rate in (24000, 44100, 16000):
        got, want = p.resample(rate), j.resample(rate)
        assert got.sample_rate == want.sample_rate == rate
        np.testing.assert_allclose(got.audio_data.numpy(), np.asarray(want.audio_data),
                                   **AUDIO_TOL)
    for name, args in (("to_mono", ()), ("peak_normalize", (0.8,)), ("preemphasis", (0.9,)),
                       ("excerpt", (0.1, 0.2))):
        np.testing.assert_allclose(getattr(p, name)(*args).audio_data.numpy(),
                                   np.asarray(getattr(j, name)(*args).audio_data), **AUDIO_TOL)


def test_audio_signal_containers_match_jax(rng):
    sr = 8000
    a, b = _noise(rng, 1, 4000), _noise(rng, 1, 2400)
    pa, pb = AudioSignal(a, sr, device="cpu"), AudioSignal(b, sr, device="cpu")
    ja, jb = JAudioSignal(a, sr), JAudioSignal(b, sr)
    assert (pa.batch_size, pa.num_channels, pa.signal_length) == (1, 1, 4000)
    assert dataclasses.astuple(pa.info) == dataclasses.astuple(ja.info)
    assert len(pa) == len(ja) and repr(pa) == repr(ja)
    assert pa.audio_data.device == torch.device("cpu")
    wins_p, wins_j = list(pa.windows(0.1, 0.05)), list(ja.windows(0.1, 0.05))
    assert len(wins_p) == len(wins_j)
    for wp, wj in zip(wins_p, wins_j):
        np.testing.assert_array_equal(wp.audio_data.numpy(), np.asarray(wj.audio_data))
    np.testing.assert_array_equal(AudioSignal.batch([pa, pb]).audio_data.numpy(),
                                  np.asarray(JAudioSignal.batch([ja, jb]).audio_data))
    with pytest.raises(ValueError):
        AudioSignal.batch([pa, pb], pad=False)
    with pytest.raises(ValueError):
        AudioSignal.batch([pa, AudioSignal(b, 16000, device="cpu")])
    np.testing.assert_array_equal(pa.concat(pb).audio_data.numpy(),
                                  np.asarray(ja.concat(jb).audio_data))
    other = AudioSignal(b, 16000, device="cpu")
    np.testing.assert_allclose(pa.concat(other).audio_data.numpy(),
                               np.asarray(ja.concat(JAudioSignal(b, 16000)).audio_data),
                               **AUDIO_TOL)
    c = AudioSignal(a, sr, device="cpu")
    for got, want in (((pa + c), (ja + JAudioSignal(a, sr))), ((pa - 0.5), (ja - 0.5)),
                      ((pa * 2.0), (ja * 2.0)), ((2.0 * pa), (2.0 * ja))):
        np.testing.assert_array_equal(got.audio_data.numpy(), np.asarray(want.audio_data))


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_wav_write_load_round_trip(tmp_path, rng, bits):
    x = _noise(rng, 2, 3000, scale=0.5)
    x[0, :2] = (1.5, -1.5)  # clipped
    path = tmp_path / f"x{bits}.wav"
    AudioSignal(x, 22050, device="cpu").write(path, bits=bits)
    with wave.open(str(path), "rb") as f:
        assert (f.getsampwidth(), f.getnchannels(), f.getframerate()) == (bits // 8, 2, 22050)
    loaded = AudioSignal.load(path, device="cpu")
    assert loaded.sample_rate == 22050 and loaded.audio_data.shape == (1, 2, 3000)
    np.testing.assert_allclose(loaded.audio_data[0].numpy(), np.clip(x, -1, 1),
                               rtol=0, atol=2.0 ** (1 - bits) * 2)
    want = JAudioSignal.load(path, offset=0.01, duration=0.05)
    got = AudioSignal.load(path, offset=0.01, duration=0.05, device="cpu")
    np.testing.assert_array_equal(got.audio_data.numpy(), np.asarray(want.audio_data))
    if bits == 16:  # the JAX package writes 16-bit files only: the bytes agree
        jpath = tmp_path / "j.wav"
        JAudioSignal(x, 22050).write(jpath)
        assert path.read_bytes() == jpath.read_bytes()


# ------------------------------------------------------------ the slice


def test_dsp_pipeline_matches_jax(rng):
    """The config-4 chain (resample 44.1 -> 24 kHz, compressor, mel) at
    2 clips x 0.5 s."""
    x = _noise(rng, 2, 22050)
    jy = jresample.resample_poly(jnp.asarray(x), 44100, 24000)
    jc = jeffects.apply_compressor(jy, 24000, threshold=-20.0, ratio=4.0)
    want = np.asarray(jmel.mel_spectrogram(jc, 24000, n_mels=80))
    y = resample.resample_poly(_t(x), 44100, 24000)
    c = effects.apply_compressor(y, 24000, threshold=-20.0, ratio=4.0)
    got = mel.mel_spectrogram(c, 24000, n_mels=80)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **AUDIO_TOL)
    assert got.shape == want.shape == (2, 80, 1 + 12000 // 512)
    _assert_rel(got, want)


def test_loudness_path_matches_jax(rng):
    """AudioSignal.loudness / .normalize of 2 mono clips x 0.5 s at 24 kHz."""
    x = _noise(rng, 2, 1, 12000)
    x[1] *= 0.1
    j, p = JAudioSignal(x, 24000), AudioSignal(x, 24000, device="cpu")
    np.testing.assert_allclose(p.loudness().numpy(), np.asarray(j.loudness()), rtol=0, atol=1e-3)
    pn, jn = p.normalize(-24.0), j.normalize(-24.0)
    np.testing.assert_allclose(pn.audio_data.numpy(), np.asarray(jn.audio_data), **AUDIO_TOL)
    np.testing.assert_allclose(pn.loudness().numpy(), -24.0, rtol=0, atol=0.1)
