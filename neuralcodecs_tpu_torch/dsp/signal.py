"""AudioSignal: a batch of audio with its DSP methods (counterpart of
neuralcodecs_tpu.dsp.signal).

Wraps a [B, C, T] f32 tensor on a device of the caller's choosing and a
sample rate. Every method returns a new AudioSignal or a tensor on the same
device; WAV files go through the standard ``wave`` module.
"""

from __future__ import annotations

import dataclasses
import wave
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.dsp.audio_utils import pcm16_to_float, pcm24_to_float, pcm32_to_float
from neuralcodecs_tpu_torch.dsp.loudness import integrated_loudness, normalize_loudness
from neuralcodecs_tpu_torch.dsp.mel import mel_spectrogram, mfcc
from neuralcodecs_tpu_torch.dsp.resample import resample_poly
from neuralcodecs_tpu_torch.dsp.stft import STFTParams, istft, stft

_DECODE = {2: pcm16_to_float, 3: pcm24_to_float, 4: pcm32_to_float}


@dataclasses.dataclass
class AudioInfo:
    duration: float
    num_frames: int
    sample_rate: float


class AudioSignal:
    """[B, C, T] audio and its sample rate. ``audio`` may be [T], [C, T] or
    [B, C, T], a tensor or an array; ``device`` moves it (None keeps a
    tensor where it is and puts an array on "cuda")."""

    def __init__(self, audio, sample_rate: int, stft_params: STFTParams | None = None,
                 device: torch.device | str | None = None):
        if device is None and not isinstance(audio, torch.Tensor):
            device = resolve_device()
        a = torch.as_tensor(audio, dtype=torch.float32, device=device)
        if a.dim() == 1:
            a = a[None, None, :]
        elif a.dim() == 2:
            a = a[None]
        self.audio_data = a
        self.sample_rate = int(sample_rate)
        self.stft_params = stft_params or STFTParams()

    def _new(self, audio: torch.Tensor, sample_rate: int | None = None) -> "AudioSignal":
        return AudioSignal(audio, sample_rate or self.sample_rate, self.stft_params)

    # ------------------------------------------------------------------- I/O

    @classmethod
    def load(cls, path: str | Path, offset: float = 0.0, duration: float | None = None,
             device: torch.device | str | None = None) -> "AudioSignal":
        """Read a 16-, 24- or 32-bit PCM WAV file onto ``device`` ("cuda" if None)."""
        with wave.open(str(path), "rb") as f:
            sr, channels, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
            start = int(offset * sr)
            f.setpos(min(start, f.getnframes()))
            count = f.getnframes() - start
            if duration is not None:
                count = min(count, int(duration * sr))
            raw = f.readframes(count)
        if width not in _DECODE:
            raise ValueError(f"Unsupported WAV sample width: {width}")
        data = _DECODE[width](raw).reshape(-1, channels).T  # [C, T]
        return cls(np.ascontiguousarray(data), sr, device=device)

    def write(self, path: str | Path, bits: int = 16) -> None:
        """Write the first batch item as a 16-, 24- or 32-bit PCM WAV file
        (samples clipped to [-1, 1], scaled by 2^(bits-1) − 1, truncated)."""
        if bits not in (16, 24, 32):
            raise ValueError(f"Unsupported WAV bit depth: {bits}")
        a = self.audio_data[0].detach().cpu().numpy()  # [C, T]
        clipped = np.clip(a.T, -1.0, 1.0)
        if bits == 16:
            raw = (clipped * 32767.0).astype(np.int16).tobytes()
        else:
            ints = np.ascontiguousarray(
                (clipped.astype(np.float64) * float((1 << (bits - 1)) - 1)).astype("<i4"))
            raw = ints.tobytes() if bits == 32 else \
                ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        with wave.open(str(path), "wb") as f:
            f.setnchannels(a.shape[0])
            f.setsampwidth(bits // 8)
            f.setframerate(self.sample_rate)
            f.writeframes(raw)

    # ------------------------------------------------------------ properties

    @property
    def batch_size(self) -> int:
        return self.audio_data.shape[0]

    @property
    def num_channels(self) -> int:
        return self.audio_data.shape[1]

    @property
    def signal_length(self) -> int:
        return self.audio_data.shape[2]

    @property
    def signal_duration(self) -> float:
        return self.signal_length / self.sample_rate

    @property
    def info(self) -> AudioInfo:
        return AudioInfo(duration=self.signal_duration, num_frames=self.signal_length,
                         sample_rate=float(self.sample_rate))

    # ------------------------------------------------------------------- DSP

    def stft(self, **overrides) -> torch.Tensor:
        """Complex STFT [B, C, F, frames]."""
        p = self.stft_params
        return stft(self.audio_data,
                    n_fft=overrides.get("window_length", p.window_length),
                    hop_length=overrides.get("hop_length", p.hop_length),
                    window_type=overrides.get("window_type", p.window_type),
                    center=overrides.get("center", p.center))

    def istft(self, spec: torch.Tensor, length: int | None = None) -> "AudioSignal":
        p = self.stft_params
        return self._new(istft(spec, n_fft=p.window_length, hop_length=p.hop_length,
                               window_type=p.window_type, center=p.center,
                               length=length or self.signal_length))

    def mel_spectrogram(self, n_mels: int = 80, **overrides) -> torch.Tensor:
        p = self.stft_params
        return mel_spectrogram(
            self.audio_data, self.sample_rate, n_mels=n_mels,
            n_fft=overrides.get("window_length", p.window_length),
            hop_length=overrides.get("hop_length", p.hop_length),
            window_type=overrides.get("window_type", p.window_type),
            f_min=overrides.get("mel_fmin", 0.0),
            f_max=overrides.get("mel_fmax", None))

    def mfcc(self, n_mfcc: int = 40, n_mels: int = 80) -> torch.Tensor:
        p = self.stft_params
        return mfcc(self.audio_data, self.sample_rate, n_mfcc=n_mfcc, n_mels=n_mels,
                    n_fft=p.window_length, hop_length=p.hop_length)

    def loudness(self) -> torch.Tensor:
        """Integrated LUFS per batch item, [B]."""
        return integrated_loudness(self.audio_data, self.sample_rate)

    def normalize(self, target_db: float = -24.0) -> "AudioSignal":
        return self._new(normalize_loudness(self.audio_data, self.sample_rate, target_db))

    def resample(self, target_rate: int) -> "AudioSignal":
        if target_rate == self.sample_rate:
            return self
        return self._new(resample_poly(self.audio_data, self.sample_rate, target_rate),
                         target_rate)

    def to_mono(self) -> "AudioSignal":
        return self._new(self.audio_data.mean(dim=1, keepdim=True))

    def peak_normalize(self, peak: float = 1.0) -> "AudioSignal":
        m = self.audio_data.abs().amax(dim=(1, 2), keepdim=True)
        return self._new(self.audio_data / torch.clamp(m, min=1e-9) * peak)

    def preemphasis(self, coef: float = 0.85) -> "AudioSignal":
        a = self.audio_data
        return self._new(torch.cat([a[..., :1], a[..., 1:] - coef * a[..., :-1]], dim=-1))

    # -------------------------------------------------------- batch/slicing

    def excerpt(self, offset: float, duration: float) -> "AudioSignal":
        start = int(offset * self.sample_rate)
        return self._new(self.audio_data[..., start:start + int(duration * self.sample_rate)])

    def windows(self, window_duration: float, hop_duration: float) -> Iterable["AudioSignal"]:
        """Fixed-length windows, ``hop_duration`` apart."""
        w = int(window_duration * self.sample_rate)
        h = int(hop_duration * self.sample_rate)
        for start in range(0, max(self.signal_length - w + 1, 1), h):
            yield self._new(self.audio_data[..., start:start + w])

    @staticmethod
    def batch(signals: Sequence["AudioSignal"], pad: bool = True) -> "AudioSignal":
        """Stack signals into one batch, right-padding to the longest."""
        if not signals:
            raise ValueError("No signals to batch")
        sr = signals[0].sample_rate
        if any(s.sample_rate != sr for s in signals):
            raise ValueError("All signals must share a sample rate")
        max_t = max(s.signal_length for s in signals)
        if not pad and any(s.signal_length != max_t for s in signals):
            raise ValueError("Signals differ in length and pad=False")
        rows = [F.pad(s.audio_data, (0, max_t - s.signal_length)) for s in signals]
        return AudioSignal(torch.cat(rows, dim=0), sr, signals[0].stft_params)

    def concat(self, other: "AudioSignal") -> "AudioSignal":
        if other.sample_rate != self.sample_rate:
            other = other.resample(self.sample_rate)
        return self._new(torch.cat([self.audio_data, other.audio_data], dim=-1))

    # --------------------------------------------------------- arithmetic ops

    def _coerce(self, other):
        return other.audio_data if isinstance(other, AudioSignal) else other

    def __add__(self, other):
        return self._new(self.audio_data + self._coerce(other))

    def __sub__(self, other):
        return self._new(self.audio_data - self._coerce(other))

    def __mul__(self, other):
        return self._new(self.audio_data * self._coerce(other))

    __rmul__ = __mul__

    def __len__(self) -> int:
        return self.batch_size

    def __repr__(self) -> str:
        return (f"AudioSignal(batch={self.batch_size}, channels={self.num_channels}, "
                f"duration={self.signal_duration:.3f}s, sr={self.sample_rate})")
