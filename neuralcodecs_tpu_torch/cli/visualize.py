"""Spectrogram visualization + comparison.

Counterpart of neuralcodecs_tpu.cli.visualize (the reference's
NeuralCodecs.Torch.Examples/AudioVisualizer.cs:18-94: SkiaSharp/ScottPlot
spectrograms and diff images). Dependency-free: renders log-mel
spectrograms to PPM/PGM images with a viridis-like colormap, plus numeric
audio stats (Program.PrintAudioStats :725). Numpy in, numpy out: the mel
runs on a torch tensor's own device, and on the CPU for an array.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from neuralcodecs_tpu_torch.dsp.mel import mel_spectrogram

# coarse viridis control points (r, g, b)
_VIRIDIS = np.array([
    (68, 1, 84), (72, 40, 120), (62, 74, 137), (49, 104, 142),
    (38, 130, 142), (31, 158, 137), (53, 183, 121), (109, 205, 89),
    (180, 222, 44), (253, 231, 37),
], np.float32)


def _colormap(norm: np.ndarray) -> np.ndarray:
    """[H, W] in [0,1] -> [H, W, 3] uint8 via viridis interpolation."""
    pos = norm * (len(_VIRIDIS) - 1)
    lo = np.clip(pos.astype(int), 0, len(_VIRIDIS) - 2)
    frac = (pos - lo)[..., None]
    rgb = _VIRIDIS[lo] * (1 - frac) + _VIRIDIS[lo + 1] * frac
    return rgb.astype(np.uint8)


def write_ppm(path: str | Path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def log_mel_image(audio: np.ndarray, sample_rate: int, n_mels: int = 128,
                  n_fft: int = 1024) -> np.ndarray:
    """Audio [T] -> log-mel image [n_mels, frames] (flipped, dB-scaled).
    A tensor stays on its device for the mel; an array goes as a CPU tensor."""
    if isinstance(audio, torch.Tensor):
        x = audio.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(audio, np.float32), device="cpu")
    mel = mel_spectrogram(x, sample_rate, n_mels=n_mels, n_fft=n_fft,
                          hop_length=n_fft // 4, power=2.0).cpu().numpy()
    log_mel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    top = log_mel.max()
    log_mel = np.clip(log_mel, top - 80.0, top)
    norm = (log_mel - log_mel.min()) / max(log_mel.max() - log_mel.min(), 1e-9)
    return norm[::-1]  # low freqs at the bottom


def save_spectrogram(audio: np.ndarray, sample_rate: int,
                     path: str | Path) -> None:
    write_ppm(path, _colormap(log_mel_image(audio, sample_rate)))


def compare_spectrograms(original: np.ndarray, processed: np.ndarray,
                         sample_rate: int, out_dir: str | Path,
                         prefix: str = "compare") -> dict:
    """Side-by-side spectrograms + diff image + numeric stats
    (AudioVisualizer.CompareAudioSpectrograms)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = min(len(original), len(processed))
    original, processed = original[:n], processed[:n]
    a = log_mel_image(original, sample_rate)
    b = log_mel_image(processed, sample_rate)
    w = min(a.shape[1], b.shape[1])
    a, b = a[:, :w], b[:, :w]
    write_ppm(out_dir / f"{prefix}_original.ppm", _colormap(a))
    write_ppm(out_dir / f"{prefix}_processed.ppm", _colormap(b))
    diff = np.abs(a - b)
    write_ppm(out_dir / f"{prefix}_diff.ppm",
              _colormap(diff / max(diff.max(), 1e-9)))
    err = original - processed
    snr = 10.0 * np.log10(np.mean(original**2) / max(np.mean(err**2), 1e-12))
    return {
        "snr_db": float(snr),
        "mel_mean_abs_diff": float(diff.mean()),
        "peak_original": float(np.abs(original).max()),
        "peak_processed": float(np.abs(processed).max()),
    }


def audio_stats(audio: np.ndarray, sample_rate: int) -> dict:
    """Numeric stats block (Program.PrintAudioStats :725)."""
    audio = np.asarray(audio, np.float32)
    rms = float(np.sqrt(np.mean(audio**2)))
    return {
        "samples": int(audio.size),
        "duration_s": audio.size / sample_rate,
        "peak": float(np.abs(audio).max()) if audio.size else 0.0,
        "rms": rms,
        "rms_db": 20.0 * np.log10(max(rms, 1e-12)),
        "dc_offset": float(audio.mean()) if audio.size else 0.0,
    }
