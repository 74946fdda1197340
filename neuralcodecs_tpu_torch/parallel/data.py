"""Training data: audio file discovery, random fixed-length crops and a
background prefetcher (copy of neuralcodecs_tpu.parallel.data).

Host work in numpy: files are read on the CPU (``AudioSignal.load(...,
device="cpu")``) and batches come out as numpy arrays [B, crop, 1]; the
training step moves them to the card. With the same seed and files the
crops equal the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

_AUDIO_EXTS = (".wav",)


def find_audio_files(root: str | Path, recursive: bool = True) -> list[Path]:
    """Discover audio files under a directory (Utils.FindAudio)."""
    root = Path(root)
    pattern = "**/*" if recursive else "*"
    return sorted(p for p in root.glob(pattern)
                  if p.suffix.lower() in _AUDIO_EXTS and p.is_file())


class AudioCropDataset:
    """Random fixed-length crops from a directory of WAV files.

    Yields [batch, crop_samples, 1] float32 arrays for the codec training
    step. Files are kept in memory after their first read."""

    def __init__(self, root: str | Path, sample_rate: int,
                 crop_seconds: float = 0.5, batch_size: int = 8,
                 seed: int = 0, loop: bool = True,
                 normalize_db: float | None = None):
        self.files = find_audio_files(root)
        if not self.files:
            raise FileNotFoundError(f"No audio files under {root}")
        self.sample_rate = sample_rate
        self.crop = int(crop_seconds * sample_rate)
        self.batch_size = batch_size
        self.loop = loop
        self.normalize_db = normalize_db
        self._rng = np.random.default_rng(seed)
        self._cache: dict[Path, np.ndarray] = {}

    def _load(self, path: Path) -> np.ndarray:
        cached = self._cache.get(path)
        if cached is None:
            from neuralcodecs_tpu_torch.dsp.signal import AudioSignal

            signal = AudioSignal.load(path, device="cpu").to_mono()
            if signal.sample_rate != self.sample_rate:
                signal = signal.resample(self.sample_rate)
            cached = signal.audio_data[0, 0].numpy().astype(np.float32)
            self._cache[path] = cached
        return cached

    def _crop_one(self) -> np.ndarray:
        path = self.files[self._rng.integers(len(self.files))]
        audio = self._load(path)
        if len(audio) <= self.crop:
            out = np.zeros(self.crop, np.float32)
            out[: len(audio)] = audio
        else:
            start = self._rng.integers(len(audio) - self.crop)
            out = audio[start: start + self.crop]
        if self.normalize_db is not None:
            rms = np.sqrt(np.mean(out**2)) + 1e-9
            target = 10.0 ** (self.normalize_db / 20.0)
            out = out * (target / rms)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            batch = np.stack([self._crop_one() for _ in range(self.batch_size)])
            yield batch[..., None]
            if not self.loop:
                return


def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue, so host
    data preparation overlaps device compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
