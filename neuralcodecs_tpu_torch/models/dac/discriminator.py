"""DAC discriminators: multi-period and multi-band STFT ensembles.

Counterpart of neuralcodecs_tpu.models.dac.discriminator as ``nn.Module``s,
with its semantics (not upstream descript's):

  * MPD (``PeriodDiscriminator``): audio zero-padded on the right to a
    multiple of the period and folded to [T/p, p], then four strided (5, 1)
    convs and a (3, 1) post conv;
  * MRD (``BandDiscriminator``): the STFT's real and imaginary parts as two
    channels, split into five frequency bands at int(lo · n_freq) :
    int(hi · n_freq), four convs per band, the bands concatenated along
    frequency and one (3, 3) post conv.

Leaky ReLU (slope 0.1) follows every conv but the post conv. Convs are
``nn.Conv2d`` in NCHW, where the JAX package runs NHWC: the features are
[B, C, H, W] here and [B, H, W, C] there (H the time axis, W the period or
the frequency). Parameter names are the JAX package's keys
(``discriminator.mpd.{i}.convs.{j}``, ``discriminator.mrd.{i}.band_convs.{b}.{j}``,
``...conv_post``), so ``core.weights.from_jax_params`` carries its weights
and gradients across. Weights are torch-default random from ``seed``: the
JAX package's uniform ±1/√fan_in, drawn by another generator.

``DACDiscriminator(audio [B, T])`` returns, per sub-discriminator,
[feature_0, ..., feature_n, logits] (``losses/gan.py``'s DiscOutputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neuralcodecs_tpu_torch.core.device import resolve_device
from neuralcodecs_tpu_torch.dsp.stft import stft

_LRELU_SLOPE = 0.1


class PeriodDiscriminator(nn.Module):
    """Fold audio to [T/p, p] and run a strided 2-D conv stack (HiFi-GAN MPD)."""

    _CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [1, *self._CHANNELS]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], (5, 1), stride=(3, 1), padding=(2, 0))
            for i in range(len(self._CHANNELS)))
        self.conv_post = nn.Conv2d(self._CHANNELS[-1], 1, (3, 1), padding=(1, 0))

    def forward(self, audio: torch.Tensor) -> list[torch.Tensor]:
        """audio [B, T] -> [feature..., logits], each [B, C, T/p, p]."""
        b, t = audio.shape
        x = F.pad(audio, (0, (-t) % self.period)).reshape(b, 1, -1, self.period)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), _LRELU_SLOPE)
            feats.append(x)
        return [*feats, self.conv_post(x)]


class BandDiscriminator(nn.Module):
    """STFT split into frequency bands, a conv stack per band (MRD)."""

    _BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
    _CH = 32

    def __init__(self, fft_size: int):
        super().__init__()
        self.fft_size = fft_size
        self.band_convs = nn.ModuleList(
            nn.ModuleList(
                nn.Conv2d(2 if j == 0 else self._CH, self._CH,
                          (3, 9) if j < 3 else (3, 3),
                          stride=(1, 2) if 0 < j < 3 else (1, 1),
                          padding=(1, 4) if j < 3 else (1, 1))
                for j in range(4))
            for _ in self._BANDS)
        self.conv_post = nn.Conv2d(self._CH, 1, (3, 3), padding=(1, 1))

    def forward(self, audio: torch.Tensor) -> list[torch.Tensor]:
        """audio [B, T] -> [feature..., logits], each [B, C, frames, F']."""
        spec = stft(audio, n_fft=self.fft_size, hop_length=self.fft_size // 4)
        # [B, F, frames] complex -> [B, 2, frames, F]: real and imaginary as channels
        x = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)
        n_freq = x.shape[3]
        feats, band_outs = [], []
        for (lo, hi), stack in zip(self._BANDS, self.band_convs):
            h = x[..., int(lo * n_freq): int(hi * n_freq)]
            for conv in stack:
                h = F.leaky_relu(conv(h), _LRELU_SLOPE)
                feats.append(h)
            band_outs.append(h)
        return [*feats, self.conv_post(torch.cat(band_outs, dim=3))]


class DACDiscriminator(nn.Module):
    """The ensemble: one MPD per period and one MRD per FFT length, on
    ``device`` ("cuda" when none is given)."""

    def __init__(self, periods=(2, 3, 5, 7, 11), fft_sizes=(2048, 1024, 512), seed: int = 0,
                 device: torch.device | str | None = None):
        super().__init__()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.discriminator = nn.ModuleDict({
                "mpd": nn.ModuleList(PeriodDiscriminator(p) for p in periods),
                "mrd": nn.ModuleList(BandDiscriminator(n) for n in fft_sizes)})
        self.to(resolve_device(device))

    def forward(self, audio: torch.Tensor) -> list[list[torch.Tensor]]:
        """audio [B, T] -> per sub-discriminator [feature..., logits]."""
        subs = [*self.discriminator["mpd"], *self.discriminator["mrd"]]
        return [sub(audio) for sub in subs]
