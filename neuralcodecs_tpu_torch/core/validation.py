"""Post-load model validation (copy of neuralcodecs_tpu.core.validation).

A cheap runtime smoke test: config sanity checks, and an encode/decode of
one short synthetic tone on the model's own device, checked for finite
samples of about the input's length.
"""

from __future__ import annotations

import numpy as np

from neuralcodecs_tpu_torch.core.exceptions import ValidationError


def validate_config(config) -> None:
    """Config sanity checks: a plausible sample rate, positive widths and
    rates, and a power-of-two Encodec codebook."""
    arch = getattr(config, "architecture", "")
    sr = getattr(config, "sample_rate", None) or getattr(config, "sampling_rate", 0)
    if not (8000 <= sr <= 192000):
        raise ValidationError(f"{arch}: implausible sample rate {sr}")
    for name in ("encoder_dim", "decoder_dim", "codebook_size", "codebook_dim",
                 "hidden_size", "num_filters", "n_codebooks"):
        value = getattr(config, name, None)
        if value is not None and value <= 0:
            raise ValidationError(f"{arch}: {name} must be positive, got {value}")
    for name in ("encoder_rates", "decoder_rates", "upsampling_ratios",
                 "vq_strides"):
        rates = getattr(config, name, None)
        if rates is not None and any(r <= 0 for r in rates):
            raise ValidationError(f"{arch}: {name} must be positive, got {rates}")
    cb = getattr(config, "codebook_size", None)
    if cb is not None and cb & (cb - 1) and arch == "encodec":
        raise ValidationError(f"encodec codebook_size must be a power of 2, got {cb}")


def validate_model(model, duration_s: float = 0.25) -> None:
    """Run an encode/decode round trip of a 440 Hz tone through
    ``process_audio`` (on the model's device) and sanity-check the output."""
    sample_rate = getattr(model.config, "sample_rate", None) or 24000
    n = max(int(sample_rate * duration_s), 1)
    t = np.arange(n, dtype=np.float32) / sample_rate
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)

    if not hasattr(model, "process_audio"):
        raise ValidationError(f"{type(model).__name__} has no process_audio method")
    out = np.asarray(model.process_audio(tone, sample_rate))
    if out.size == 0:
        raise ValidationError("Validation round-trip produced empty audio")
    if not np.all(np.isfinite(out)):
        raise ValidationError("Validation round-trip produced non-finite samples")
    if abs(out.shape[-1] - n) > sample_rate:  # allow codec padding slack
        raise ValidationError(
            f"Validation round-trip length mismatch: {out.shape[-1]} vs {n}"
        )
