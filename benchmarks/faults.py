"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false (``tests/test_bench_faults.py``) and for the
readings of a fault at a cell's own size (``control.py --fault``).

    with planted("tts", "noise_frozen"):
        ...   # the program samples with one Gumbel draw for every step

Codec faults: an RVQ stage's codes of one clip altered (``stage_codes``),
the first half's answers given to the second half (``half_batch``), a
clip's audio altered (``audio``). Text-to-speech faults: a sampled token
altered (``token``), a decode step that returns its state unchanged
(``state_unchanged``), the first half's codes given to the second half
(``half_batch``), the vocoder's audio altered (``vocoder``); and in the
sampler: top-k and top-p left out (``no_filter``), the temperature left
out (``no_temperature``), one noise draw for every step (``noise_frozen``).
A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


def _codec(patch, fault: str) -> None:
    from neuralcodecs_tpu_torch.models.dac.model import DAC

    forward_fn = DAC._forward_fn

    def broken(self, audio, n_quantizers):
        out = forward_fn(self, audio, n_quantizers)
        codes = out["codes"]
        if fault == "stage_codes":
            codes[0, 1] = (codes[0, 1] + 1) % self.config.codebook_size
        elif fault == "half_batch":
            half = codes.shape[0] // 2
            codes[half:] = codes[:half]
            out["audio"][half:] = out["audio"][:half]
        elif fault == "audio":
            out["audio"][0] *= 1.01
        return out

    patch(DAC, "_forward_fn", broken)


def _tts(patch, fault: str) -> None:
    from neuralcodecs_tpu_torch.models.dac.model import DAC
    from neuralcodecs_tpu_torch.models.dia import model as dia_model

    sample = dia_model._sample_next_token
    if fault == "token":
        def broken(logits, *args, **kwargs):
            out = sample(logits, *args, **kwargs)
            out[0] = (out[0] + 1) % 1024
            return out

        patch(dia_model, "_sample_next_token", broken)
    elif fault in ("no_filter", "no_temperature"):
        def broken(logits, noise, temperature, top_k, top_p, eos_value):
            if temperature >= 1e-5:
                if fault == "no_filter":
                    top_k, top_p = 0, 1.0
                else:
                    temperature = 1.0
            return sample(logits, noise, temperature, top_k, top_p, eos_value)

        patch(dia_model, "_sample_next_token", broken)
    elif fault == "noise_frozen":
        draw, drawn = dia_model.gumbel_noise, {}

        def frozen(noise, shape):
            # drawn once, eagerly (a step graph's warm-up runs before its capture)
            key = (len(noise.generators), tuple(shape), str(noise.device))
            if key not in drawn:
                drawn[key] = draw(noise, shape)
            return drawn[key]

        patch(dia_model, "gumbel_noise", frozen)
    elif fault == "state_unchanged":
        patch(dia_model.Dia, "_decode_step", lambda self, st, s, n=None: None)
    elif fault == "half_batch":
        codes_fn = dia_model.Dia._codes

        def broken(self, st, prefill_steps, b):
            codes, lengths, finished = codes_fn(self, st, prefill_steps, b)
            codes[b // 2:] = codes[: b - b // 2]
            return codes, lengths, finished

        patch(dia_model.Dia, "_codes", broken)
    elif fault == "vocoder":
        from_codes = DAC.from_codes

        def broken(self, codes):
            return from_codes(self, codes) * 1.01

        patch(DAC, "from_codes", broken)


CODEC = ("stage_codes", "half_batch", "audio")
TTS = ("token", "state_unchanged", "half_batch", "vocoder", "no_filter", "no_temperature",
       "noise_frozen")


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The program with ``fault`` of a ``kind`` ("codec" or "tts") cell
    planted, restored on exit."""
    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    try:
        if fault not in {"codec": CODEC, "tts": TTS}[kind]:
            raise ValueError(f"no {kind} fault {fault!r}")
        (_codec if kind == "codec" else _tts)(patch, fault)
        yield
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)
