"""Tiny cells for the CPU tests: a copy of the benchmark's folder (and of
BENCHMARK.json) with a tiny DAC, a tiny Dia vocoded by it, and one cell of
each driver at a few-hundred-millisecond size, listed wherever the real
cell of the same driver is."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

DAC = {"source": "tiny", "architecture": "dac", "sample_rate": 4410, "encoder_dim": 8,
       "encoder_rates": [2, 4], "latent_dim": None, "decoder_dim": 32, "decoder_rates": [4, 2],
       "n_codebooks": 3, "codebook_size": 1024, "codebook_dim": 4, "dtype": "float32",
       "reduced": [], "assumed": []}
DIA = {"source": "tiny", "architecture": "dia", "vocab_size": 256, "tgt_vocab_size": 1028,
       "normalization_layer_epsilon": 1e-5, "rope_min_timescale": 1, "rope_max_timescale": 10000,
       "data": {"text_length": 64, "audio_length": 128, "channels": 3, "text_pad_value": 0,
                "audio_eos_value": 1024, "audio_pad_value": 1025, "audio_bos_value": 1026,
                "delay_pattern": [0, 1, 2]},
       "encoder": {"n_layer": 2, "n_embd": 32, "n_hidden": 64, "n_head": 2, "head_dim": 16},
       "decoder": {"n_layer": 2, "n_embd": 48, "n_hidden": 96, "gqa_query_heads": 4,
                   "kv_heads": 2, "gqa_head_dim": 16, "cross_query_heads": 2,
                   "cross_head_dim": 16},
       "cfg_scale": 3.0, "temperature": 1.2, "top_p": 0.95, "top_k": 45, "sample_rate": 4410,
       "compute_dtype": "bfloat16", "vocoder": "dac-tiny", "reduced": [], "assumed": []}
TEXTS = ["[S1] one two [S2] three", "[S1] four five six [S2] seven", "[S1] eight [S2] nine ten",
         "[S1] eleven twelve [S2] thirteen fourteen"]
CELLS = {
    "tiny-dac": {"config": "dac-tiny", "driver": "codec_roundtrip", "chips": 1, "why": "tiny",
                 "traffic": {"batch": 2, "clip_seconds": 0.2, "pool": 2, "check_requests": 2},
                 "traced_calls": 2,
                 "limits": {"codes_mismatch_pct": 1.0, "audio_rel_err": 1e-4}},
    "tiny-ragged": {"config": "dac-tiny", "driver": "codec_roundtrip", "chips": 1, "why": "tiny",
                    "traffic": {"batch": 1, "clip_seconds": {"lognormal_quantiles": 4,
                                                             "median": 0.2, "sigma": 0.9,
                                                             "min": 0.1, "max": 1.0},
                                "check_requests": 2, "check_longest": True},
                    "traced_calls": 4,
                    "limits": {"codes_mismatch_pct": 1.0, "audio_rel_err": 1e-4}},
    "tiny-dia": {"config": "dia-tiny", "driver": "tts_generate", "chips": 1, "why": "tiny",
                 "traffic": {"batch": 2, "max_tokens": 128, "pad_tokens_to": 128,
                             "greedy_every": 2, "greedy_offset": 0, "texts": TEXTS},
                 "traced_calls": 1,
                 "limits": {"served_gap_max": 1.0, "served_flip_pct": 10.0,
                            "served_gap_mean": 1.0, "sampled_out_pct": 5.0, "sampled_ll_z": 6.0,
                            "sampled_repeat_z": 6.0, "vocoder_rel_err": 1e-4}},
}
# window seconds: the Dia check needs a greedy and a sampled call in it
SECONDS = {"tiny-dac": 0.3, "tiny-ragged": 0.3, "tiny-dia": 2.0}
LIKE = {"tiny-dac": "dac44k-roundtrip-4x10s", "tiny-ragged": "dac44k-roundtrip-1xragged",
        "tiny-dia": "dia1.6b-bf16-tts-4x512"}


def tiny_bench(tmp: Path) -> Path:
    """The copy under ``tmp``; returns its benchmark folder."""
    bench = tmp / "benchmarks"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "dac-tiny.json").write_text(json.dumps(DAC))
    (bench / "configs" / "dia-tiny.json").write_text(json.dumps(DIA))
    for name, cell in CELLS.items():
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for entry in spec["end_to_end"] + spec["per_layer"]:
        entry["workloads"] = entry.get("workloads", [])
        entry["workloads"] += [t for t, real in LIKE.items() if real in entry["workloads"]]
        if not entry["workloads"]:
            del entry["workloads"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
