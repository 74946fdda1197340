"""The benchmark's plain SNAC reference (``benchmarks/reference/snac.py``)
against the port's CPU path at a tiny width.

Both run float32 on the CPU (the port's kernel wrappers take their plain
versions there), with the same seeded weights and the decoder's noise drawn
from generators of the same seed: the codes must be equal at every scale
and the audio within 1e-5 relative L2 (the two differ only in the order of
f32 sums through a dozen convolutions, and in the pooling's sum, ~1e-7 a
layer). The reference imports neither the port nor JAX, so that the
benchmark's runs, which load neither, can use it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import snac_faults  # noqa: E402
from benchmarks.reference import snac as ref  # noqa: E402
from neuralcodecs_tpu_torch.models.snac import SNAC  # noqa: E402
from neuralcodecs_tpu_torch.models.snac.config import SNACConfig  # noqa: E402

CFG = {"sampling_rate": 2400, "encoder_dim": 8, "encoder_rates": [2, 4], "latent_dim": None,
       "decoder_dim": 32, "decoder_rates": [4, 2], "attn_window_size": None,
       "codebook_size": 256, "codebook_dim": 4, "vq_strides": [4, 2, 1], "noise": True,
       "depthwise": True}
LIMITS = json.loads((ROOT / "benchmarks" / "workloads"
                     / "snac24k-roundtrip-32x10s.json").read_text())["limits"]


def _port(weights) -> SNAC:
    model = SNAC(SNACConfig(**CFG), device="cpu")
    model.load_state_dict(weights)
    return model.eval()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_param_shapes_are_the_ports_state_dict():
    own = SNAC(SNACConfig(**CFG), device="cpu").state_dict()
    assert [(k, tuple(v.shape)) for k, v in own.items()] == list(ref.param_shapes(CFG).items())


@pytest.mark.parametrize("seed,batch,samples", [(1, 2, 1000), (2, 1, 1777)])
def test_reference_matches_port(seed, batch, samples):
    w = ref.draw_weights(CFG, seed, "cpu")
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 0.3, (batch, samples)),
                        dtype=torch.float32)
    audio, codes = _port(w).forward(x)
    want = ref.encode(w, CFG, x)
    assert len(codes) == len(want) == 3
    for got, expected in zip(codes, want):
        assert torch.equal(got.long(), expected)
    decoded = ref.decode(w, CFG, codes, ref.noise_generator("cpu"))[:, :samples]
    assert _rel(audio, decoded) < 1e-5
    # the noise is drawn: other draws give other audio
    other = ref.decode(w, CFG, codes, ref.noise_generator("cpu", seed=1))[:, :samples]
    assert _rel(other, decoded) > 1e-3


def test_the_noise_fault_fails_the_audio_check():
    w = ref.draw_weights(CFG, 4, "cpu")
    x = torch.as_tensor(np.random.default_rng(4).normal(0, 0.3, (2, 960)), dtype=torch.float32)
    with snac_faults.planted("noise"):
        audio, codes = _port(w).forward(x)
    decoded = ref.decode(w, CFG, codes, ref.noise_generator("cpu"))[:, :960]
    assert _rel(audio, decoded) > LIMITS["audio_rel_err"]


def test_the_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmarks.reference.snac; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'neuralcodecs_tpu', 'neuralcodecs_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
