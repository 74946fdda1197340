"""The plain DAC reference against the port's CPU path at a tiny width.

Both run float32 on the CPU (the port's kernel wrappers take their plain
versions there), with the same seeded weights: the codes must be equal and
the audio within 1e-5 relative L2 (the two differ only in the order of
f32 sums through a dozen convolutions, ~1e-7 a layer).
"""

import numpy as np
import pytest
import torch

from benchmarks.reference import dac as ref
from benchmarks.tests.tiny import DAC as CFG


def _port(weights):
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

    keys = ("sample_rate", "encoder_dim", "encoder_rates", "decoder_dim", "decoder_rates",
            "n_codebooks", "codebook_size", "codebook_dim", "latent_dim")
    model = DAC(DACConfig(**{k: CFG[k] for k in keys}), device="cpu")
    model.load_state_dict(weights)
    return model.eval()


def test_param_shapes_are_the_checkpoint_keys():
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig

    keys = ("sample_rate", "encoder_dim", "encoder_rates", "decoder_dim", "decoder_rates",
            "n_codebooks", "codebook_size", "codebook_dim", "latent_dim")
    own = DAC(DACConfig(**{k: CFG[k] for k in keys}), device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == ref.param_shapes(CFG)


def test_draw_weights_is_seeded():
    a, b = ref.draw_weights(CFG, 7, "cpu"), ref.draw_weights(CFG, 7, "cpu")
    c = ref.draw_weights(CFG, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("seed,batch,samples", [(1, 2, 1000), (2, 1, 1777), (3, 3, 256)])
def test_reference_matches_port(seed, batch, samples):
    w = ref.draw_weights(CFG, seed, "cpu")
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 0.3, (batch, samples)),
                        dtype=torch.float32)
    out = _port(w).forward(x)
    assert torch.equal(ref.encode(w, CFG, x), out["codes"].long())
    want = ref.decode(w, CFG, out["codes"])[:, :samples]
    err = torch.linalg.vector_norm(out["audio"] - want) / torch.linalg.vector_norm(want)
    assert float(err) < 1e-5


def test_tf32_control_is_a_noop_on_the_cpu():
    # the control's TF32 switch acts on the card only; on the CPU it must at
    # least restore the flags it changes
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with ref.precision(tf32=True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
