"""The port against the full-width golden (tests/goldens/fullsize_golden.npz).

The fixture pins full-width SNAC-24k and DAC-44k forwards from seeded JAX
weights on a 0.5 s signal (tests/test_goldens.py,
test_fullsize_golden_codes_and_audio). Here the same seeded JAX parameters
cross into the port through ``from_jax_params`` and the port runs on the
CPU. SNAC's codes are compared (its decoder noise comes from the JAX key,
so its audio is not); DAC's codes and its decoded audio at a 64x
decimation (rtol 1e-3 / atol 1e-4). A code may differ only at a near tie:
where the two best normalised scores of the port's own latent lie within
1e-5 relative, or where an earlier stage already differed at the same time
(a flip changes the residual every later stage quantises). Any other
difference fails; the near-tie codes are counted and printed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from make_goldens import SEED, fullsize_input

GOLDEN = Path(__file__).resolve().parent / "goldens" / "fullsize_golden.npz"
NEAR_TIE = 1e-5


def _top2_gap(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Per row of z_e [N, D], the gap between the two best plain scores
    against the normalised codebook, and its near-tie bound."""
    from neuralcodecs_tpu_torch.ops.vq import l2_normalize

    z, cb = l2_normalize(z_e), l2_normalize(codebook)
    scores = torch.sum(cb * cb, dim=-1)[None, :] - 2.0 * (z @ cb.t())
    top2 = torch.topk(scores, 2, dim=-1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) <= NEAR_TIE * (1 + top2[:, 0].abs())


def _snac_near_ties(port, audio: np.ndarray) -> list[np.ndarray]:
    """Per SNAC stage, whether each code's top-two gap is a near tie."""
    a, _ = port._prepare(audio)
    residual = port.encoder(a).float()
    ties = []
    for vq in port.quantizer.quantizers:
        z = residual
        if vq.stride > 1:
            b, c, t = z.shape
            z = z.reshape(b, c, t // vq.stride, vq.stride).mean(dim=-1)
        z_e = vq.in_proj(z).float().transpose(1, 2).reshape(-1, vq.codebook.weight.shape[1])
        ties.append(_top2_gap(z_e, vq.codebook.weight).numpy())
        residual = residual - vq(residual)[0]
    return ties


def _dac_near_ties(port, latents: torch.Tensor) -> list[np.ndarray]:
    d = port.config.codebook_dim
    return [_top2_gap(latents[0, :, i * d: (i + 1) * d], vq.codebook.weight).numpy()
            for i, vq in enumerate(port.quantizer.quantizers[: latents.shape[-1] // d])]


def _count_near_ties(got: list[np.ndarray], want: list[np.ndarray], ties: list[np.ndarray],
                     strides: list[int]) -> int:
    """Codes that differ, each at a near tie or after an earlier stage's
    flip at the same time (stage i's code j spans finest-resolution steps
    [j s_i, (j + 1) s_i)); raises on any other difference."""
    span = max(s * len(g) for s, g in zip(strides, got))
    flipped = np.zeros(span, bool)
    near = 0
    for i, (g, w, tie, s) in enumerate(zip(got, want, ties, strides)):
        assert g.shape == w.shape, f"stage {i}: shape {g.shape} vs {w.shape}"
        diff = np.nonzero(g != w)[0]
        for j in diff:
            if not (tie[j] or flipped[j * s:(j + 1) * s].any()):
                raise AssertionError(f"stage {i} code {j}: {g[j]} vs {w[j]}, not a near tie")
        near += len(diff)
        for j in diff:
            flipped[j * s:(j + 1) * s] = True
    return near


@pytest.mark.slow
def test_fullsize_golden_port():
    from neuralcodecs_tpu.models.dac import DAC as JDAC
    from neuralcodecs_tpu.models.dac import DACConfig as JDACConfig
    from neuralcodecs_tpu.models.snac import SNAC as JSNAC
    from neuralcodecs_tpu.models.snac import SNACConfig as JSNACConfig
    from neuralcodecs_tpu_torch.core.weights import from_jax_params, transposed_groups
    from neuralcodecs_tpu_torch.models.dac import DAC, DACConfig
    from neuralcodecs_tpu_torch.models.snac import SNAC, SNACConfig

    g = np.load(GOLDEN)

    def carry(jmodel, port):
        sd = from_jax_params({k: np.asarray(v) for k, v in jmodel.params.items()},
                             transposed_groups(port))
        port.load_state_dict(sd, strict=True)
        return port.eval()

    with torch.no_grad():
        snac = carry(JSNAC(JSNACConfig.snac_24khz(), seed=SEED % (2**31)),
                     SNAC(SNACConfig.snac_24khz(), device="cpu"))
        audio = fullsize_input(snac.config.sample_rate)
        _, codes = snac.forward(audio)
        got = [c.numpy().ravel() for c in codes]
        want = [g[f"snac/codes/{i}"].ravel() for i in range(len(codes))]
        snac_near = _count_near_ties(got, want, _snac_near_ties(snac, audio),
                                     list(snac.config.vq_strides))
        del snac

        dac = carry(JDAC(JDACConfig.dac_44khz(), seed=SEED % (2**31)),
                    DAC(DACConfig.dac_44khz(), device="cpu"))
        out = dac.forward(fullsize_input(dac.config.sample_rate))
        got = list(out["codes"][0].numpy())
        want = list(g["dac/codes"][0])
        dac_near = _count_near_ties(got, want, _dac_near_ties(dac, out["latents"]),
                                    [1] * len(got))
        np.testing.assert_allclose(out["audio"][0, ::64].numpy(), g["dac/decoded_dec64"],
                                   rtol=1e-3, atol=1e-4)
    print(f"fullsize golden through the port: near-tie codes that differ: SNAC-24k "
          f"{snac_near}, DAC-44k {dac_near}")
