"""GAN losses for codec training: LS-GAN and feature matching.

Counterpart of neuralcodecs_tpu.losses.gan. A discriminator's outputs are
a list per sub-discriminator of [feature_0, ..., feature_n, logits], as
``models/dac/discriminator.DACDiscriminator`` returns them.
"""

from __future__ import annotations

from typing import Sequence

import torch

DiscOutputs = Sequence[Sequence[torch.Tensor]]  # per scale: [feat0, ..., logits]


def discriminator_loss(fake_outputs: DiscOutputs, real_outputs: DiscOutputs) -> torch.Tensor:
    """Σ over scales of 0.5 (E[D(fake)²] + E[(1 − D(real))²])."""
    loss = torch.zeros((), device=fake_outputs[0][-1].device)
    for fake, real in zip(fake_outputs, real_outputs):
        loss = loss + 0.5 * (torch.mean(fake[-1] ** 2) + torch.mean((1.0 - real[-1]) ** 2))
    return loss


def generator_loss(fake_outputs: DiscOutputs) -> torch.Tensor:
    """Σ over scales of E[(1 − D(fake))²]."""
    loss = torch.zeros((), device=fake_outputs[0][-1].device)
    for fake in fake_outputs:
        loss = loss + torch.mean((1.0 - fake[-1]) ** 2)
    return loss


def feature_matching_loss(fake_outputs: DiscOutputs, real_outputs: DiscOutputs) -> torch.Tensor:
    """L1 between the intermediate features, the real side detached."""
    loss = torch.zeros((), device=fake_outputs[0][-1].device)
    for fake, real in zip(fake_outputs, real_outputs):
        for f, r in zip(fake[:-1], real[:-1]):
            loss = loss + torch.mean(torch.abs(f - r.detach()))
    return loss
