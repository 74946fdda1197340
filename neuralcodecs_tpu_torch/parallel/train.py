"""Training steps for DAC, on one device or a (dp, tp, sp) mesh
(counterpart of neuralcodecs_tpu.parallel.train).

``make_train_step`` trains the generator on the reconstruction recipe (L1 +
multi-scale mel + the weighted commitment and codebook losses);
``make_gan_train_step`` adds the discriminator (LS-GAN and feature
matching), in the JAX step's order: the discriminator's update first, on the
detached output of the current generator, then the generator's against the
updated discriminator.

Where the JAX package passes parameter pytrees and optax transformations,
the port keeps the parameters in the ``nn.Module``s and takes optimizer
factories: ``optimizer(params) -> torch.optim.Optimizer``, e.g.
``functools.partial(torch.optim.SGD, lr=0.1)``. The defaults are optax's
``adamw`` (eps 1e-8, weight decay 1e-4, not torch's 1e-2). A step updates
the modules in place and returns the new ``TrainState``. Audio is the JAX
package's [B, T, 1], padded to a multiple of the hop.

``mesh=None`` steps on the device the model is on. With a mesh
(``parallel.mesh.make_mesh``) every rank runs the same step on the global
batch: ``init_fn`` places the parameters by ``param_shardings`` (the tp
slices stored, gathered at use: ``sharding.shard_params``), and the
optimizer's state follows each parameter's slice; ``step_fn`` takes the
rank's dp part of the batch (B must divide by dp), and averages the
gradients, with the loss, over dp before the optimizer steps (one
all-reduce). JAX takes the mean loss over the global batch; the mean of
the dp ranks' local means is the same in exact arithmetic for equal
shards, and differs by f32 summation order.

In grad mode the model's residual units run the dense kernel's training form
and its backward on the card (``ops/kernels/resunit.DenseResidualUnitFn``),
the RVQ stages the codebook kernel (no gradient: straight-through).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
import torch.utils.checkpoint
from torch import nn

from neuralcodecs_tpu_torch.losses.audio import l1_loss, mel_spectrogram_loss
from neuralcodecs_tpu_torch.losses.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_loss,
)
from neuralcodecs_tpu_torch.parallel import collectives
from neuralcodecs_tpu_torch.parallel.mesh import axis_rank, axis_size, mesh_device
from neuralcodecs_tpu_torch.parallel.sharding import (
    canonical_params,
    param_shardings,
    shard_params,
)

OptimizerFactory = Callable[..., torch.optim.Optimizer]


def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """optax.adamw's defaults as a factory of ``torch.optim.AdamW``."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


@dataclass
class TrainState:
    """``params``: the module's parameters by name (live: the step updates
    them in place); ``opt_state``: the optimizer, which holds its state;
    ``step``: steps taken. On a mesh, ``params`` holds this rank's slices
    under the unsharded names, ``placements`` each one's placement, and
    ``mesh`` the mesh."""

    params: dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: int
    mesh: object = None
    placements: dict | None = None


def channels_first(audio: torch.Tensor) -> torch.Tensor:
    """[B, T, 1] -> [B, 1, T] with row-major strides. (A transposed view has
    strides that the convolutions read as channels-last, and the residual
    units would then receive non-contiguous activations.)"""
    return audio[..., 0].unsqueeze(1).contiguous()


def _init_state(module: nn.Module, optimizer: OptimizerFactory, mesh=None) -> TrainState:
    """The state over ``module``'s parameters; with a mesh, after sharding
    them (once: a module is sharded by one state only)."""
    if mesh is None:
        return TrainState(dict(module.named_parameters()), optimizer(module.parameters()), 0)
    if any(torch.nn.utils.parametrize.is_parametrized(m) for m in module.modules()):
        raise ValueError("the module is sharded already: make one state per module")
    order = [name for name, _ in module.named_parameters()]
    placements = param_shardings(mesh, module)
    shard_params(mesh, module, placements)
    params = canonical_params(module, order)
    # the optimizer sees the parameters in the unsharded order, so its
    # state's indices are those of a one-device state
    return TrainState(params, optimizer(list(params.values())), 0, mesh,
                      {name: placements[name] for name in order})


def local_batch(audio: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dp part of the global batch [B, ...], on its device."""
    dp, rank = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    b = audio.shape[0]
    if b % dp:
        raise ValueError(f"batch {b} does not divide over dp={dp}")
    n = b // dp
    return audio[rank * n:(rank + 1) * n].to(mesh_device(mesh))


def _dp_mean(params, mesh, values: torch.Tensor) -> torch.Tensor:
    """Average the gradients of ``params`` and ``values`` over dp, in one
    all-reduce; returns the averaged values."""
    return collectives.mean_grads_(params, mesh.get_group("dp"), values)


def _reconstruction(model, out: dict, audio: torch.Tensor, sample_rate: int,
                    mel_windows=(512, 128), mel_bins=(80, 20)) -> dict[str, torch.Tensor]:
    """L1 and multi-scale mel of ``out["audio"]`` [B, 1, T] against ``audio``
    [B, 1, T], and the weighted VQ losses' sum."""
    cfg = model.config
    return {"recon": l1_loss(out["audio"], audio),
            "mel": mel_spectrogram_loss(out["audio"][:, 0], audio[:, 0], sample_rate,
                                        n_mels=mel_bins, window_lengths=mel_windows),
            "vq": (cfg.commitment_loss_weight * out["vq/commitment_loss"]
                   + cfg.codebook_loss_weight * out["vq/codebook_loss"])}


def dac_generator_loss(model, audio: torch.Tensor, sample_rate: int,
                       mel_windows: tuple[int, ...] = (512, 128),
                       mel_bins: tuple[int, ...] = (80, 20)) -> torch.Tensor:
    """Generator loss: L1 + multi-scale mel + weighted VQ losses.

    audio: [B, T, 1] channels-last, already padded to hop multiples."""
    x = channels_first(audio)
    parts = _reconstruction(model, model._forward_fn(x, None), x, sample_rate, mel_windows,
                            mel_bins)
    return parts["recon"] + parts["mel"] + parts["vq"]


def make_train_step(model, mesh=None, optimizer: OptimizerFactory | None = None,
                    sample_rate: int | None = None,
                    loss_fn: Callable[..., torch.Tensor] | None = None,
                    remat: bool = False):
    """(init_fn, step_fn) for the generator.

    init_fn() -> TrainState over the model's parameters (sharded over
    ``mesh`` when one is given); step_fn(state, audio [B, T, 1]) -> (state,
    loss), with a mesh the global batch and the dp-mean loss. ``loss_fn(model,
    audio)`` defaults to ``dac_generator_loss``. ``remat=True`` runs the loss
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward instead of kept."""
    optimizer = optimizer or adamw()
    sample_rate = sample_rate or model.config.sample_rate
    loss = loss_fn or (lambda m, a: dac_generator_loss(m, a, sample_rate))
    if remat:
        inner = loss
        loss = lambda m, a: torch.utils.checkpoint.checkpoint(inner, m, a, use_reentrant=False)

    def init_fn() -> TrainState:
        return _init_state(model, optimizer, mesh)

    def step_fn(state: TrainState, audio: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if mesh is not None:
            audio = local_batch(audio, mesh)
        with torch.enable_grad():
            loss_val = loss(model, audio)
            loss_val.backward()
        loss_val = loss_val.detach()
        if mesh is not None:
            loss_val = _dp_mean(state.params.values(), mesh, loss_val)
        opt.step()
        return (TrainState(state.params, opt, state.step + 1, state.mesh, state.placements),
                loss_val)

    return init_fn, step_fn


def make_gan_train_step(model, discriminator, mesh=None,
                        gen_optimizer: OptimizerFactory | None = None,
                        disc_optimizer: OptimizerFactory | None = None,
                        sample_rate: int | None = None, adv_weight: float = 1.0,
                        feat_weight: float = 2.0):
    """Adversarial codec training (generator + discriminator).

    Returns (init_fn, step_fn): init_fn() -> (gen_state, disc_state);
    step_fn((gen_state, disc_state), audio [B, T, 1]) -> ((gen_state,
    disc_state), metrics) with the JAX step's keys ``gen/total``,
    ``gen/mel``, ``gen/adv``, ``gen/feat``, ``gen/recon`` and
    ``disc/total``. With a ``mesh`` both modules are sharded, each update's
    gradients are dp-averaged before its optimizer steps, and the metrics
    are the dp means.

    One generator forward serves both updates: the parameters it reads do
    not change between them, so its detached output is the discriminator's
    fake and its graph the generator's loss, the values of the JAX step's
    two forwards. The generator's gradient is taken over its own parameters
    only (``torch.autograd.grad``), so the discriminator keeps the gradient
    of its own update and is stepped once."""
    gen_optimizer = gen_optimizer or adamw(b1=0.8, b2=0.99)
    disc_optimizer = disc_optimizer or adamw(b1=0.8, b2=0.99)
    sample_rate = sample_rate or model.config.sample_rate

    def init_fn() -> tuple[TrainState, TrainState]:
        return (_init_state(model, gen_optimizer, mesh),
                _init_state(discriminator, disc_optimizer, mesh))

    def step_fn(states, audio: torch.Tensor):
        gen_state, disc_state = states
        g_opt, d_opt = gen_state.opt_state, disc_state.opt_state
        if mesh is not None:
            audio = local_batch(audio, mesh)
        x = channels_first(audio)
        real = x[:, 0]
        with torch.enable_grad():
            out = model._forward_fn(x, None)
            fake = out["audio"][:, 0]
            # the discriminator's update, on the detached fake
            d_opt.zero_grad(set_to_none=True)
            d_loss = discriminator_loss(discriminator(fake.detach()), discriminator(real))
            d_loss.backward()
            if mesh is not None:
                d_loss = _dp_mean(disc_state.params.values(), mesh, d_loss.detach())
            d_opt.step()
            # the generator's, against the updated discriminator; the real
            # side's features enter detached, its logits not at all
            fake_out = discriminator(fake)
            with torch.no_grad():
                real_out = discriminator(real)
            parts = _reconstruction(model, out, x, sample_rate)
            adv = generator_loss(fake_out)
            feat = feature_matching_loss(fake_out, real_out)
            total = (parts["recon"] + parts["mel"] + adv_weight * adv + feat_weight * feat
                     + parts["vq"])
            g_params = [p for p in model.parameters() if p.requires_grad]
            grads = torch.autograd.grad(total, g_params)
        for p, g in zip(g_params, grads):
            p.grad = g
        metrics = {"gen/total": total, "gen/mel": parts["mel"], "gen/adv": adv,
                   "gen/feat": feat, "gen/recon": parts["recon"]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            means = _dp_mean(g_params, mesh, torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, means.unbind()))
        g_opt.step()
        step = gen_state.step + 1
        metrics["disc/total"] = d_loss.detach()
        return ((TrainState(gen_state.params, g_opt, step, gen_state.mesh,
                            gen_state.placements),
                 TrainState(disc_state.params, d_opt, step, disc_state.mesh,
                            disc_state.placements)),
                metrics)

    return init_fn, step_fn
