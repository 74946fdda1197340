"""The device the port's entry points run on when the caller names none."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The caller's device, else "cuda". With no device given and no CUDA
    device present this raises: nothing falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_audio(audio) -> torch.Tensor:
    """``audio`` as an f32 tensor: a tensor keeps its device, anything else
    (a numpy array, a list) goes to ``resolve_device(None)``, as
    ``jnp.asarray`` puts it on the default accelerator in the JAX package."""
    if isinstance(audio, torch.Tensor):
        return audio.to(torch.float32)
    return torch.as_tensor(audio, dtype=torch.float32, device=resolve_device())
