"""Training on one device (counterpart of neuralcodecs_tpu.parallel): the
generator and GAN train steps, their checkpoints and the data pipeline.
The JAX package's mesh, sharding and sequence-parallel modules
(``torch.distributed``) are not ported yet."""

from neuralcodecs_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from neuralcodecs_tpu_torch.parallel.data import AudioCropDataset, find_audio_files, prefetch
from neuralcodecs_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    dac_generator_loss,
    make_gan_train_step,
    make_train_step,
)

__all__ = [
    "AudioCropDataset",
    "TrainState",
    "adamw",
    "dac_generator_loss",
    "find_audio_files",
    "make_gan_train_step",
    "make_train_step",
    "prefetch",
    "restore_train_state",
    "save_train_state",
]
