"""Mesh, sharding and distributed training (counterpart of
neuralcodecs_tpu.parallel): (dp, tp, sp) meshes over ``torch.distributed``
processes, the placement rules of data and tensor parallelism, the
generator and GAN train steps on one device or a mesh, their checkpoints,
time-sharded SNAC encode and the data pipeline. The collectives that XLA
inserts in the JAX package are written out in ``collectives``.
"""

from neuralcodecs_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from neuralcodecs_tpu_torch.parallel.data import AudioCropDataset, find_audio_files, prefetch
from neuralcodecs_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    mesh_axes_for,
)
from neuralcodecs_tpu_torch.parallel.sharding import (
    batch_sharding,
    dia_param_shardings,
    param_shardings,
    replicated,
    shard_params,
)
from neuralcodecs_tpu_torch.parallel.timeshard import sharded_encode
from neuralcodecs_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    dac_generator_loss,
    make_gan_train_step,
    make_train_step,
)

__all__ = [
    "make_mesh",
    "mesh_axes_for",
    "param_shardings",
    "batch_sharding",
    "replicated",
    "AudioCropDataset",
    "TrainState",
    "adamw",
    "dac_generator_loss",
    "dia_param_shardings",
    "find_audio_files",
    "initialize_distributed",
    "make_gan_train_step",
    "make_train_step",
    "prefetch",
    "restore_train_state",
    "save_train_state",
    "shard_params",
    "sharded_encode",
]
