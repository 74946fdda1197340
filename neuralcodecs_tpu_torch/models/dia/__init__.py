from neuralcodecs_tpu_torch.models.dia.config import DiaConfig
from neuralcodecs_tpu_torch.models.dia.model import Dia, release_generation_caches

__all__ = ["Dia", "DiaConfig", "release_generation_caches"]
