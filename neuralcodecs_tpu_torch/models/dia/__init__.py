from neuralcodecs_tpu_torch.models.dia.config import DiaConfig
from neuralcodecs_tpu_torch.models.dia.model import Dia

__all__ = ["Dia", "DiaConfig"]
