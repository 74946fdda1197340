from neuralcodecs_tpu_torch.models.snac.config import SNACConfig
from neuralcodecs_tpu_torch.models.snac.model import SNAC

__all__ = ["SNAC", "SNACConfig"]
