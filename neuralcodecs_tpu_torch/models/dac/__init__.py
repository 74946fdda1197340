from neuralcodecs_tpu_torch.models.dac.config import DACConfig
from neuralcodecs_tpu_torch.models.dac.model import DAC

__all__ = ["DAC", "DACConfig"]
