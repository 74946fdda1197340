from neuralcodecs_tpu_torch.models.encodec.config import EncodecConfig
from neuralcodecs_tpu_torch.models.encodec.model import EncodedFrame, Encodec

__all__ = ["Encodec", "EncodecConfig", "EncodedFrame"]
