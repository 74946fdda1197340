from neuralcodecs_tpu_torch.models.encodec.config import EncodecConfig
from neuralcodecs_tpu_torch.models.encodec.lm import EncodecLanguageModel, EncodecLMConfig
from neuralcodecs_tpu_torch.models.encodec.model import EncodedFrame, Encodec
from neuralcodecs_tpu_torch.models.encodec.streaming import (
    StreamingDecoder,
    StreamingEncoder,
    stream_roundtrip,
)

__all__ = ["Encodec", "EncodecConfig", "EncodedFrame", "EncodecLanguageModel",
           "EncodecLMConfig", "StreamingEncoder", "StreamingDecoder", "stream_roundtrip"]
