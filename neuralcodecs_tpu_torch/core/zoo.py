"""Known pretrained model sources (copy of neuralcodecs_tpu.core.zoo).

``load_zoo_model("snac_24khz")`` resolves the well-known id to
(architecture, source, preset config) over the port's config presets and
loads it through the standard loader.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from neuralcodecs_tpu_torch.core.exceptions import ConfigurationError


@dataclass(frozen=True)
class ZooEntry:
    architecture: str
    source: str
    config_factory: Callable[[], Any] | None = None


def _registry() -> dict[str, ZooEntry]:
    from neuralcodecs_tpu_torch.models.dac.config import DACConfig
    from neuralcodecs_tpu_torch.models.dia.config import DiaConfig
    from neuralcodecs_tpu_torch.models.encodec.config import EncodecConfig
    from neuralcodecs_tpu_torch.models.snac.config import SNACConfig

    return {
        # SNAC (hubertsiuzdak)
        "snac_24khz": ZooEntry("snac", "hubertsiuzdak/snac_24khz",
                               SNACConfig.snac_24khz),
        "snac_32khz": ZooEntry("snac", "hubertsiuzdak/snac_32khz",
                               SNACConfig.snac_32khz),
        "snac_44khz": ZooEntry("snac", "hubertsiuzdak/snac_44khz",
                               SNACConfig.snac_44khz),
        # DAC (descript)
        "dac_44khz": ZooEntry("dac", "descript/dac_44khz", DACConfig.dac_44khz),
        "dac_24khz": ZooEntry("dac", "descript/dac_24khz", DACConfig.dac_24khz),
        "dac_16khz": ZooEntry("dac", "descript/dac_16khz", DACConfig.dac_16khz),
        # Encodec (facebook)
        "encodec_24khz": ZooEntry("encodec", "facebook/encodec_24khz",
                                  EncodecConfig.encodec_24khz),
        "encodec_48khz": ZooEntry("encodec", "facebook/encodec_48khz",
                                  EncodecConfig.encodec_48khz),
        # Dia (nari-labs)
        "dia_1.6b": ZooEntry("dia", "nari-labs/Dia-1.6B", DiaConfig),
    }


def zoo_models() -> list[str]:
    return sorted(_registry())


def load_zoo_model(name: str, **kwargs):
    """Resolve a well-known model id and load it through the standard
    loader; ``kwargs`` (``options=``, ``device=``) go to ``load_model``."""
    entry = _registry().get(name.lower())
    if entry is None:
        raise ConfigurationError(
            f"Unknown zoo model '{name}'. Known: {zoo_models()}")
    from neuralcodecs_tpu_torch.core.loader import load_model

    config = entry.config_factory() if entry.config_factory else None
    return load_model(entry.architecture, entry.source, config, **kwargs)
