"""Model loader facade: source string -> ready-to-run model
(counterpart of neuralcodecs_tpu.core.loader).

Resolve a local path | HF repo | GitHub | direct URL, download through the
cache, discover a sibling config.json, build the model through the
registry (extra keyword arguments, such as ``device=``, go to its factory),
load its weights, then run the optional validation gate. A native
``save_pretrained`` export (the port's or the JAX package's) loads through
the model's ``load_native_state_dict``; every other file goes through
``import_checkpoint`` and the model's ``load_upstream_state_dict``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from neuralcodecs_tpu_torch.core.cache import ModelCache
from neuralcodecs_tpu_torch.core.events import EventEmitter, LoadErrorEvent, LoadProgress
from neuralcodecs_tpu_torch.core.exceptions import ConfigurationError, LoadError
from neuralcodecs_tpu_torch.core.export import read_native
from neuralcodecs_tpu_torch.core.files import is_shard_index, is_valid_model_file
from neuralcodecs_tpu_torch.core.importer import import_checkpoint
from neuralcodecs_tpu_torch.core.operations import OperationResult
from neuralcodecs_tpu_torch.core.registry import registry
from neuralcodecs_tpu_torch.core.repos import pick_model_file, repository_for_source
from neuralcodecs_tpu_torch.core.safetensors_io import read_safetensors_metadata


def _pick_weights(candidates: list[Path], root: Path) -> Path:
    """Pick the weights file by the repository preference order (safetensors
    first, then shallowest/shortest path) instead of plain sort order."""
    rel = {str(f.relative_to(root)): f for f in candidates}
    chosen = pick_model_file(list(rel))
    return rel[chosen] if chosen else candidates[0]


@dataclass
class LoadOptions:
    """Counterpart of ModelLoadOptions (Core/Loading/ModelLoadOptions.cs:8)."""

    revision: str = "main"
    validate: bool = False
    cache: bool = True
    config_path: str | None = None


class ModelLoader(EventEmitter):
    """Orchestrates local/remote model loading."""

    def __init__(self, cache: ModelCache | None = None):
        super().__init__()
        self.cache = cache or ModelCache()

    # -- source resolution ---------------------------------------------------

    @staticmethod
    def is_local_path(source: str) -> bool:
        """Mirrors TorchModelLoader.IsLocalPath (TorchModelLoader.cs:125-145)."""
        if source.startswith(("http://", "https://")):
            return False
        p = Path(source)
        if p.exists():
            return True
        # "owner/repo" shorthand → remote; anything with an extension → local
        return p.suffix != "" and not (source.count("/") == 1 and not p.is_absolute())

    def resolve(self, source: str, options: LoadOptions) -> Path:
        """Return a local weights path for the source, downloading if needed."""
        if self.is_local_path(source):
            p = Path(source)
            if p.is_dir():
                candidates = [f for f in sorted(p.iterdir()) if is_valid_model_file(f)]
                if not candidates:
                    raise LoadError(f"No model file found in directory {source}")
                return _pick_weights(candidates, p)
            if not p.is_file():
                raise LoadError(f"Model file not found: {source}")
            return p

        cached = self.cache.get_cached_path(source, options.revision) if options.cache else None
        if cached is None:
            repo = repository_for_source(source)
            self.emit_progress(LoadProgress(source, "download", 0.0, "starting"))
            tmp_dir = self.cache.dir_for(source, options.revision)
            tmp_dir.mkdir(parents=True, exist_ok=True)
            files = repo.download_model(source, options.revision, tmp_dir, self)
            cached = self.cache.cache_model(
                source, options.revision, {name: p for name, p in files.items()}
            )
        weight_files = [f for f in sorted(cached.rglob("*")) if is_valid_model_file(f)]
        if not weight_files:
            self.cache.invalidate(source, options.revision)
            raise LoadError(f"Cached model for {source} has no weight file")
        return _pick_weights(weight_files, cached)

    @staticmethod
    def _is_native_export(weights_path: Path) -> bool:
        """A save_pretrained export: safetensors marked native; for a shard
        index, its first shard carries the marks."""
        if is_shard_index(weights_path):
            try:
                weight_map = json.loads(weights_path.read_text())["weight_map"]
                first = sorted(set(weight_map.values()))[0]
            except Exception:
                return False
            shard = weights_path.parent / first
            if not (shard.is_file() and shard.suffix == ".safetensors"):
                return False
            meta = read_safetensors_metadata(shard)
        elif weights_path.suffix == ".safetensors":
            meta = read_safetensors_metadata(weights_path)
        else:
            return False
        return meta.get("format") == "neuralcodecs-tpu" and \
            meta.get("layout") == "native"

    # -- config discovery ----------------------------------------------------

    @staticmethod
    def find_config(weights_path: Path, explicit: str | None = None) -> Path | None:
        """Find a config JSON next to the weights: <stem>.json first, then
        config.json in the same directory. A shard index is itself a .json,
        so the sibling rule is skipped for it."""
        if explicit is not None:
            p = Path(explicit)
            return p if p.is_file() else None
        if not is_shard_index(weights_path):
            sibling = weights_path.with_suffix(".json")
            if sibling.is_file() and sibling != weights_path:
                return sibling
        generic = weights_path.parent / "config.json"
        if generic.is_file():
            return generic
        return None

    # -- main entry ----------------------------------------------------------

    def load(
        self,
        architecture: str,
        source: str,
        config: Any | None = None,
        options: LoadOptions | None = None,
        **model_kwargs: Any,
    ) -> Any:
        try:
            return self._load(architecture, source, config, options, **model_kwargs)
        except Exception as exc:
            # failures go through the error-event channel before raising
            self.emit_error(LoadErrorEvent(source, exc, fatal=True))
            raise

    def try_load(
        self,
        architecture: str,
        source: str,
        config: Any | None = None,
        options: LoadOptions | None = None,
        **model_kwargs: Any,
    ) -> "OperationResult[Any]":
        """Non-throwing variant: returns an OperationResult success/error
        record, for batch pipelines."""
        try:
            model = self._load(architecture, source, config, options, **model_kwargs)
        except Exception as exc:
            self.emit_error(LoadErrorEvent(source, exc, fatal=True))
            return OperationResult.from_error(exc)
        return OperationResult.from_success(model)

    def _load(
        self,
        architecture: str,
        source: str,
        config: Any | None = None,
        options: LoadOptions | None = None,
        **model_kwargs: Any,
    ) -> Any:
        options = options or LoadOptions()
        entry = registry.get(architecture)

        weights_path = self.resolve(source, options)
        if config is None:
            config_path = self.find_config(weights_path, options.config_path)
            if config_path is not None:
                config = entry.config_cls.from_json(config_path)
            else:
                try:
                    config = entry.config_cls()
                except TypeError as exc:
                    raise ConfigurationError(
                        f"No config found for {source} and {architecture} has no defaults"
                    ) from exc
        elif isinstance(config, dict):
            config = entry.config_cls.from_dict(config)

        self.emit_progress(LoadProgress(source, "weights", 0.0, str(weights_path)))
        model = entry.factory(config, **model_kwargs)
        if self._is_native_export(weights_path):
            # a save_pretrained export: native layouts, loaded bit for bit
            model.load_native_state_dict(read_native(weights_path))
        else:
            model.load_upstream_state_dict(import_checkpoint(weights_path))
        self.emit_progress(LoadProgress(source, "weights", 1.0, "loaded"))

        if options.validate:
            self.emit_progress(LoadProgress(source, "validate", 0.0, ""))
            from neuralcodecs_tpu_torch.core.validation import validate_model

            validate_model(model)
            self.emit_progress(LoadProgress(source, "validate", 1.0, "ok"))
        return model


# ---------------------------------------------------------------------------
# Top-level convenience API (counterpart of the static NeuralCodecs facade)
# ---------------------------------------------------------------------------

def load_model(architecture: str, source: str, config: Any | None = None,
               options: LoadOptions | None = None, **kwargs: Any) -> Any:
    """Load ``architecture`` from ``source``; ``kwargs`` (``device=``,
    ``seed=``) go to the model's factory."""
    return ModelLoader().load(architecture, source, config, options, **kwargs)


def load_snac(source: str, config: Any | None = None,
              options: LoadOptions | None = None, **kwargs: Any):
    """Counterpart of NeuralCodecs.CreateSNACAsync (NeuralCodecs.cs:38)."""
    return load_model("snac", source, config, options, **kwargs)


def load_dac(source: str, config: Any | None = None,
             options: LoadOptions | None = None, **kwargs: Any):
    """Counterpart of NeuralCodecs.CreateDACAsync."""
    return load_model("dac", source, config, options, **kwargs)


def load_encodec(source: str, config: Any | None = None,
                 options: LoadOptions | None = None, **kwargs: Any):
    """Counterpart of NeuralCodecs.CreateEncodecAsync."""
    return load_model("encodec", source, config, options, **kwargs)


def load_dia(source: str, config: Any | None = None,
             options: LoadOptions | None = None, **kwargs: Any):
    """Counterpart of NeuralCodecs.CreateDiaAsync."""
    return load_model("dia", source, config, options, **kwargs)
