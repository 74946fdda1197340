"""On-disk model cache (copy of neuralcodecs_tpu.core.cache).

Layout ``<root>/<model_id>/<revision>/`` plus a ``cache_meta.json`` with
SHA-256 per file and a max-age TTL (30 days by default). The default root is
``~/.cache/neural_codecs/torch``; ``NEURALCODECS_CACHE`` overrides it, and
with it set the JAX package and the port share one cache.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass, field, asdict
from pathlib import Path

from neuralcodecs_tpu_torch.core.exceptions import CacheError
from neuralcodecs_tpu_torch.core.files import file_sha256, safe_child_path

_META_FILE = "cache_meta.json"
DEFAULT_TTL_SECONDS = 30 * 24 * 3600

# Files whose SHA-256 has been fully verified during THIS process. The
# mtime fast path below never applies to the first load in a process, so
# mtime-preserving tampering (os.utime, copy2-style replaces) and silent
# bit-rot are caught at least once per process.
_verified_this_process: set[tuple[str, str]] = set()


def default_cache_root() -> Path:
    env = os.environ.get("NEURALCODECS_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "neural_codecs" / "torch"


@dataclass
class CachedFile:
    name: str
    sha256: str
    size: int
    mtime: float = 0.0  # st_mtime at hash time; lets loads skip re-hashing


@dataclass
class CacheMetadata:
    model_id: str
    revision: str
    timestamp: float
    files: list[CachedFile] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "CacheMetadata":
        data = json.loads(text)
        files = [CachedFile(**f) for f in data.pop("files", [])]
        return cls(files=files, **{k: data[k] for k in ("model_id", "revision", "timestamp")})


def _sanitize(part: str) -> str:
    return part.replace("/", "--").replace("\\", "--").replace(":", "_")


class ModelCache:
    """Filesystem cache keyed by (model_id, revision)."""

    def __init__(self, root: str | Path | None = None, ttl: float = DEFAULT_TTL_SECONDS):
        self.root = Path(root) if root is not None else default_cache_root()
        self.ttl = ttl

    def dir_for(self, model_id: str, revision: str = "main") -> Path:
        return self.root / _sanitize(model_id) / _sanitize(revision)

    def get_cached_path(self, model_id: str, revision: str = "main") -> Path | None:
        """Return the cached model directory if present, validated, and fresh."""
        d = self.dir_for(model_id, revision)
        meta_path = d / _META_FILE
        if not meta_path.is_file():
            return None
        try:
            meta = CacheMetadata.from_json(meta_path.read_text())
        except (json.JSONDecodeError, KeyError, TypeError):
            self.invalidate(model_id, revision)
            return None
        if self.ttl > 0 and (time.time() - meta.timestamp) > self.ttl:
            return None
        meta_dirty = False
        for f in meta.files:
            p = d / f.name
            if not p.is_file():
                self.invalidate(model_id, revision)
                return None
            st = p.stat()
            if st.st_size != f.size:
                self.invalidate(model_id, revision)
                return None
            # Integrity check: a tampered same-size file must not
            # pass validation — cache_meta.json stores a SHA-256 per file.
            # Hashing a multi-hundred-MB checkpoint on EVERY load is too
            # slow for the hot path, so after one full verification in this
            # process, repeat loads skip re-hashing while size+mtime match
            # the values recorded at hash time. mtime alone is NOT trusted
            # across processes: the first load of a file in any process
            # always pays the full hash.
            key = (str(p.resolve()), f.sha256)
            if f.sha256 and (
                key not in _verified_this_process or st.st_mtime != f.mtime
            ):
                if file_sha256(p) != f.sha256:
                    self.invalidate(model_id, revision)
                    _verified_this_process.discard(key)
                    return None
                _verified_this_process.add(key)
                if st.st_mtime != f.mtime:
                    f.mtime = st.st_mtime
                    meta_dirty = True
        if meta_dirty:
            meta_path.write_text(meta.to_json())
        return d

    def cache_model(
        self, model_id: str, revision: str, files: dict[str, Path]
    ) -> Path:
        """Move downloaded files into the cache and write integrity metadata.

        ``files`` maps the cached file name to its current (temp) location.
        """
        d = self.dir_for(model_id, revision)
        d.mkdir(parents=True, exist_ok=True)
        cached: list[CachedFile] = []
        for name, src in files.items():
            src = Path(src)
            if not src.is_file():
                raise CacheError(f"Cannot cache missing file {src}")
            # Names may originate from remote repo listings; never let them
            # escape the cache directory.
            try:
                dst = safe_child_path(d, name)
            except ValueError as exc:
                raise CacheError(f"Unsafe cache file name {name!r}") from exc
            dst.parent.mkdir(parents=True, exist_ok=True)
            if src.resolve() != dst.resolve():
                shutil.copy2(src, dst)
            st = dst.stat()
            cached.append(
                CachedFile(name=name, sha256=file_sha256(dst), size=st.st_size,
                           mtime=st.st_mtime)
            )
        meta = CacheMetadata(
            model_id=model_id, revision=revision, timestamp=time.time(), files=cached
        )
        (d / _META_FILE).write_text(meta.to_json())
        return d

    def invalidate(self, model_id: str, revision: str | None = None) -> None:
        base = self.root / _sanitize(model_id)
        target = base / _sanitize(revision) if revision else base
        if target.exists():
            shutil.rmtree(target, ignore_errors=True)

    def clear(self) -> None:
        if self.root.exists():
            shutil.rmtree(self.root, ignore_errors=True)
