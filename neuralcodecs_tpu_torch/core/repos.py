"""Remote model repositories: HuggingFace Hub, GitHub, direct URLs (copy of
neuralcodecs_tpu.core.repos).

Resolve a source string to model + config files, download with
progress/retry, detect Git-LFS pointer files masquerading as weights. Uses
stdlib urllib so the package has no network-library dependency; all
downloads go through `ModelCache`.
"""

from __future__ import annotations

import json
import re
import tempfile
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Protocol

from neuralcodecs_tpu_torch.core.events import EventEmitter, LoadProgress
from neuralcodecs_tpu_torch.core.exceptions import RepositoryError
from neuralcodecs_tpu_torch.core.files import is_shard_index, safe_child_path
from neuralcodecs_tpu_torch.core.retry import with_retry

_WEIGHT_EXTS = (".safetensors", ".pt", ".pth", ".ckpt", ".bin", ".npz")
_USER_AGENT = "neuralcodecs-tpu/0.1"


@dataclass(frozen=True)
class ModelInfo:
    model_id: str
    revision: str
    files: list[str] = field(default_factory=list)


class ModelRepository(Protocol):
    def get_model_info(self, source: str, revision: str) -> ModelInfo: ...

    def download_model(
        self, source: str, revision: str, dest: Path, events: EventEmitter | None = None
    ) -> dict[str, Path]:
        """Download model + config files into dest; return {name: path}."""
        ...


def _http_get(url: str, headers: dict[str, str] | None = None) -> bytes:
    req = urllib.request.Request(url, headers={"User-Agent": _USER_AGENT, **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def _http_post_json(url: str, payload: dict,
                    headers: dict[str, str] | None = None) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"User-Agent": _USER_AGENT, **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _download_file(
    url: str,
    dest: Path,
    events: EventEmitter | None = None,
    source: str = "",
) -> Path:
    def fetch() -> Path:
        req = urllib.request.Request(url, headers={"User-Agent": _USER_AGENT})
        with urllib.request.urlopen(req, timeout=300) as resp:
            total = int(resp.headers.get("Content-Length") or 0)
            read = 0
            dest.parent.mkdir(parents=True, exist_ok=True)
            with open(dest, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    read += len(chunk)
                    if events is not None and total:
                        events.emit_progress(
                            LoadProgress(source, "download", read / total, dest.name)
                        )
        return dest

    return with_retry(fetch)


def safe_join(dest: Path, name: str) -> Path:
    """Join a remote-controlled file name under dest, rejecting traversal.

    HF 'siblings' rfilenames and GitHub contents paths come from untrusted
    repo listings: a listing entry like
    '../../../.bashrc.pt' must not escape the download/cache directory.
    Policy lives in core.files.safe_child_path (shared with the cache).
    """
    try:
        return safe_child_path(dest, name)
    except ValueError as exc:
        raise RepositoryError(str(exc)) from exc


def is_lfs_pointer(path: Path) -> bool:
    """Detect a Git-LFS pointer file downloaded instead of real weights.

    Mirrors the validation in the reference's HuggingFaceRepository
    (HuggingFaceRepository.cs:280-353).
    """
    try:
        if path.stat().st_size > 1024:
            return False
        head = path.read_bytes()
    except OSError:
        return False
    return head.startswith(b"version https://git-lfs.github.com/spec/")


def _validate_weights(files: dict[str, Path]) -> None:
    for name, p in files.items():
        if name.endswith(_WEIGHT_EXTS) and is_lfs_pointer(p):
            raise RepositoryError(
                f"Downloaded file {name} is a Git-LFS pointer, not real weights"
            )


def parse_lfs_pointer(path: Path) -> tuple[str, int]:
    """Parse a Git-LFS pointer file -> (sha256 oid hex, media byte size).

    Pointer format (git-lfs spec v1, what GitHubRepository.cs:469-476
    extracts): `version`, `oid sha256:<hex>`, `size <n>` lines."""
    oid: str | None = None
    size: int | None = None
    try:
        text = path.read_text(errors="replace")
    except OSError as exc:
        raise RepositoryError(f"Cannot read LFS pointer {path.name}") from exc
    for line in text.splitlines():
        if line.startswith("oid sha256:"):
            oid = line.split("sha256:", 1)[1].strip()
        elif line.startswith("size "):
            try:
                size = int(line.split()[1])
            except (IndexError, ValueError):
                pass
    if not oid or not re.fullmatch(r"[0-9a-f]{64}", oid) or size is None \
            or size < 0:
        raise RepositoryError(f"Malformed LFS pointer {path.name}")
    return oid, size


def pick_model_file(names: list[str]) -> str | None:
    """Choose the weights file from a repo listing.

    Safety-first ordering: a ``.safetensors.index.json``
    beats everything; a complete single ``.safetensors`` file beats a
    pickle-based ``.bin``/``.pt`` shard index (never download pickles when
    a safe-format alternative exists); pickle shard indices beat loose
    pickle files only because the sharded checkpoint is the complete one.
    """
    def _best(pool: list[str]) -> str:
        return sorted(pool, key=lambda n: (n.count("/"), len(n)))[0]

    indices = [n for n in names if is_shard_index(n)]
    st_indices = [n for n in indices if n.endswith(".safetensors.index.json")]
    if st_indices:
        return _best(st_indices)
    # a shard PIECE (model-00001-of-00002.safetensors) is not a complete
    # checkpoint — it must never be picked as a standalone file
    piece = re.compile(r"-\d+-of-(\d+)\.")
    by_ext: dict[str, list[str]] = {}
    for n in names:
        m = piece.search(n)
        # an ...-of-00001 "shard" IS the complete checkpoint (single-shard
        # uploads sometimes ship without the index file) — only multi-piece
        # fragments are excluded
        if m and int(m.group(1)) > 1:
            continue
        for ext in _WEIGHT_EXTS:
            if n.lower().endswith(ext):
                by_ext.setdefault(ext, []).append(n)
    if by_ext.get(".safetensors"):
        return _best(by_ext[".safetensors"])
    if indices:
        return _best(indices)
    for ext in _WEIGHT_EXTS:
        if by_ext.get(ext):
            # prefer top-level, shortest path
            return sorted(by_ext[ext], key=lambda n: (n.count("/"), len(n)))[0]
    return None


def shard_names_from_index(index_path: Path, remote_dir: str) -> list[str]:
    """Remote paths of the shards a downloaded index file references."""
    try:
        weight_map = json.loads(index_path.read_text())["weight_map"]
    except (json.JSONDecodeError, KeyError, TypeError) as exc:
        raise RepositoryError(
            f"Malformed shard index {index_path.name}") from exc
    shards = sorted(set(weight_map.values()))
    return [f"{remote_dir}/{s}" if remote_dir else s for s in shards]


def pick_config_file(names: list[str]) -> str | None:
    jsons = [n for n in names if n.lower().endswith(".json")]
    for preferred in ("config.json",):
        for n in jsons:
            if n.split("/")[-1] == preferred:
                return n
    return jsons[0] if jsons else None


class HuggingFaceRepository:
    """HF Hub: list files via the models API, download via /resolve URLs."""

    API = "https://huggingface.co/api/models/{repo}/revision/{rev}"
    RESOLVE = "https://huggingface.co/{repo}/resolve/{rev}/{file}"

    def get_model_info(self, source: str, revision: str = "main") -> ModelInfo:
        try:
            raw = _http_get(self.API.format(repo=source, rev=revision))
            data = json.loads(raw)
        except Exception as exc:  # network / JSON errors
            raise RepositoryError(f"HF Hub query failed for {source}", source) from exc
        files = [s["rfilename"] for s in data.get("siblings", [])]
        return ModelInfo(model_id=source, revision=data.get("sha", revision), files=files)

    def download_model(
        self, source: str, revision: str, dest: Path, events: EventEmitter | None = None
    ) -> dict[str, Path]:
        info = self.get_model_info(source, revision)
        model_file = pick_model_file(info.files)
        if model_file is None:
            raise RepositoryError(f"No weight file found in {source}", source)
        config_file = pick_config_file(info.files)
        out: dict[str, Path] = {}
        for name in filter(None, [model_file, config_file]):
            url = self.RESOLVE.format(repo=source, rev=revision, file=name)
            out[name] = _download_file(url, safe_join(dest, name), events, source)
        if is_shard_index(model_file):
            remote_dir = "/".join(model_file.split("/")[:-1])
            for shard in shard_names_from_index(out[model_file], remote_dir):
                url = self.RESOLVE.format(repo=source, rev=revision, file=shard)
                out[shard] = _download_file(url, safe_join(dest, shard),
                                            events, source)
        _validate_weights(out)
        return out


class GitHubRepository:
    """GitHub releases/raw-content downloads; revision maps to a tag/branch."""

    _URL_RE = re.compile(
        r"github\.com/(?P<owner>[^/]+)/(?P<repo>[^/]+)"
        r"(?:/(?:releases/download/(?P<tag>[^/]+)|raw/(?P<branch>[^/]+))/(?P<path>.+))?"
    )
    API_CONTENTS = "https://api.github.com/repos/{owner}/{repo}/contents?ref={rev}"
    API_RELEASE = "https://api.github.com/repos/{owner}/{repo}/releases/tags/{tag}"
    API_LATEST = "https://api.github.com/repos/{owner}/{repo}/releases/latest"
    LFS_BATCH = "https://github.com/{owner}/{repo}.git/info/lfs/objects/batch"

    @staticmethod
    def _api_json(url: str, source: str):
        """GitHub API GET with a rate-limit-aware error (the reference
        surfaces rate limiting explicitly, GitHubRepository.cs:22-705)."""
        try:
            return json.loads(_http_get(url, {"Accept": "application/vnd.github+json"}))
        except urllib.error.HTTPError as exc:
            if exc.code in (403, 429) and \
                    exc.headers.get("x-ratelimit-remaining") == "0":
                reset = exc.headers.get("x-ratelimit-reset", "?")
                raise RepositoryError(
                    f"GitHub API rate limit exceeded for {source} "
                    f"(resets at epoch {reset})", source) from exc
            raise RepositoryError(f"GitHub query failed for {source} "
                                  f"(HTTP {exc.code})", source) from exc
        except Exception as exc:
            raise RepositoryError(f"GitHub query failed for {source}", source) from exc

    def _release_assets(self, owner: str, repo: str, revision: str,
                        source: str) -> list[dict]:
        """List release assets for a tag (or the latest release)."""
        url = (self.API_LATEST.format(owner=owner, repo=repo)
               if revision in ("main", "master", "latest")
               else self.API_RELEASE.format(owner=owner, repo=repo, tag=revision))
        try:
            release = self._api_json(url, source)
        except RepositoryError:
            return []
        return release.get("assets", []) or []

    def _resolve_lfs_media(self, owner: str, repo: str,
                           files: dict[str, Path], source: str,
                           events: EventEmitter | None = None) -> None:
        """Replace downloaded Git-LFS pointer files with their media objects.

        Counterpart of GitHubRepository.cs:460-499 (DownloadLfsFile): parse
        the pointer's oid/size, POST the git-lfs batch API
        (`.git/info/lfs/objects/batch`, operation=download), follow the
        returned `actions.download.href`, then verify the media against the
        pointer's sha256 oid and size — the href comes from an untrusted
        response, so integrity is checked before the file is accepted."""
        import hashlib

        for name, path in files.items():
            if not (name.endswith(_WEIGHT_EXTS) and is_lfs_pointer(path)):
                continue
            oid, size = parse_lfs_pointer(path)
            try:
                result = _http_post_json(
                    self.LFS_BATCH.format(owner=owner, repo=repo),
                    {"operation": "download", "transfers": ["basic"],
                     "objects": [{"oid": oid, "size": size}]},
                    {"Accept": "application/vnd.git-lfs+json",
                     "Content-Type": "application/vnd.git-lfs+json"},
                )
                obj = result["objects"][0]
                if "error" in obj:
                    raise RepositoryError(
                        f"LFS object {oid[:12]} for {name}: "
                        f"{obj['error'].get('message', 'unavailable')}", source)
                href = obj["actions"]["download"]["href"]
                # the href is attacker-influenced data from a parsed
                # response; never let it downgrade to http:// or pivot to a
                # local scheme (file:// would make urlopen read local files)
                if not isinstance(href, str) or not href.startswith("https://"):
                    raise RepositoryError(
                        f"LFS media href for {name} is not https: {href!r}",
                        source)
            except RepositoryError:
                raise
            except Exception as exc:
                raise RepositoryError(
                    f"LFS batch resolution failed for {name} in {source}",
                    source) from exc
            _download_file(href, path, events, source)
            digest = hashlib.sha256()
            actual = 0
            with open(path, "rb") as f:
                while chunk := f.read(1 << 20):
                    digest.update(chunk)
                    actual += len(chunk)
            if actual != size or digest.hexdigest() != oid:
                path.unlink(missing_ok=True)
                raise RepositoryError(
                    f"LFS media for {name} failed verification "
                    f"(size {actual} vs {size}, sha256 mismatch={digest.hexdigest() != oid})",
                    source)

    def get_model_info(self, source: str, revision: str = "main") -> ModelInfo:
        m = self._URL_RE.search(source)
        if not m:
            raise RepositoryError(f"Not a GitHub source: {source}", source)
        owner, repo = m.group("owner"), m.group("repo")
        if m.group("path"):
            return ModelInfo(f"{owner}/{repo}", m.group("tag") or m.group("branch") or revision,
                             [m.group("path")])
        listing = self._api_json(
            self.API_CONTENTS.format(owner=owner, repo=repo, rev=revision), source)
        files = [e["path"] for e in listing if e.get("type") == "file"]
        return ModelInfo(f"{owner}/{repo}", revision, files)

    def download_model(
        self, source: str, revision: str, dest: Path, events: EventEmitter | None = None
    ) -> dict[str, Path]:
        m = self._URL_RE.search(source)
        if m and m.group("path"):
            # direct release-asset / raw URL
            name = Path(m.group("path")).name
            out = {name: _download_file(source, safe_join(dest, name), events, source)}
            self._resolve_lfs_media(m.group("owner"), m.group("repo"), out,
                                    source, events)
            _validate_weights(out)
            return out
        info = self.get_model_info(source, revision)
        model_file = pick_model_file(info.files)
        if model_file is None and m:
            # weights are often attached as release assets rather than
            # committed (LFS-free repos); fall back to the releases API
            assets = self._release_assets(m.group("owner"), m.group("repo"),
                                          revision, source)
            asset_names = [a.get("name", "") for a in assets]
            model_file = pick_model_file(asset_names)
            if model_file is not None:
                by_name = {a.get("name", ""): a for a in assets}
                config_file = pick_config_file(asset_names)
                out = {}

                def fetch_asset(name: str) -> Path:
                    url = by_name.get(name, {}).get("browser_download_url")
                    if not url:
                        raise RepositoryError(
                            f"Release asset {name} in {source} has no "
                            "download URL (draft or expired asset?)", source)
                    return _download_file(url, safe_join(dest, name),
                                          events, source)

                for name in filter(None, [model_file, config_file]):
                    out[name] = fetch_asset(name)
                if is_shard_index(model_file):
                    for shard in shard_names_from_index(out[model_file], ""):
                        out[shard] = fetch_asset(shard)
                _validate_weights(out)
                return out
        if model_file is None:
            raise RepositoryError(f"No weight file found in {source}", source)
        config_file = pick_config_file(info.files)
        owner_repo = info.model_id
        out = {}

        def raw_url(name: str) -> str:
            return (f"https://raw.githubusercontent.com/{owner_repo}/"
                    f"{info.revision}/{name}")

        for name in filter(None, [model_file, config_file]):
            out[name] = _download_file(raw_url(name), safe_join(dest, name),
                                       events, source)
        if is_shard_index(model_file):
            remote_dir = "/".join(model_file.split("/")[:-1])
            for shard in shard_names_from_index(out[model_file], remote_dir):
                out[shard] = _download_file(raw_url(shard),
                                            safe_join(dest, shard),
                                            events, source)
        # raw.githubusercontent.com serves LFS-tracked weights as pointer
        # files; resolve them to their media objects (GitHubRepository.cs
        # DownloadLfsFile) before validation
        owner, repo = owner_repo.split("/", 1)
        self._resolve_lfs_media(owner, repo, out, source, events)
        _validate_weights(out)
        return out


class DirectUrlRepository:
    """A bare URL pointing straight at a weights file (e.g. the Encodec LM
    checkpoints on dl.fbaipublicfiles.com, reference DirectUrlRepository.cs)."""

    def get_model_info(self, source: str, revision: str = "main") -> ModelInfo:
        name = Path(urllib.parse.urlparse(source).path).name or "model.bin"
        return ModelInfo(model_id=source, revision=revision, files=[name])

    def download_model(
        self, source: str, revision: str, dest: Path, events: EventEmitter | None = None
    ) -> dict[str, Path]:
        name = Path(urllib.parse.urlparse(source).path).name or "model.bin"
        out = {name: _download_file(source, safe_join(dest, name), events, source)}
        _validate_weights(out)
        return out


def repository_for_source(source: str) -> ModelRepository:
    """Pick a repository backend from the source string.

    Mirrors TorchModelLoader.GetRepositoryForSource (TorchModelLoader.cs:457).
    """
    if "github.com" in source:
        return GitHubRepository()
    if source.startswith(("http://", "https://")):
        return DirectUrlRepository()
    # "owner/repo" shorthand -> HF Hub
    return HuggingFaceRepository()


def download_to_temp(source: str, revision: str = "main",
                     events: EventEmitter | None = None) -> dict[str, Path]:
    repo = repository_for_source(source)
    tmp = Path(tempfile.mkdtemp(prefix="nc_download_"))
    return repo.download_model(source, revision, tmp, events)
