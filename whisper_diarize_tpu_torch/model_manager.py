"""Model asset management: HuggingFace-style cache with progress + cancel.

The PyTorch port's own copy of `whisper_diarize_tpu/model_manager.py`;
the port imports nothing of the JAX package.

Re-implements the reference's `src/model_manager.rs` (800 LoC; behavior
table in SURVEY.md §2.3) for the PyTorch port:

* HF cache layout `models--{owner}--{repo}/snapshots/{rev}/{file}` with a
  content-addressed `blobs/` store and symlinks (`model_manager.rs:586-591`),
* single-flight downloads: starting a new download cancels the previous one
  via a global generation counter + cancellation token
  (`model_manager.rs:13-17,532-546`),
* staged progress mapping bytes -> `offset + frac * scale` percent
  (`model_manager.rs:20-127`), suppressed after cancel/supersede,
* validation: resolve symlink, >= 100 KB, readable first 16 bytes; on
  failure delete and retry the download exactly once
  (`model_manager.rs:634-655,752-768`),
* delete = remove the symlink only, keep the blob for re-download reuse;
  error when nothing matched (`model_manager.rs:353-391`),
* `cleanup_orphaned_blobs` (blobs unreferenced by any snapshot symlink,
  `model_manager.rs:395-453`), `cleanup_stale_locks` (recursive removal of
  `.lock`/`.incomplete`/`.part`, `model_manager.rs:455-479`),
* symlink repair from orphaned blobs > 1 MB (`model_manager.rs:683-737`),
* `list_cached_models` scanning snapshots, deduped + sorted
  (`model_manager.rs:483-521`).

Differences by design (not omissions): whisper checkpoints are HF
safetensors snapshots (`openai/whisper-{name}`: config.json +
model.safetensors + tokenizer files) instead of single ggml binaries
(`ggml-{model}.bin`, `model_manager.rs:162`) — the port loads
safetensors directly (`models/weights.py`); the CoreML branch
(`model_manager.rs:165-296`) has no counterpart here.

Network access is injectable: pass `downloader=` / `url_downloader=` for
tests or air-gapped runs; the defaults use `huggingface_hub` and `requests`.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .types import LabeledProgressFn, ProgressType

WHISPER_REPO_OWNER = "openai"
WHISPER_FILES = [
    "config.json",
    "model.safetensors",
    "vocab.json",
    "merges.txt",
    "tokenizer_config.json",
]
WHISPER_REQUIRED = ["config.json", "model.safetensors"]
DEFAULT_REVISION = "main"
MIN_VALID_BYTES = 100 * 1024  # `model_manager.rs` validation floor
MIN_REPAIR_BLOB_BYTES = 1024 * 1024
# symlink repair only adopts blobs for weight-shaped filenames; small
# sidecar files (config.json/vocab.json/merges.txt) must re-download
REPAIRABLE_SUFFIXES = (".safetensors", ".bin", ".onnx", ".npz", ".pt", ".ggml")

# Diarization model URLs the engine passes in (`engine.rs:90-91`)
SEGMENTATION_URL = (
    "https://github.com/thewh1teagle/pyannote-rs/releases/download/v0.1.0/segmentation-3.0.onnx"
)
EMBEDDING_URL = (
    "https://github.com/thewh1teagle/pyannote-rs/releases/download/v0.1.0/wespeaker_en_voxceleb_CAM++.onnx"
)


class DownloadCancelled(RuntimeError):
    pass


class ModelValidationError(RuntimeError):
    pass


@dataclass
class _DownloadToken:
    cancelled: threading.Event


class ModelManager:
    """HF-layout model cache. Public methods mirror `model_manager.rs:129-531`."""

    # single-flight state shared across instances (class-level, like the
    # reference's globals `model_manager.rs:13-17`)
    _active_lock = threading.Lock()
    _active_token: Optional[_DownloadToken] = None
    _generation = 0

    def __init__(
        self,
        cache_dir,
        downloader: Optional[Callable] = None,
        url_downloader: Optional[Callable] = None,
    ):
        self.cache_dir = Path(cache_dir)
        self._hub_download = downloader or self._default_hub_download
        self._url_download = url_downloader or self._default_url_download

    # ------------------------------------------------------------------
    # single-flight bookkeeping
    # ------------------------------------------------------------------
    @classmethod
    def _setup_new_download(cls) -> Tuple[_DownloadToken, int]:
        """Cancel any in-flight download and mint a new token+generation
        (`model_manager.rs:532-546,564-568`)."""
        with cls._active_lock:
            if cls._active_token is not None:
                cls._active_token.cancelled.set()
            token = _DownloadToken(cancelled=threading.Event())
            cls._active_token = token
            cls._generation += 1
            return token, cls._generation

    @classmethod
    def _is_current(cls, generation: int) -> bool:
        with cls._active_lock:
            return generation == cls._generation

    # ------------------------------------------------------------------
    # layout helpers
    # ------------------------------------------------------------------
    def repo_dir(self, repo_id: str) -> Path:
        return self.cache_dir / ("models--" + repo_id.replace("/", "--"))

    def snapshot_dir(self, repo_id: str, revision: str = DEFAULT_REVISION) -> Path:
        return self.repo_dir(repo_id) / "snapshots" / revision

    def blobs_dir(self, repo_id: str) -> Path:
        return self.repo_dir(repo_id) / "blobs"

    @staticmethod
    def whisper_repo(model_name: str) -> str:
        return f"{WHISPER_REPO_OWNER}/whisper-{model_name}"

    # ------------------------------------------------------------------
    # progress plumbing
    # ------------------------------------------------------------------
    @staticmethod
    def _emit(
        progress: Optional[LabeledProgressFn],
        percent: float,
        label: str,
        offset: float = 0.0,
        scale: float = 100.0,
    ) -> None:
        """Map a 0-100 sub-progress into [offset, offset+scale]
        (`model_manager.rs:80-93`)."""
        if progress is not None:
            mapped = int(offset + (percent / 100.0) * scale)
            progress(max(0, min(100, mapped)), ProgressType.DOWNLOAD, label)

    # ------------------------------------------------------------------
    # default network backends (injectable)
    # ------------------------------------------------------------------
    def _default_hub_download(
        self, repo_id: str, filename: str, dest: Path, progress_cb, cancelled
    ) -> None:
        from huggingface_hub import hf_hub_url
        self._default_url_download(
            hf_hub_url(repo_id=repo_id, filename=filename), dest, progress_cb, cancelled
        )

    @staticmethod
    def _default_url_download(url: str, dest: Path, progress_cb, cancelled) -> None:
        import requests

        dest.parent.mkdir(parents=True, exist_ok=True)
        part = dest.with_suffix(dest.suffix + ".part")
        with requests.get(url, stream=True, timeout=60) as r:
            r.raise_for_status()
            total = int(r.headers.get("content-length", 0) or 0)
            done = 0
            with open(part, "wb") as f:
                for chunk in r.iter_content(chunk_size=1 << 20):
                    if cancelled.is_set():
                        part.unlink(missing_ok=True)
                        raise DownloadCancelled(url)
                    f.write(chunk)
                    done += len(chunk)
                    if total and progress_cb:
                        progress_cb(100.0 * done / total)
        part.replace(dest)

    # ------------------------------------------------------------------
    # validation (`model_manager.rs:634-655,752-768`)
    # ------------------------------------------------------------------
    @staticmethod
    def validate_model_file(path: Path, min_bytes: int = MIN_VALID_BYTES) -> None:
        real = path.resolve()
        if not real.exists():
            raise ModelValidationError(f"missing file: {path}")
        if real.stat().st_size < min_bytes:
            raise ModelValidationError(
                f"file too small ({real.stat().st_size} B): {path}"
            )
        with open(real, "rb") as f:
            head = f.read(16)
        if len(head) < 16:
            raise ModelValidationError(f"unreadable header: {path}")

    # ------------------------------------------------------------------
    # cached-file fast path + symlink repair (`model_manager.rs:586-591,661-737`)
    # ------------------------------------------------------------------
    def find_cached_file(
        self, repo_id: str, filename: str, revision: str = DEFAULT_REVISION
    ) -> Optional[Path]:
        snap = self.snapshot_dir(repo_id, revision) / filename
        if snap.exists():
            if snap.is_symlink() and not snap.resolve().exists():
                snap.unlink()  # dangling symlink
            else:
                return snap
        # repair: adopt a large ORPHANED blob — but only for weight-like
        # filenames. The reference's repos hold one file each
        # (`model_manager.rs:683-734`), so any big blob was the model; HF
        # whisper snapshots hold several files (config.json/vocab.json/...),
        # and adopting the 2 GB safetensors blob for config.json would pass
        # validation and crash the JSON parse later (ADVICE r1, medium).
        if not any(filename.endswith(s) for s in REPAIRABLE_SUFFIXES):
            return None
        blobs = self.blobs_dir(repo_id)
        if blobs.is_dir():
            referenced = self._referenced_blobs(repo_id)
            candidates = [
                b for b in blobs.iterdir()
                if b.is_file()
                and b.stat().st_size >= MIN_REPAIR_BLOB_BYTES
                and b.resolve() not in referenced
            ]
            if candidates:
                blob = max(candidates, key=lambda b: b.stat().st_size)
                snap.parent.mkdir(parents=True, exist_ok=True)
                rel = os.path.relpath(blob, snap.parent)
                snap.symlink_to(rel)
                return snap
        return None

    def _referenced_blobs(self, repo_id: str) -> set:
        """Resolved blob paths referenced by ANY snapshot symlink of a repo."""
        out = set()
        repo_dir = self.snapshot_dir(repo_id).parent  # snapshots/
        if repo_dir.is_dir():
            for rev in repo_dir.iterdir():
                if not rev.is_dir():
                    continue
                for f in rev.rglob("*"):
                    if f.is_symlink():
                        try:
                            out.add(f.resolve())
                        except OSError:
                            pass
        return out

    def _store_blob(self, repo_id: str, filename: str, tmp: Path,
                    revision: str = DEFAULT_REVISION) -> Path:
        """Move a downloaded file into blobs/ and link it from the snapshot."""
        import hashlib

        h = hashlib.sha256()
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        blob = self.blobs_dir(repo_id) / h.hexdigest()
        blob.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(tmp), blob)
        snap = self.snapshot_dir(repo_id, revision) / filename
        snap.parent.mkdir(parents=True, exist_ok=True)
        if snap.is_symlink() or snap.exists():
            snap.unlink()
        snap.symlink_to(os.path.relpath(blob, snap.parent))
        return snap

    # ------------------------------------------------------------------
    # core ensure logic (`model_manager.rs:554-656`)
    # ------------------------------------------------------------------
    def ensure_hub_file(
        self,
        repo_id: str,
        filename: str,
        progress: Optional[LabeledProgressFn] = None,
        is_cancelled: Optional[Callable[[], bool]] = None,
        offset: float = 0.0,
        scale: float = 100.0,
        label: Optional[str] = None,
        min_bytes: int = MIN_VALID_BYTES,
    ) -> Path:
        label = label or f"Downloading {filename}"
        token, generation = self._setup_new_download()
        self.cleanup_stale_locks()

        def bail_if_cancelled():
            if (is_cancelled and is_cancelled()) or token.cancelled.is_set():
                raise DownloadCancelled(filename)

        bail_if_cancelled()

        cached = self.find_cached_file(repo_id, filename)
        if cached is not None:
            try:
                self.validate_model_file(cached, min_bytes)
                self._emit(progress, 100.0, label, offset, scale)
                return cached
            except ModelValidationError:
                self._delete_file_and_blob(cached)

        def attempt() -> Path:
            bail_if_cancelled()
            tmp = self.cache_dir / f".download-{generation}-{filename.replace('/', '_')}"
            tmp.parent.mkdir(parents=True, exist_ok=True)

            def cb(pct: float):
                if self._is_current(generation) and not token.cancelled.is_set():
                    self._emit(progress, pct, label, offset, scale)

            self._hub_download(repo_id, filename, tmp, cb, token.cancelled)
            bail_if_cancelled()
            return self._store_blob(repo_id, filename, tmp)

        snap = attempt()
        try:
            self.validate_model_file(snap, min_bytes)
        except ModelValidationError:
            # delete blob + symlink, retry exactly once
            self._delete_file_and_blob(snap)
            snap = attempt()
            self.validate_model_file(snap, min_bytes)
        self._emit(progress, 100.0, label, offset, scale)
        return snap

    @staticmethod
    def _delete_file_and_blob(path: Path) -> None:
        real = path.resolve()
        if path.is_symlink():
            path.unlink(missing_ok=True)
        if real.exists():
            real.unlink()

    # ------------------------------------------------------------------
    # public surface (`model_manager.rs:129-531`)
    # ------------------------------------------------------------------
    def ensure_whisper_model(
        self,
        model_name: str,
        progress: Optional[LabeledProgressFn] = None,
        is_cancelled: Optional[Callable[[], bool]] = None,
    ) -> Path:
        """Ensure the full whisper snapshot (config + safetensors +
        tokenizer); returns the snapshot directory. Progress spans the files
        proportionally (safetensors dominates)."""
        if is_cancelled and is_cancelled():
            self.cleanup_stale_locks()
            raise DownloadCancelled(model_name)
        repo = self.whisper_repo(model_name)
        label = f"Downloading {model_name} model"
        # weights get 0-94, the small sidecar files share 94-100
        spans = {"model.safetensors": (0.0, 94.0)}
        small = [f for f in WHISPER_FILES if f != "model.safetensors"]
        width = 6.0 / len(small)
        for i, f in enumerate(small):
            spans[f] = (94.0 + i * width, width)
        snap_dir = self.snapshot_dir(repo)
        for f in WHISPER_FILES:
            off, scale = spans[f]
            required = f in WHISPER_REQUIRED
            try:
                self.ensure_hub_file(
                    repo, f, progress, is_cancelled, off, scale, label,
                    min_bytes=MIN_VALID_BYTES if f == "model.safetensors" else 1,
                )
            except DownloadCancelled:
                raise
            except Exception:
                if required:
                    raise
                # tokenizer sidecars are optional (DebugTokenizer fallback)
        self._emit(progress, 100.0, label)
        return snap_dir

    def ensure_whisper_model_ggml(
        self,
        model_name: str,
        progress: Optional[LabeledProgressFn] = None,
        is_cancelled: Optional[Callable[[], bool]] = None,
    ) -> Path:
        """Ensure the whisper.cpp GGML checkpoint — the reference's exact
        source (`model_manager.rs:162`: HF repo `ggerganov/whisper.cpp`,
        file `ggml-{model_name}.bin`). Returns the FILE path; the engine's
        ggml loader consumes it directly (weights + embedded vocabulary)."""
        if is_cancelled and is_cancelled():
            self.cleanup_stale_locks()
            raise DownloadCancelled(model_name)
        return self.ensure_hub_file(
            "ggerganov/whisper.cpp", f"ggml-{model_name}.bin",
            progress, is_cancelled, 0.0, 100.0,
            f"Downloading {model_name} model",
        )

    def ensure_vad_model(
        self,
        progress: Optional[LabeledProgressFn] = None,
        is_cancelled: Optional[Callable[[], bool]] = None,
        repo_id: str = "ggml-org/whisper-vad",
        filename: str = "ggml-silero-v5.1.2.bin",
    ) -> Path:
        """Ensure the Silero VAD weights — the reference's exact artifact
        (`ggml-silero-v5.1.2.bin` from `ggml-org/whisper-vad`,
        `model_manager.rs:303-319`). The GGML file is parsed directly
        (`models/convert.py::silero_npz_from_ggml`, cached as .npz on first
        use by `vad.get_segments`)."""
        return self.ensure_hub_file(
            repo_id, filename, progress, is_cancelled,
            label="Downloading VAD model",
        )

    def ensure_diarize_models(
        self,
        seg_url: str = SEGMENTATION_URL,
        emb_url: str = EMBEDDING_URL,
        progress: Optional[LabeledProgressFn] = None,
        is_cancelled: Optional[Callable[[], bool]] = None,
    ) -> Tuple[Path, Path]:
        """Plain-URL download of the two diarization models to the cache
        root, with the reference's staged progress 5/50/55/100
        (`model_manager.rs:321-351,791-801`)."""
        token, generation = self._setup_new_download()

        def bail():
            if (is_cancelled and is_cancelled()) or token.cancelled.is_set():
                raise DownloadCancelled("diarize models")

        self.cache_dir.mkdir(parents=True, exist_ok=True)
        label = "Downloading diarization models"
        out = []
        stages = [(seg_url, 5.0, 45.0), (emb_url, 55.0, 45.0)]
        for url, off, scale in stages:
            bail()
            name = url.rsplit("/", 1)[-1]
            dest = self.cache_dir / name
            self._emit(progress, 0.0, label, off, scale)
            if not dest.exists():
                def cb(pct, off=off, scale=scale):
                    if self._is_current(generation):
                        self._emit(progress, pct, label, off, scale)

                self._url_download(url, dest, cb, token.cancelled)
            self._emit(progress, 100.0, label, off, scale)
            out.append(dest)
        self._emit(progress, 100.0, label)
        return out[0], out[1]

    def delete_whisper_model(self, model_name: str) -> None:
        """Remove snapshot symlinks for a model (blobs kept for reuse);
        raises when nothing matched (`model_manager.rs:353-391`)."""
        repo = self.whisper_repo(model_name)
        snap_root = self.repo_dir(repo) / "snapshots"
        matched = False
        if snap_root.is_dir():
            for rev in snap_root.iterdir():
                for f in list(rev.iterdir()) if rev.is_dir() else []:
                    if f.is_symlink() or f.is_file():
                        f.unlink()
                        matched = True
        if not matched:
            raise FileNotFoundError(f"no cached files for model {model_name!r}")

    def list_cached_models(self) -> List[str]:
        """Scan snapshots for whisper checkpoints; dedupe + sort
        (`model_manager.rs:483-521`)."""
        names = set()
        prefix = f"models--{WHISPER_REPO_OWNER}--whisper-"
        if not self.cache_dir.is_dir():
            return []
        for d in self.cache_dir.iterdir():
            if not d.name.startswith(prefix):
                continue
            name = d.name[len(prefix):]
            snaps = d / "snapshots"
            if snaps.is_dir():
                for rev in snaps.iterdir():
                    if (rev / "model.safetensors").exists() or (
                        rev / "config.json"
                    ).exists():
                        names.add(name)
                        break
        return sorted(names)

    def delete_cached_model(self, model_name: str) -> bool:
        """Delete by name; bool result (`engine.rs:214-216`)."""
        try:
            self.delete_whisper_model(model_name)
            return True
        except Exception:
            return False

    def cleanup_orphaned_blobs(self) -> int:
        """Remove blobs not referenced by any snapshot symlink
        (`model_manager.rs:395-453`). Returns the number removed."""
        removed = 0
        if not self.cache_dir.is_dir():
            return 0
        for repo in self.cache_dir.glob("models--*"):
            blobs = repo / "blobs"
            snaps = repo / "snapshots"
            if not blobs.is_dir():
                continue
            referenced = set()
            if snaps.is_dir():
                for link in snaps.rglob("*"):
                    if link.is_symlink():
                        referenced.add(link.resolve())
            for blob in blobs.iterdir():
                if blob.is_file() and blob.resolve() not in referenced:
                    blob.unlink()
                    removed += 1
        return removed

    def cleanup_stale_locks(self) -> int:
        """Recursively remove `.lock` / `.incomplete` / `.part` files
        (`model_manager.rs:455-479`)."""
        removed = 0
        if not self.cache_dir.is_dir():
            return 0
        for pattern in ("*.lock", "*.incomplete", "*.part"):
            for f in self.cache_dir.rglob(pattern):
                try:
                    f.unlink()
                    removed += 1
                except OSError:
                    pass
        return removed
