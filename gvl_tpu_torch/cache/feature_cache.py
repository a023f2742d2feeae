"""Whole-video perception-feature cache with content-hash keys (the port's
copy of :mod:`gvl_tpu.cache.feature_cache`).

Caches the complete perception output of a video (embeddings, timeline
events, the knowledge base) so reprocessing becomes a reload.  Keyed by
sha256(file size + first/last 1 MB)[:16] (for ``synthetic://`` URLs, the
URL with :data:`~gvl_tpu_torch.io.video.SYNTHETIC_SCHEME_VERSION`), with
10 GB LRU-by-mtime eviction to 80%.  Storage is a directory of ``.npz``
(arrays) + ``.json`` (metadata); a ``.pt`` importer reads feature dicts
saved by torch.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)


def video_content_hash(video_path: str | Path) -> str:
    """sha256(size + first/last 1 MB) → 16 hex chars ('' if missing)."""
    path = Path(video_path)
    if not path.exists():
        if str(video_path).startswith("synthetic://"):
            from gvl_tpu_torch.io.video import SYNTHETIC_SCHEME_VERSION

            key = f"v{SYNTHETIC_SCHEME_VERSION}:{video_path}"
            return hashlib.sha256(key.encode()).hexdigest()[:16]
        return ""
    size = path.stat().st_size
    chunk = min(1024 * 1024, size)
    hasher = hashlib.sha256()
    hasher.update(str(size).encode())
    with open(path, "rb") as f:
        hasher.update(f.read(chunk))
        if size > chunk * 2:
            f.seek(-chunk, 2)
            hasher.update(f.read(chunk))
    return hasher.hexdigest()[:16]


def _split_features(features: dict) -> tuple[dict, dict]:
    """Partition a feature dict into (arrays, json-able metadata)."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {}

    def walk(prefix: str, value: Any, meta_slot: dict):
        if isinstance(value, np.ndarray):
            arrays[prefix] = value
            meta_slot["__array__"] = prefix
        elif isinstance(value, dict):
            sub: dict = {}
            meta_slot["__dict__"] = sub
            for k, v in value.items():
                slot: dict = {}
                sub[str(k)] = slot
                walk(f"{prefix}/{k}" if prefix else str(k), v, slot)
        elif isinstance(value, (list, tuple)) and value and all(
            isinstance(v, np.ndarray) for v in value
        ):
            names = []
            for i, v in enumerate(value):
                name = f"{prefix}#{i}"
                arrays[name] = v
                names.append(name)
            meta_slot["__array_list__"] = names
        else:
            meta_slot["__value__"] = value

    root: dict = {}
    walk("", features, root)
    return arrays, root


def _join_features(arrays: dict, meta: dict) -> Any:
    if "__array__" in meta:
        return arrays[meta["__array__"]]
    if "__array_list__" in meta:
        return [arrays[name] for name in meta["__array_list__"]]
    if "__dict__" in meta:
        return {k: _join_features(arrays, v) for k, v in meta["__dict__"].items()}
    return meta.get("__value__")


class FeatureCache:
    """Disk + memory cache of per-video perception features.

    >>> cache = FeatureCache("data/cache")
    >>> if cache.has_features(video):
    ...     features = cache.load_features(video)
    """

    def __init__(self, cache_dir: str | Path = "data/cache",
                 max_cache_size_gb: float = 10.0):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.max_cache_size_bytes = int(max_cache_size_gb * 1024 ** 3)
        self._memory: dict[str, dict] = {}

    def _entry_dir(self, video_path: str) -> Path:
        stem = Path(str(video_path).replace("synthetic://", "synthetic_")).stem
        return self.cache_dir / f"{stem}_{video_content_hash(video_path)}"

    def has_features(self, video_path: str) -> bool:
        key = video_content_hash(video_path)
        if key in self._memory:
            return True
        return (self._entry_dir(video_path) / "meta.json").exists()

    def load_features(self, video_path: str) -> Optional[dict]:
        key = video_content_hash(video_path)
        if key in self._memory:
            return self._memory[key]
        entry = self._entry_dir(video_path)
        meta_path = entry / "meta.json"
        if not meta_path.exists():
            # reference-format .pt fallback next to the entry dir
            pt = entry.with_suffix(".pt")
            if pt.exists():
                return self._load_torch(pt, key)
            return None
        try:
            meta = json.loads(meta_path.read_text())
            arrays = {}
            npz_path = entry / "arrays.npz"
            if npz_path.exists():
                with np.load(npz_path, allow_pickle=False) as z:
                    arrays = {k: z[k] for k in z.files}
            features = _join_features(arrays, meta)
            self._memory[key] = features
            return features
        except Exception as exc:
            logger.warning("corrupt cache entry %s: %s — removing", entry, exc)
            shutil.rmtree(entry, ignore_errors=True)
            return None

    def _load_torch(self, path: Path, key: str) -> Optional[dict]:
        try:
            import torch

            blob = torch.load(path, map_location="cpu", weights_only=True)
            features = {
                k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in blob.items()
            }
            self._memory[key] = features
            return features
        except Exception as exc:
            logger.warning("failed to import reference cache %s: %s", path, exc)
            return None

    def save_features(self, video_path: str, features: dict) -> None:
        key = video_content_hash(video_path)
        self._memory[key] = features
        entry = self._entry_dir(video_path)
        try:
            self._evict_if_needed()
            entry.mkdir(parents=True, exist_ok=True)
            arrays, meta = _split_features(features)
            if arrays:
                np.savez_compressed(entry / "arrays.npz", **arrays)
            (entry / "meta.json").write_text(json.dumps(meta, default=str))
        except Exception as exc:
            logger.warning("failed to persist cache for %s: %s", video_path, exc)

    def _evict_if_needed(self) -> None:
        entries = [p for p in self.cache_dir.iterdir() if p.is_dir()]
        sizes = {
            p: sum(f.stat().st_size for f in p.rglob("*") if f.is_file())
            for p in entries
        }
        total = sum(sizes.values())
        if total <= self.max_cache_size_bytes:
            return
        entries.sort(key=lambda p: p.stat().st_mtime)
        target = self.max_cache_size_bytes * 0.8
        while total > target and entries:
            victim = entries.pop(0)
            total -= sizes[victim]
            shutil.rmtree(victim, ignore_errors=True)
            logger.info("evicted cache entry %s", victim)

    def clear(self) -> None:
        self._memory.clear()
        for entry in self.cache_dir.iterdir():
            if entry.is_dir():
                shutil.rmtree(entry, ignore_errors=True)

    def get_cache_stats(self) -> dict:
        entries = [p for p in self.cache_dir.iterdir() if p.is_dir()]
        total = sum(
            f.stat().st_size for p in entries for f in p.rglob("*")
            if f.is_file()
        )
        return {
            "num_cached_videos": len(entries),
            "total_size_mb": total / 1024 ** 2,
            "memory_cache_entries": len(self._memory),
        }
