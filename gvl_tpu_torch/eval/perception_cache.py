"""Two-stage evaluation cache: per-video perception artifacts on disk (the
port's copy of ``benchmarks/perception_cache.py``, same version, key scheme
and file layout).

One directory per video hash holding metadata.json + npz embeddings + JSON
artifacts, a versioned ``CACHE_VERSION`` compatibility gate, an
``index.json`` across entries, and invalidation.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

CACHE_VERSION = "1.0.0"

ARRAY_KEYS = ("siglip", "videomae", "wav2vec2")
JSON_KEYS = ("sam_entities", "ocr", "audio", "timeline", "kb")


def video_cache_key(video_path: str) -> str:
    """md5(path:size:mtime) — matches the reference scheme."""
    p = Path(video_path)
    if p.exists():
        stat = p.stat()
        payload = f"{video_path}:{stat.st_size}:{stat.st_mtime}"
    else:
        payload = video_path  # synthetic:// and friends
    return hashlib.md5(payload.encode()).hexdigest()


class PerceptionCache:
    """Directory-per-video artifact cache for Stage A/B evaluation."""

    def __init__(self, cache_dir: str | Path = "data/benchmark_cache"):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._index_path = self.cache_dir / "index.json"

    def _entry(self, video_path: str) -> Path:
        return self.cache_dir / video_cache_key(video_path)

    def has(self, video_path: str) -> bool:
        meta = self._entry(video_path) / "metadata.json"
        if not meta.exists():
            return False
        try:
            doc = json.loads(meta.read_text())
            return doc.get("cache_version") == CACHE_VERSION
        except Exception:
            return False

    def save(
        self,
        video_path: str,
        arrays: Optional[dict[str, np.ndarray]] = None,
        artifacts: Optional[dict[str, object]] = None,
    ) -> Path:
        entry = self._entry(video_path)
        entry.mkdir(parents=True, exist_ok=True)
        meta = {
            "cache_version": CACHE_VERSION,
            "video_path": str(video_path),
            "created_at": time.time(),
            "arrays": [],
            "artifacts": [],
        }
        for key, arr in (arrays or {}).items():
            np.savez_compressed(entry / f"{key}.npz", data=np.asarray(arr))
            meta["arrays"].append(key)
        for key, doc in (artifacts or {}).items():
            (entry / f"{key}.json").write_text(json.dumps(doc, default=str))
            meta["artifacts"].append(key)
        (entry / "metadata.json").write_text(json.dumps(meta, indent=2))
        self._update_index(video_path, entry)
        return entry

    def load(self, video_path: str) -> Optional[dict]:
        if not self.has(video_path):
            return None
        entry = self._entry(video_path)
        meta = json.loads((entry / "metadata.json").read_text())
        out: dict = {"metadata": meta}
        for key in meta.get("arrays", []):
            with np.load(entry / f"{key}.npz") as z:
                out[key] = z["data"]
        for key in meta.get("artifacts", []):
            out[key] = json.loads((entry / f"{key}.json").read_text())
        return out

    def invalidate(self, video_path: str) -> bool:
        entry = self._entry(video_path)
        if entry.exists():
            shutil.rmtree(entry)
            return True
        return False

    def clear(self) -> None:
        for child in self.cache_dir.iterdir():
            if child.is_dir():
                shutil.rmtree(child, ignore_errors=True)
        self._index_path.unlink(missing_ok=True)

    def _update_index(self, video_path: str, entry: Path) -> None:
        index = {}
        if self._index_path.exists():
            try:
                index = json.loads(self._index_path.read_text())
            except Exception:
                index = {}
        index[video_cache_key(video_path)] = {
            "video_path": str(video_path),
            "entry": entry.name,
            "updated_at": time.time(),
        }
        self._index_path.write_text(json.dumps(index, indent=2))

    def get_statistics(self) -> dict:
        entries = [p for p in self.cache_dir.iterdir() if p.is_dir()]
        return {
            "cache_version": CACHE_VERSION,
            "num_entries": len(entries),
            "total_size_mb": sum(
                f.stat().st_size for p in entries for f in p.rglob("*")
                if f.is_file()
            ) / 1024 ** 2,
        }


def create_perception_cache(
    cache_dir: str = "data/benchmark_cache",
) -> PerceptionCache:
    return PerceptionCache(cache_dir)


# --------------------------------------------------------------------------
# ProcessedVideo <-> pinned artifact schema (Stage A/B bridge)
# --------------------------------------------------------------------------
#
# Stage A persists real artifacts, and Stage B rebuilds a live pipeline from
# them in a cold process.  The feature dict is
# gvl_tpu_torch.pipeline._to_cache_dict's layout; it maps onto the pinned
# schema (`ARRAY_KEYS` npz + `JSON_KEYS` json) with the per-array timestamp
# vectors stored as sibling arrays.

def save_processed_features(cache: PerceptionCache, video_path: str,
                            features: dict) -> Path:
    """Persist a ``_to_cache_dict`` feature dict under the pinned schema."""
    events = features.get("events", [])

    def events_of(*modalities):
        return [e for e in events if e.get("modality") in modalities]

    arrays = {
        "siglip": np.asarray(features.get("siglip", np.zeros((0,)))),
        "videomae": np.asarray(features.get("videomae", np.zeros((0,)))),
        "wav2vec2": np.asarray(features.get("audio", np.zeros((0,)))),
        "siglip_ts": np.asarray(features.get("siglip_ts", [])),
        "videomae_ts": np.asarray(features.get("videomae_ts", [])),
        "wav2vec2_ts": np.asarray(features.get("audio_ts", [])),
        "timestamps": np.asarray(features.get("timestamps", [])),
    }
    artifacts = {
        "timeline": {"events": events},
        "kb": features.get("knowledge_base", {}),
        "sam_entities": events_of("visual"),
        "ocr": events_of("ocr"),
        "audio": events_of("audio", "speech"),
    }
    return cache.save(video_path, arrays=arrays, artifacts=artifacts)


def load_processed_features(cache: PerceptionCache,
                            video_path: str) -> Optional[dict]:
    """Inverse of :func:`save_processed_features` (None on miss)."""
    doc = cache.load(video_path)
    if doc is None:
        return None
    return {
        "timestamps": doc.get("timestamps", np.zeros((0,))),
        "siglip": doc.get("siglip", np.zeros((0,))),
        "siglip_ts": doc.get("siglip_ts", np.zeros((0,))),
        "videomae": doc.get("videomae", np.zeros((0,))),
        "videomae_ts": doc.get("videomae_ts", np.zeros((0,))),
        "audio": doc.get("wav2vec2", np.zeros((0,))),
        "audio_ts": doc.get("wav2vec2_ts", np.zeros((0,))),
        "events": doc.get("timeline", {}).get("events", []),
        "knowledge_base": doc.get("kb", {}),
    }
