"""Hybrid timeline retrieval: time-anchored when the query names a moment,
semantic otherwise (the port's copy of :mod:`gvl_tpu.agent.retriever`).

Timestamps: HH:MM:SS, MM:SS and "at/around N seconds".  Semantic retrieval
is cosine top-k over event-description embeddings from a
:class:`TextEmbedder`: the trained byte tower
(:class:`~gvl_tpu_torch.training.retriever_train.TrainedTextEmbedder`) when
``outputs/retriever`` is there, the MiniLM encoder of an HF directory
(:mod:`gvl_tpu_torch.models.minilm`), else the feature-hashing embedder.  The
timeline is a :class:`gvl_tpu_torch.fusion.timeline.TimelineIndexer`.
"""

from __future__ import annotations

import logging
import os
import re
import zlib
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from gvl_tpu_torch.agent.config import ReasoningCoreConfig

logger = logging.getLogger(__name__)


class TextEmbedder(Protocol):
    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


class HashingTextEmbedder:
    """Deterministic n-gram feature hashing: words and word bigrams, crc32
    into ``dim`` signed buckets, L2-normalised."""

    def __init__(self, dim: int = 256):
        self.dim = dim

    def _features(self, text: str) -> list[str]:
        words = re.findall(r"[a-z0-9]+", text.lower())
        return words + [f"{a}_{b}" for a, b in zip(words, words[1:])]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            for feat in self._features(text):
                h = zlib.crc32(feat.encode())
                bucket = h % self.dim
                sign = 1.0 if (h >> 31) & 1 else -1.0
                out[i, bucket] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


def make_embedder(config: ReasoningCoreConfig,
                  device: str | torch.device = "cuda") -> Optional[TextEmbedder]:
    """The embedder ladder of ``gvl_tpu.agent.retriever.make_embedder``:
    "auto" → the trained tower when ``outputs/retriever`` is there, else
    hashing; "hashing" → hashing; a trained retriever directory → its
    tower on ``device``; another directory → the HF MiniLM encoder on
    ``device`` (:class:`~gvl_tpu_torch.models.minilm.MiniLMSentenceEncoder`),
    which raises when the directory cannot be loaded where JAX falls
    through (ROADMAP C15); any other name → sentence-transformers if it
    loads, else hashing."""
    name = config.embedding_model
    if name == "auto":
        from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

        trained = resolve_repo_path("outputs/retriever")
        name = trained if trained else "hashing"
    if name == "hashing":
        return HashingTextEmbedder(config.embedding_dim)
    if os.path.isdir(name):
        from gvl_tpu_torch.training.retriever_train import (
            TrainedTextEmbedder,
            is_trained_retriever_checkpoint,
        )

        if is_trained_retriever_checkpoint(name):
            logger.info("semantic retriever: self-trained tower from %s", name)
            return TrainedTextEmbedder.from_dir(name, device=device)
        from gvl_tpu_torch.models.minilm import MiniLMSentenceEncoder

        try:
            return MiniLMSentenceEncoder.from_hf_checkpoint(name, device=device)
        except Exception as exc:
            raise ValueError(
                f"MiniLM checkpoint {name} cannot be used ({exc}); the JAX package "
                "would fall through to sentence-transformers and hashing here "
                "(ROADMAP C15)") from exc
    try:  # optional learned embedder (requires local weights)
        from sentence_transformers import SentenceTransformer

        model = SentenceTransformer(name)

        class _ST:
            def encode(self, texts):
                return np.asarray(model.encode(list(texts)))

        return _ST()
    except Exception as exc:
        logger.warning("embedding model %r unavailable (%s); falling back to hashing",
                       config.embedding_model, exc)
        return HashingTextEmbedder(config.embedding_dim)


class TimelineRetriever:
    """Routes queries to time-window or semantic retrieval."""

    TIMESTAMP_PATTERNS = [
        re.compile(r"(\d{1,2}):(\d{2}):(\d{2})"),            # HH:MM:SS
        re.compile(r"(\d{1,2}):(\d{2})"),                     # MM:SS
        re.compile(r"at\s+(\d+(?:\.\d+)?)\s*(?:sec|seconds?|s)?"),
        re.compile(r"around\s+(\d+(?:\.\d+)?)\s*(?:sec|seconds?|s)?"),
    ]

    def __init__(self, config: ReasoningCoreConfig, embedder: Optional[TextEmbedder] = None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self._embedder = embedder if embedder is not None else make_embedder(config, device)
        self._event_embeddings: Optional[np.ndarray] = None
        self._events: list = []
        self._index_key = None

    def index_timeline(self, timeline_indexer) -> None:
        """(Re)index event descriptions; skipped while the indexer, its
        event count and its last description are unchanged."""
        events = getattr(timeline_indexer, "events", None)
        if events is None:
            events = getattr(timeline_indexer, "_events", [])
        key = (id(timeline_indexer), len(events),
               events[-1].description if events else None)
        if self._event_embeddings is not None and self._index_key == key:
            return
        self._index_key = key
        self._events = list(events)
        if not self._events or self._embedder is None:
            self._event_embeddings = None
            logger.info("indexed %d events (semantic disabled)", len(self._events))
            return
        self._event_embeddings = self._embedder.encode([e.description for e in self._events])
        logger.info("indexed %d events with embeddings", len(self._events))

    def parse_timestamp(self, query: str) -> Optional[float]:
        q = query.lower()
        for pattern in self.TIMESTAMP_PATTERNS:
            match = pattern.search(q)
            if not match:
                continue
            groups = match.groups()
            if len(groups) == 3:
                h, m, s = map(int, groups)
                return float(h * 3600 + m * 60 + s)
            if len(groups) == 2:
                m, s = map(int, groups)
                return float(m * 60 + s)
            return float(groups[0])
        return None

    def retrieve_by_timestamp(self, timestamp: float, window: Optional[float] = None,
                              timeline_indexer=None) -> list:
        """Events within ±window of the timestamp."""
        window = window or self.config.retrieval_window_sec
        if timeline_indexer is not None:
            return timeline_indexer.query_around_timestamp(timestamp, window * 2)
        return [e for e in self._events
                if timestamp - window <= e.timestamp <= timestamp + window]

    def retrieve_by_semantic(self, query: str, top_k: Optional[int] = None) -> list:
        """Cosine top-k over indexed descriptions."""
        if self._embedder is None or self._event_embeddings is None:
            return []
        top_k = top_k or self.config.semantic_top_k
        qvec = self._embedder.encode([query])[0]
        qnorm = qvec / max(np.linalg.norm(qvec), 1e-12)
        sims = self._event_embeddings @ qnorm
        order = np.argsort(-sims)[:top_k]
        return [self._events[i] for i in order]

    def hybrid_retrieve(self, query: str, timeline_indexer=None) -> list:
        """Timestamp in the query → its time window plus up to 5 semantic
        extras (deduplicated); otherwise semantic top-k."""
        timestamp = self.parse_timestamp(query)
        if timestamp is None:
            return self.retrieve_by_semantic(query)
        events = self.retrieve_by_timestamp(timestamp, timeline_indexer=timeline_indexer)
        seen = {id(e) for e in events}
        for extra in self.retrieve_by_semantic(query, top_k=5):
            if id(extra) not in seen:
                events.append(extra)
        return events
