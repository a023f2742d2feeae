"""Rolling window of compressed temporal embeddings.

A FIFO of (timestamp, embedding) pairs pruned to the configured time
window and token cap — the "last N minutes" memory fed to the reasoning
core alongside the timeline.  Embeddings are numpy arrays.  The port's
copy of :mod:`gvl_tpu.agent.temporal_context`.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from gvl_tpu_torch.agent.config import ReasoningCoreConfig


class TemporalContextManager:
    """FIFO of compressed clip embeddings with window + cap pruning."""

    def __init__(self, config: ReasoningCoreConfig):
        self.config = config
        self.window_seconds = config.temporal_window_minutes * 60
        self._max_tokens = config.max_hico_tokens
        self._buffer: deque[tuple[float, np.ndarray]] = deque()

    def add_context(self, timestamp: float, embedding) -> None:
        self._buffer.append((timestamp, np.asarray(embedding)))
        cutoff = timestamp - self.window_seconds
        while self._buffer and self._buffer[0][0] < cutoff:
            self._buffer.popleft()
        while len(self._buffer) > self._max_tokens:
            self._buffer.popleft()

    def get_context(
        self, current_timestamp: Optional[float] = None
    ) -> tuple[list[float], Optional[np.ndarray]]:
        """(timestamps, stacked [N, dim] array) or ([], None)."""
        if not self._buffer:
            return [], None
        timestamps = [ts for ts, _ in self._buffer]
        stacked = np.stack([emb for _, emb in self._buffer], axis=0)
        return timestamps, stacked

    def get_context_summary(self) -> str:
        if not self._buffer:
            return "No temporal context available."
        oldest, newest = self._buffer[0][0], self._buffer[-1][0]
        return (
            f"Temporal context: {len(self._buffer)} frames, "
            f"{newest - oldest:.1f}s duration "
            f"({oldest:.1f}s to {newest:.1f}s)"
        )

    def __len__(self) -> int:
        return len(self._buffer)

    def clear(self) -> None:
        self._buffer.clear()
