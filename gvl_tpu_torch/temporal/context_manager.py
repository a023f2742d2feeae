"""Hierarchical temporal context: FINE → CLIP → SCENE → SESSION.

The port's copy of :mod:`gvl_tpu.temporal.context_manager` (host code,
rendered byte for byte as the JAX package renders it).  Observations enter at
FINE granularity; as each level's span fills, its entries collapse into a
summarized entry one level up, so ``get_context_for_llm`` always fits a
character budget with recency-weighted detail: full sentences for the last
seconds, clip summaries for the last minute, scene summaries beyond.

==  =======  =========  =================================
L   name     span       content
==  =======  =========  =================================
0   FINE     1-5 s      individual observations
1   CLIP     10-30 s    summarized clips
2   SCENE    1-5 min    scene summaries
3   SESSION  5+ min     global session context
==  =======  =========  =================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from gvl_tpu_torch.fusion.timeline import format_mmss


class ContextLevel(IntEnum):
    FINE = 0
    CLIP = 1
    SCENE = 2
    SESSION = 3


# seconds of history a single entry at each level may span
_LEVEL_SPAN = {
    ContextLevel.FINE: 5.0,
    ContextLevel.CLIP: 30.0,
    ContextLevel.SCENE: 300.0,
    ContextLevel.SESSION: float("inf"),
}
# how many entries a level holds before collapsing into the next
_LEVEL_CAPACITY = {
    ContextLevel.FINE: 20,
    ContextLevel.CLIP: 12,
    ContextLevel.SCENE: 8,
    ContextLevel.SESSION: 4,
}


@dataclass
class ContextEntry:
    start_time: float
    end_time: float
    text: str
    level: ContextLevel
    source_count: int = 1

    def render(self) -> str:
        if self.level is ContextLevel.FINE:
            return f"[{format_mmss(self.start_time)}] {self.text}"
        return (
            f"[{format_mmss(self.start_time)}-{format_mmss(self.end_time)}] "
            f"({self.level.name.lower()}) {self.text}"
        )


@dataclass
class TemporalContextManager:
    """Multi-resolution rolling context over streamed observations."""

    levels: dict = field(default_factory=lambda: {lvl: [] for lvl in ContextLevel})

    def add_observation(self, start_time: float, end_time: float, text: str) -> None:
        self.levels[ContextLevel.FINE].append(
            ContextEntry(start_time, end_time, text, ContextLevel.FINE)
        )
        self._cascade()

    def _cascade(self) -> None:
        """Collapse overflowing levels upward."""
        for level in (ContextLevel.FINE, ContextLevel.CLIP, ContextLevel.SCENE):
            entries = self.levels[level]
            cap = _LEVEL_CAPACITY[level]
            if len(entries) <= cap:
                continue
            # collapse the oldest half into one higher-level entry
            n = max(2, cap // 2)
            old, self.levels[level] = entries[:n], entries[n:]
            merged = self._summarize(old, ContextLevel(level + 1))
            self.levels[ContextLevel(level + 1)].append(merged)
        # SESSION level: merge pairwise when over capacity
        session = self.levels[ContextLevel.SESSION]
        cap = _LEVEL_CAPACITY[ContextLevel.SESSION]
        while len(session) > cap:
            a, b = session[0], session[1]
            session[:2] = [self._summarize([a, b], ContextLevel.SESSION)]

    @staticmethod
    def _summarize(entries: list[ContextEntry], level: ContextLevel) -> ContextEntry:
        """Concatenate clipped texts; a learned summarizer can plug in here."""
        texts = []
        for e in entries:
            t = e.text if len(e.text) <= 60 else e.text[:60] + "..."
            texts.append(t)
        return ContextEntry(
            start_time=entries[0].start_time,
            end_time=entries[-1].end_time,
            text="; ".join(texts),
            level=level,
            source_count=sum(e.source_count for e in entries),
        )

    # ---------------------------------------------------------------- query

    def get_context_for_llm(self, max_chars: int = 4000) -> str:
        """Render coarse→fine, trimming oldest coarse entries to budget."""
        ordered: list[ContextEntry] = []
        for level in (ContextLevel.SESSION, ContextLevel.SCENE,
                      ContextLevel.CLIP, ContextLevel.FINE):
            ordered.extend(self.levels[level])
        lines = [e.render() for e in ordered]
        while lines and sum(len(l) + 1 for l in lines) > max_chars:
            lines.pop(0)  # drop the coarsest/oldest first
        return "\n".join(lines)

    def get_entries(self, level: Optional[ContextLevel] = None) -> list[ContextEntry]:
        if level is not None:
            return list(self.levels[level])
        return [e for lvl in ContextLevel for e in self.levels[lvl]]

    def get_statistics(self) -> dict:
        return {
            "entries_per_level": {
                lvl.name: len(entries) for lvl, entries in self.levels.items()
            },
            "total_observations": sum(
                e.source_count for lvl in ContextLevel for e in self.levels[lvl]
            ),
        }

    def clear(self) -> None:
        for lvl in ContextLevel:
            self.levels[lvl].clear()
