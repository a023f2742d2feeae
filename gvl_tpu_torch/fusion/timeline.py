"""Unified multi-modal event timeline: the LLM's external memory (the
port's copy of :mod:`gvl_tpu.fusion.timeline`).

Every perception program (segmentation, audio events, ASR, OCR) emits
timestamped events; this module keeps them in one time-sorted store with
O(log n) range queries (a bisect-maintained array), merges bursts of
near-duplicate observations, and renders compact ``[MM:SS]`` transcripts
for prompting.  Its rendered text is held byte-identical to the JAX
package's on the same events (``tests/test_torch_fusion.py``).
"""

from __future__ import annotations

import bisect
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterable, Optional, Sequence

logger = logging.getLogger(__name__)


def format_mmss(seconds: float) -> str:
    """Render seconds as the canonical ``MM:SS`` timeline tag."""
    return f"{int(seconds // 60):02d}:{int(seconds % 60):02d}"


class ModalityType(Enum):
    """Source modality of a timeline event."""

    VISUAL = "visual"      # segmentation / region-semantic observations
    TEMPORAL = "temporal"  # hierarchical-compression tokens
    AUDIO = "audio"        # non-speech audio events
    SPEECH = "speech"      # ASR transcription segments
    OCR = "ocr"            # on-screen text
    SYSTEM = "system"      # framework-generated events


class EventPriority(Enum):
    """Retention/ranking priority; lower value = more important."""

    CRITICAL = 0
    HIGH = 1
    MEDIUM = 2
    LOW = 3
    DEBUG = 4


@dataclass
class TimelineEvent:
    """One timestamped observation on the unified timeline."""

    timestamp: float
    modality: ModalityType
    description: str
    priority: EventPriority = EventPriority.MEDIUM
    duration: float = 0.0
    entity_id: Optional[str] = None
    confidence: float = 1.0
    metadata: dict = field(default_factory=dict)

    @property
    def end_time(self) -> float:
        return self.timestamp + self.duration

    def format_compact(self) -> str:
        """One-line ``[MM:SS]`` rendering used in LLM transcripts."""
        tag = f"[{format_mmss(self.timestamp)}]"
        if self.modality is ModalityType.SPEECH:
            return f'{tag} "{self.description}"'
        if self.modality is ModalityType.AUDIO:
            return f"{tag} (Audio: {self.description})"
        if self.modality is ModalityType.OCR:
            return f'{tag} (Text: "{self.description}")'
        return f"{tag} {self.description}"

    def format_verbose(self) -> str:
        """Rendering with entity id and modality for debugging/export."""
        entity = f" [{self.entity_id}]" if self.entity_id else ""
        return (
            f"[{format_mmss(self.timestamp)}]{entity} "
            f"({self.modality.value}) {self.description}"
        )

    # Kept as a staticmethod alias so downstream code written against the
    # reference API (`TimelineEvent._format_time`) keeps working.
    _format_time = staticmethod(format_mmss)

    def dedupe_key(self) -> str:
        return f"{self.modality.value}:{self.description.lower()[:50]}"


@dataclass
class TimelineSegment:
    """Events falling inside one fixed-duration window of the timeline."""

    start_time: float
    end_time: float
    events: list[TimelineEvent] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def event_count(self) -> int:
        return len(self.events)

    def get_summary(self) -> str:
        if not self.events:
            return (
                f"[{format_mmss(self.start_time)}-"
                f"{format_mmss(self.end_time)}] No events"
            )
        ordered = sorted(self.events, key=lambda e: e.timestamp)
        return "\n".join(e.format_compact() for e in ordered)


@dataclass
class TimelineConfig:
    """Tunables for merging, retrieval and transcript rendering."""

    merge_window_sec: float = 0.5
    dedupe_threshold: float = 0.9
    default_context_window: float = 30.0
    max_events_per_query: int = 50
    compact_format: bool = True
    include_low_priority: bool = False


def merge_event_run(run: Sequence[TimelineEvent]) -> TimelineEvent:
    """Collapse a run of same-modality/same-entity events into one.

    Earliest timestamp wins; up to three unique descriptions are joined with
    ``"; "``; priority is the most important in the run; duration spans the
    run; confidence is the max.
    """
    if len(run) == 1:
        return run[0]
    t0 = min(e.timestamp for e in run)
    descs = list(dict.fromkeys(e.description for e in run))
    return TimelineEvent(
        timestamp=t0,
        modality=run[0].modality,
        description="; ".join(descs[:3]),
        priority=min((e.priority for e in run), key=lambda p: p.value),
        duration=max(e.end_time for e in run) - t0,
        entity_id=run[0].entity_id,
        confidence=max(e.confidence for e in run),
    )


class EventMerger:
    """Merge temporally-adjacent events and drop near-duplicates."""

    def __init__(self, config: TimelineConfig):
        self.config = config

    def merge_nearby_events(
        self, events: Iterable[TimelineEvent]
    ) -> list[TimelineEvent]:
        """Chain-merge: an event joins the open run when it is within
        ``merge_window_sec`` of the run's *last* member and shares its
        modality and entity."""
        ordered = sorted(events, key=lambda e: e.timestamp)
        if not ordered:
            return []
        out: list[TimelineEvent] = []
        run: list[TimelineEvent] = [ordered[0]]
        for ev in ordered[1:]:
            tail = run[-1]
            joinable = (
                ev.timestamp - tail.timestamp <= self.config.merge_window_sec
                and ev.modality is tail.modality
                and ev.entity_id == tail.entity_id
            )
            if joinable:
                run.append(ev)
            else:
                out.append(merge_event_run(run))
                run = [ev]
        out.append(merge_event_run(run))
        return out

    def deduplicate(
        self, events: Iterable[TimelineEvent]
    ) -> list[TimelineEvent]:
        """First event wins per ``modality:description[:50]`` key."""
        seen: set[str] = set()
        unique: list[TimelineEvent] = []
        for ev in events:
            key = ev.dedupe_key()
            if key not in seen:
                seen.add(key)
                unique.append(ev)
        return unique


class TimelineIndexer:
    """Time-sorted multi-modal event store with range/entity/modality queries.

    Events are kept sorted by timestamp at insertion time (bisect insort), so
    range queries are a binary search plus a slice.  Secondary indices hold
    per-modality and per-entity views.

    Example::

        indexer = TimelineIndexer()
        indexer.add_event(83.0, ModalityType.VISUAL,
                          "Boss: HP drops to 50%", entity_id="boss_dragon_001")
        indexer.add_event(84.0, ModalityType.AUDIO, "roar")
        indexer.build_structured_transcript()
        # "[01:23] Boss: HP drops to 50%\n[01:24] (Audio: roar)"
    """

    def __init__(self, config: Optional[TimelineConfig] = None):
        self.config = config or TimelineConfig()
        self.merger = EventMerger(self.config)
        self._events: list[TimelineEvent] = []       # sorted by timestamp
        self._keys: list[float] = []                 # parallel timestamp keys
        self._by_modality: dict[ModalityType, list[TimelineEvent]] = {
            m: [] for m in ModalityType
        }
        self._by_entity: dict[str, list[TimelineEvent]] = {}
        self._min_time = float("inf")
        self._max_time = float("-inf")

    # ------------------------------------------------------------------ add

    def add_event(
        self,
        timestamp: float,
        modality: ModalityType,
        description: str,
        priority: EventPriority = EventPriority.MEDIUM,
        duration: float = 0.0,
        entity_id: Optional[str] = None,
        confidence: float = 1.0,
        metadata: Optional[dict] = None,
    ) -> TimelineEvent:
        """Insert one event, keeping the store time-sorted."""
        event = TimelineEvent(
            timestamp=timestamp,
            modality=modality,
            description=description,
            priority=priority,
            duration=duration,
            entity_id=entity_id,
            confidence=confidence,
            metadata=metadata or {},
        )
        self._insert(event)
        return event

    def _insert(self, event: TimelineEvent) -> None:
        # insort_right keeps insertion order stable for equal timestamps
        pos = bisect.bisect_right(self._keys, event.timestamp)
        self._keys.insert(pos, event.timestamp)
        self._events.insert(pos, event)
        self._by_modality[event.modality].append(event)
        if event.entity_id:
            self._by_entity.setdefault(event.entity_id, []).append(event)
        self._min_time = min(self._min_time, event.timestamp)
        self._max_time = max(self._max_time, event.end_time)

    def add_events_batch(self, events: list[dict]) -> list[TimelineEvent]:
        return [self.add_event(**kw) for kw in events]

    # ------------------------------------------------- perception adapters
    # Duck-typed ingestion from each perception subsystem (reference
    # timeline_indexer.py:367-436 adapter surface).

    def add_from_hico_tokens(self, tokens: Iterable[Any]) -> None:
        """Ingest hierarchical-compression tokens (``TemporalToken`` ducks)."""
        for tok in tokens:
            level = tok.compression_level
            self.add_event(
                timestamp=tok.start_time,
                modality=ModalityType.TEMPORAL,
                description=f"Temporal context ({tok.source_frame_count} frames)",
                duration=tok.end_time - tok.start_time,
                metadata={
                    "compression_level": getattr(level, "value", level)
                },
            )

    def add_from_sam_entities(
        self, entities: Iterable[Any], frame_idx: int, timestamp: float
    ) -> None:
        """Ingest tracked-entity detections (``TrackedEntity`` ducks)."""
        for ent in entities:
            mask = ent.frame_masks.get(frame_idx)
            if mask is None:
                continue
            self.add_event(
                timestamp=timestamp,
                modality=ModalityType.VISUAL,
                description=f"{ent.concept_label} detected",
                entity_id=ent.entity_id,
                confidence=mask.confidence,
                metadata={"bbox": mask.bbox.to_xyxy()},
            )

    def add_from_ocr_frame(self, ocr_frame: Any) -> None:
        """Ingest one frame of OCR detections (``OCRFrame`` duck)."""
        for det in ocr_frame.detections:
            important = det.category in ("damage", "health")
            self.add_event(
                timestamp=ocr_frame.timestamp,
                modality=ModalityType.OCR,
                description=det.text,
                confidence=det.confidence,
                priority=EventPriority.MEDIUM if important else EventPriority.LOW,
                metadata={"category": det.category, "bbox": det.bbox},
            )

    def add_from_audio_result(self, audio_result: Any) -> None:
        """Ingest ASR segments + audio events (``AudioAnalysisResult`` duck)."""
        for seg in audio_result.transcriptions:
            self.add_event(
                timestamp=seg.start_time,
                modality=ModalityType.SPEECH,
                description=seg.text,
                duration=seg.duration,
                confidence=seg.confidence,
            )
        for ev in audio_result.events:
            self.add_event(
                timestamp=ev.start_time,
                modality=ModalityType.AUDIO,
                description=ev.description,
                duration=ev.duration,
                confidence=ev.confidence,
            )

    # ---------------------------------------------------------------- query

    def _range_slice(
        self, start_time: Optional[float], end_time: Optional[float]
    ) -> list[TimelineEvent]:
        """Inclusive-both-ends time slice via binary search."""
        lo = 0 if start_time is None else bisect.bisect_left(self._keys, start_time)
        hi = (
            len(self._keys)
            if end_time is None
            else bisect.bisect_right(self._keys, end_time)
        )
        return self._events[lo:hi]

    def _filtered(
        self,
        start_time: Optional[float],
        end_time: Optional[float],
        modalities: Optional[list[ModalityType]],
    ) -> list[TimelineEvent]:
        events = self._range_slice(start_time, end_time)
        if modalities:
            allowed = set(modalities)
            events = [e for e in events if e.modality in allowed]
        if not self.config.include_low_priority:
            events = [e for e in events if e.priority is not EventPriority.LOW]
        return list(events)

    def query_range(
        self,
        start_time: float,
        end_time: float,
        modalities: Optional[list[ModalityType]] = None,
    ) -> list[TimelineEvent]:
        """Events with ``start_time <= t <= end_time`` (LOW dropped unless configured)."""
        return self._filtered(start_time, end_time, modalities)

    def query_around_timestamp(
        self, timestamp: float, window: Optional[float] = None
    ) -> list[TimelineEvent]:
        """Events within a centered window (total width ``window`` seconds)."""
        half = (window or self.config.default_context_window) / 2
        return self.query_range(timestamp - half, timestamp + half)

    def query_by_entity(
        self,
        entity_id: str,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
    ) -> list[TimelineEvent]:
        events = self._by_entity.get(entity_id, [])
        if start_time is not None:
            events = [e for e in events if e.timestamp >= start_time]
        if end_time is not None:
            events = [e for e in events if e.timestamp <= end_time]
        return sorted(events, key=lambda e: e.timestamp)

    def query_by_modality(self, modality: ModalityType) -> list[TimelineEvent]:
        return sorted(self._by_modality[modality], key=lambda e: e.timestamp)

    # ------------------------------------------------------------ rendering

    def build_structured_transcript(
        self,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
        modalities: Optional[list[ModalityType]] = None,
        max_events: Optional[int] = None,
    ) -> str:
        """Render the primary LLM-facing transcript.

        When over budget, keeps the most important events
        (priority-then-time order) and re-sorts the survivors by time.
        """
        events = self._filtered(start_time, end_time, modalities)
        budget = max_events or self.config.max_events_per_query
        if len(events) > budget:
            events.sort(key=lambda e: (e.priority.value, e.timestamp))
            events = sorted(events[:budget], key=lambda e: e.timestamp)
        fmt = (
            TimelineEvent.format_compact
            if self.config.compact_format
            else TimelineEvent.format_verbose
        )
        return "\n".join(fmt(e) for e in events)

    def get_segments(self, segment_duration: float = 10.0) -> list[TimelineSegment]:
        """Partition [min_time, max_time) into fixed windows (end-exclusive)."""
        if not self._events:
            return []
        segments = []
        start = self._min_time
        while start < self._max_time:
            end = start + segment_duration
            lo = bisect.bisect_left(self._keys, start)
            hi = bisect.bisect_left(self._keys, end)
            segments.append(
                TimelineSegment(
                    start_time=start,
                    end_time=end,
                    events=list(self._events[lo:hi]),
                )
            )
            start = end
        return segments

    # -------------------------------------------------------- maintenance

    def merge_and_dedupe(self) -> int:
        """Merge adjacent bursts, drop duplicates, rebuild indices.

        Returns the number of events removed.
        """
        before = len(self._events)
        merged = self.merger.merge_nearby_events(self._events)
        unique = self.merger.deduplicate(merged)
        self._rebuild(unique)
        removed = before - len(self._events)
        logger.info("Timeline merge/dedupe: %d -> %d events", before, len(self._events))
        return removed

    def _rebuild(self, events: list[TimelineEvent]) -> None:
        ordered = sorted(events, key=lambda e: e.timestamp)
        self._events = ordered
        self._keys = [e.timestamp for e in ordered]
        self._by_modality = {m: [] for m in ModalityType}
        self._by_entity = {}
        for e in ordered:
            self._by_modality[e.modality].append(e)
            if e.entity_id:
                self._by_entity.setdefault(e.entity_id, []).append(e)

    def get_statistics(self) -> dict:
        return {
            "total_events": len(self._events),
            "unique_entities": len(self._by_entity),
            "time_range": (self._min_time, self._max_time),
            "duration": (self._max_time - self._min_time) if self._events else 0,
            "events_by_modality": {
                m.value: len(evs) for m, evs in self._by_modality.items()
            },
        }

    def clear(self) -> None:
        self._rebuild([])
        self._min_time = float("inf")
        self._max_time = float("-inf")

    @property
    def events(self) -> list[TimelineEvent]:
        """Time-ordered view of all events (read-only by convention)."""
        return self._events


def create_timeline_indexer(
    merge_window: float = 0.5,
    max_events_per_query: int = 50,
) -> TimelineIndexer:
    """Factory with the framework's default tunables."""
    return TimelineIndexer(
        TimelineConfig(
            merge_window_sec=merge_window,
            max_events_per_query=max_events_per_query,
        )
    )
