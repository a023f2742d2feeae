"""Trigger detection: when does perception wake the reasoning core?

A trigger fires when a visual detection label contains one of the
configured concepts, or an audio event matches the audio vocabulary, at or
above the confidence threshold — with a cooldown so a persistent boss on
screen doesn't re-trigger every frame.  The port's copy of
:mod:`gvl_tpu.agent.trigger`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from gvl_tpu_torch.agent.config import ReasoningCoreConfig

logger = logging.getLogger(__name__)


@dataclass
class TriggerEvent:
    timestamp: float
    trigger_type: str  # "concept" | "audio" | "threshold"
    source: str
    confidence: float
    details: dict = field(default_factory=dict)


class TriggerDetector:
    """Scans per-frame perception outputs for activation events."""

    def __init__(self, config: ReasoningCoreConfig, cooldown_sec: float = 1.0):
        self.config = config
        self.pending_triggers: list[TriggerEvent] = []
        self._last_trigger_time: float = 0.0
        self._cooldown_sec = cooldown_sec

    def check_visual_trigger(
        self, detections: list[dict], timestamp: float
    ) -> Optional[TriggerEvent]:
        """First detection whose label contains a trigger concept wins."""
        threshold = self.config.trigger_confidence_threshold
        for det in detections:
            label = det.get("label", "").lower()
            confidence = det.get("confidence", 0.0)
            if confidence < threshold:
                continue
            concept = next(
                (c for c in self.config.trigger_concepts if c.lower() in label),
                None,
            )
            if concept is not None:
                return TriggerEvent(
                    timestamp=timestamp,
                    trigger_type="concept",
                    source="segmenter",
                    confidence=confidence,
                    details={"label": label, "concept": concept},
                )
        return None

    def check_audio_trigger(
        self, audio_events: list[dict], timestamp: float
    ) -> Optional[TriggerEvent]:
        threshold = self.config.trigger_confidence_threshold
        for event in audio_events:
            kind = event.get("event", "").lower()
            confidence = event.get("confidence", 0.0)
            if confidence < threshold:
                continue
            if any(t.lower() in kind for t in self.config.audio_trigger_events):
                return TriggerEvent(
                    timestamp=timestamp,
                    trigger_type="audio",
                    source="audio",
                    confidence=confidence,
                    details={"event": kind},
                )
        return None

    def process_frame(
        self,
        timestamp: float,
        visual_detections: Optional[list[dict]] = None,
        audio_events: Optional[list[dict]] = None,
    ) -> Optional[TriggerEvent]:
        """Check all sources under the cooldown; visual has priority."""
        if timestamp - self._last_trigger_time < self._cooldown_sec:
            return None
        trigger = None
        if visual_detections:
            trigger = self.check_visual_trigger(visual_detections, timestamp)
        if trigger is None and audio_events:
            trigger = self.check_audio_trigger(audio_events, timestamp)
        if trigger is not None:
            self._last_trigger_time = timestamp
            self.pending_triggers.append(trigger)
            logger.info("trigger fired: %s", trigger.details)
        return trigger

    def get_pending_triggers(self) -> list[TriggerEvent]:
        """Drain the pending-trigger queue."""
        triggers = list(self.pending_triggers)
        self.pending_triggers.clear()
        return triggers
