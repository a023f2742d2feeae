"""Top-level perception-reasoning orchestrator (the port's copy of
:mod:`gvl_tpu.agent.loop`).

Streams per-frame perception outputs, fires the trigger detector, projects
multimodal embeddings through the ProjectorBank, and activates the
reasoning core: projected tokens are passed as the LLM's
``inputs_embeds`` prefix (capped) besides the textual multimodal-context
summary.  A prefix whose width is not the engine's hidden size is dropped
by the chat backend, so with the QA model only the summary's row counts
reach the prompt.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.agent.core import ReasoningCore, create_reasoning_core
from gvl_tpu_torch.agent.temporal_context import TemporalContextManager
from gvl_tpu_torch.agent.trigger import TriggerDetector, TriggerEvent

logger = logging.getLogger(__name__)

# how many projected tokens may enter inputs_embeds per modality
_MAX_INJECTED_TOKENS = 16


class PerceptionReasoningLoop:
    """Trigger-gated reasoning over streaming perception outputs.

    >>> loop = PerceptionReasoningLoop()
    >>> loop.start()
    >>> response = loop.process_frame(
    ...     timestamp=12.0,
    ...     visual_detections=[{"label": "boss", "confidence": 0.95}],
    ... )
    """

    def __init__(
        self,
        config: Optional[ReasoningCoreConfig] = None,
        timeline_indexer=None,
        knowledge_base=None,
        projector_weights_path: Optional[str] = None,
        reasoning_core: Optional[ReasoningCore] = None,
        llm_checkpoint_path: Optional[str] = None,
        lora_path: Optional[str] = None,
        projectors=None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or ReasoningCoreConfig()
        self.reasoning_core = reasoning_core or create_reasoning_core(
            self.config, checkpoint_path=llm_checkpoint_path,
            lora_path=lora_path, device=device,
        )
        self.trigger_detector = TriggerDetector(self.config)
        self.temporal_context = TemporalContextManager(self.config)
        self.projector_weights_path = projector_weights_path
        if projectors is not None:
            # a pre-built (weights-loaded) bank shared across videos —
            # bank init + weight load dominate per-video loop setup
            self.projectors = projectors
        else:
            from gvl_tpu_torch.models.projector import ProjectorBank

            self.projectors = ProjectorBank(self.config, device=device).init()
            if projector_weights_path and \
                    Path(projector_weights_path).exists():
                self.projectors.load_weights(projector_weights_path)

        self.timeline_indexer = timeline_indexer
        self.knowledge_base = knowledge_base

        self._is_running = False
        self._current_timestamp = 0.0
        self._pending_query: Optional[str] = None

    # ------------------------------------------------------------- control

    def start(self) -> None:
        self._is_running = True

    def stop(self) -> None:
        self._is_running = False
        self.temporal_context.clear()

    def set_query(self, query: str) -> None:
        self._pending_query = query

    def add_hico_context(self, timestamp: float, embedding) -> None:
        self.temporal_context.add_context(timestamp, embedding)

    # ------------------------------------------------------------ pipeline

    def process_frame(
        self,
        frame: Any = None,
        timestamp: float = 0.0,
        visual_detections: Optional[list[dict]] = None,
        audio_events: Optional[list[dict]] = None,
        ocr_results: Optional[list[dict]] = None,
        region_embeddings: Optional[np.ndarray] = None,
        videomae_embeddings: Optional[np.ndarray] = None,
        audio_embeddings: Optional[np.ndarray] = None,
        force_reason: bool = False,
    ) -> Optional[str]:
        """Trigger check → query selection → projection → reasoning."""
        if not self._is_running:
            return None
        self._current_timestamp = timestamp

        trigger = self.trigger_detector.process_frame(
            timestamp=timestamp,
            visual_detections=visual_detections,
            audio_events=audio_events,
        )
        if trigger is None and not force_reason:
            return None

        query = self._pending_query
        if query is None:
            query = (
                self._generate_trigger_query(trigger)
                if trigger else "Describe what's happening in this frame."
            )

        all_detections = list(visual_detections or [])
        for ocr in ocr_results or []:
            all_detections.append({
                "label": f"text: {ocr.get('text', '')}",
                "confidence": ocr.get("confidence", 0.0),
                "bbox": ocr.get("bbox", []),
            })

        temporal_summary = self.temporal_context.get_context_summary()
        projected = self.project_embeddings(
            siglip_embeddings=region_embeddings,
            videomae_embeddings=videomae_embeddings,
            audio_embeddings=audio_embeddings,
        )
        multimodal_context = self.get_multimodal_context(projected)

        context_parts = []
        if temporal_summary:
            context_parts.append(f"[Temporal Context: {temporal_summary}]")
        if multimodal_context:
            context_parts.append(multimodal_context)
        full_context = "\n".join(context_parts)
        full_query = f"{query}\n\n{full_context}" if full_context else query

        response = self.reasoning_core.reason(
            query=full_query,
            current_frame=frame,
            timeline_indexer=self.timeline_indexer,
            knowledge_base=self.knowledge_base,
            region_detections=all_detections,
            inputs_embeds_prefix=self.build_embedding_prefix(projected),
        )
        self._pending_query = None
        return response

    @staticmethod
    def _generate_trigger_query(trigger: TriggerEvent) -> str:
        if trigger.trigger_type == "concept":
            concept = trigger.details.get("concept", "object")
            return (
                f"A {concept} was just detected. "
                f"Describe what's happening with it."
            )
        if trigger.trigger_type == "audio":
            event = trigger.details.get("event", "sound")
            return f"An audio event '{event}' was detected. What's happening?"
        return "Something triggered. Describe the current situation."

    def reason_now(self, query: str, frame: Any = None) -> str:
        return self.reasoning_core.reason(
            query=query,
            current_frame=frame,
            timeline_indexer=self.timeline_indexer,
            knowledge_base=self.knowledge_base,
        )

    # ---------------------------------------------------------- projection

    def project_embeddings(
        self,
        siglip_embeddings=None,
        videomae_embeddings=None,
        audio_embeddings=None,
    ) -> dict[str, np.ndarray]:
        """Raw encoder embeddings → LLM-space tokens via the ProjectorBank."""
        projected: dict[str, np.ndarray] = {}
        if siglip_embeddings is not None and len(siglip_embeddings):
            projected["siglip"] = np.asarray(
                self.projectors.project_region(np.asarray(siglip_embeddings))
            )
        if videomae_embeddings is not None and len(videomae_embeddings):
            projected["videomae"] = np.asarray(
                self.projectors.project_videomae(np.asarray(videomae_embeddings))
            )
        if audio_embeddings is not None and len(audio_embeddings):
            projected["audio"] = np.asarray(
                self.projectors.project_audio(np.asarray(audio_embeddings))
            )
        return projected

    @staticmethod
    def get_multimodal_context(projected: dict[str, np.ndarray]) -> str:
        parts = []
        if "siglip" in projected:
            parts.append(
                f"[{projected['siglip'].shape[0]} visual region embeddings "
                f"available]"
            )
        if "videomae" in projected:
            parts.append(
                f"[{projected['videomae'].shape[0]} temporal video embeddings "
                f"available]"
            )
        if "audio" in projected:
            parts.append(
                f"[{projected['audio'].shape[0]} audio embeddings available]"
            )
        return "[Multimodal Context: " + ", ".join(parts) + "]" if parts else ""

    @staticmethod
    def build_embedding_prefix(
        projected: dict[str, np.ndarray]
    ) -> Optional[np.ndarray]:
        """Stack projected tokens (capped per modality) for inputs_embeds."""
        chunks = [
            np.asarray(projected[name])[:_MAX_INJECTED_TOKENS]
            for name in ("siglip", "videomae", "audio") if name in projected
        ]
        if not chunks:
            return None
        return np.concatenate(chunks, axis=0)

    # -------------------------------------------------------------- status

    def get_status(self) -> dict:
        return {
            "is_running": self._is_running,
            "current_timestamp": self._current_timestamp,
            "pending_query": self._pending_query,
            "temporal_context": self.temporal_context.get_context_summary(),
            "pending_triggers": len(self.trigger_detector.pending_triggers),
            "projector_weights_loaded": self.projector_weights_path is not None,
            "ttft": self.reasoning_core.get_ttft_stats(),
        }


def create_perception_loop(
    config: Optional[ReasoningCoreConfig] = None,
    timeline_indexer=None,
    knowledge_base=None,
    projector_weights_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> PerceptionReasoningLoop:
    return PerceptionReasoningLoop(
        config=config,
        timeline_indexer=timeline_indexer,
        knowledge_base=knowledge_base,
        projector_weights_path=projector_weights_path,
        device=device,
    )
