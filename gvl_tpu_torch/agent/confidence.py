"""Heuristic response-confidence estimation.

The port's copy of :mod:`gvl_tpu.agent.confidence`.  Four additive
factors: context availability (≤0.3),
timestamp citations (≤0.25), response structure (≤0.25) and
query-specificity match (≤0.2); optionally rescaled by mean token
probability into [0.5x, 1x].
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

_CITATION = re.compile(r"\[?\d{1,2}:\d{2}\]?")
_QUERY_TIME = re.compile(r"\d{1,2}:\d{2}")


class ConfidenceScorer:
    """Scores a response in [0, 1]."""

    def __init__(self, min_events_for_high_confidence: int = 3):
        self.min_events_for_high_confidence = min_events_for_high_confidence

    def score_response(
        self,
        query: str,
        response: str,
        context_events: Optional[Sequence] = None,
        token_probs: Optional[Sequence[float]] = None,
    ) -> float:
        total = (
            self._context_factor(context_events)
            + self._citation_factor(response)
            + self._structure_factor(response)
            + self._specificity_factor(query, response)
        )
        if token_probs:
            total *= 0.5 + 0.5 * (sum(token_probs) / len(token_probs))
        return min(1.0, max(0.0, total))

    def _context_factor(self, events: Optional[Sequence]) -> float:
        """0-0.3: how much retrieved evidence backed the answer."""
        if not events:
            return 0.0
        n = len(events)
        return 0.3 if n >= self.min_events_for_high_confidence else 0.1 * n

    @staticmethod
    def _citation_factor(response: str) -> float:
        """0-0.25: 0.05 per [MM:SS] citation, capped."""
        n = len(_CITATION.findall(response))
        return min(0.25, 0.05 * n) if n else 0.0

    @staticmethod
    def _structure_factor(response: str) -> float:
        """0-0.25: rewards the Reasoning/Answer scaffold."""
        if len(response) <= 50:
            return 0.05
        has_reasoning = (
            "**Reasoning:**" in response or "because" in response.lower()
        )
        has_answer = "**Answer:**" in response
        if has_reasoning and has_answer:
            return 0.25
        if has_reasoning or has_answer:
            return 0.15
        return 0.1

    @staticmethod
    def _specificity_factor(query: str, response: str) -> float:
        """0-0.2: a time-anchored question should get a time-cited answer."""
        query_timed = bool(_QUERY_TIME.search(query))
        response_cited = bool(_CITATION.search(response))
        if query_timed and response_cited:
            return 0.2
        if not query_timed:
            return 0.15
        return 0.05
