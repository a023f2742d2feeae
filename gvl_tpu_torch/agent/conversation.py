"""Multi-turn conversation memory with rolling summarization.

Keeps the last ``max_turns`` turns verbatim; older turns collapse into a
rolling one-line-per-turn summary prefix.  Tracks every video timestamp the
user has asked about so follow-ups ("what happened next?") can anchor to
the last discussed moment.  The port's copy of
:mod:`gvl_tpu.agent.conversation`.
"""

from __future__ import annotations

import json
import logging
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

# Heuristic follow-up cues: anaphora, continuations, bare why/how questions.
_FOLLOW_UP_PATTERNS = [re.compile(p) for p in (
    r"\bwhat happened next\b",
    r"\bwhat about\b",
    r"\band then\b",
    r"\bafter that\b",
    r"\bbefore that\b",
    r"\bwhy did (he|she|they|it|the player)\b",
    r"\bwhat did (he|she|they|it|the player) do\b",
    r"\bcan you explain more\b",
    r"\btell me more\b",
    r"\bwhat else\b",
    r"\bhow did that happen\b",
    r"\bwhy\?$",
    r"^why\b",
    r"^how\b",
    r"^what\b.*\bthat\b",
    r"\bthe same\b",
    r"\bit\b.*\?$",
)]


@dataclass
class ConversationTurn:
    """One user or assistant turn."""

    role: str
    content: str
    timestamp: float
    metadata: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "role": self.role,
            "content": self.content,
            "timestamp": self.timestamp,
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ConversationTurn":
        return cls(
            role=data["role"],
            content=data["content"],
            timestamp=data.get("timestamp", time.time()),
            metadata=data.get("metadata", {}),
        )


class ConversationHistory:
    """Rolling multi-turn memory.

    >>> history = ConversationHistory(max_turns=20)
    >>> history.add_user_message("What happened at 5:30?", video_timestamp=330)
    >>> history.add_assistant_message("The player defeated the boss.")
    >>> history.is_follow_up_query("what happened next?")
    True
    """

    def __init__(
        self,
        max_turns: int = 20,
        max_tokens_estimate: int = 4000,
        summarize_after: int = 15,
    ):
        self.max_turns = max_turns
        self.max_tokens_estimate = max_tokens_estimate
        self.summarize_after = summarize_after
        self._turns: list[ConversationTurn] = []
        self._summary: Optional[str] = None
        self._video_timestamps_mentioned: list[float] = []
        self._session_start: float = time.time()

    # ------------------------------------------------------------- mutate

    def add_user_message(
        self,
        content: str,
        video_timestamp: Optional[float] = None,
        metadata: Optional[dict] = None,
    ) -> None:
        meta = dict(metadata or {})
        if video_timestamp is not None:
            meta["video_timestamp"] = video_timestamp
            self._video_timestamps_mentioned.append(video_timestamp)
        self._append(ConversationTurn("user", content, time.time(), meta))

    def add_assistant_message(
        self,
        content: str,
        confidence: Optional[float] = None,
        metadata: Optional[dict] = None,
    ) -> None:
        meta = dict(metadata or {})
        if confidence is not None:
            meta["confidence"] = confidence
        self._append(ConversationTurn("assistant", content, time.time(), meta))

    def _append(self, turn: ConversationTurn) -> None:
        self._turns.append(turn)
        overflow = len(self._turns) - self.max_turns
        if overflow > 0:
            evicted, self._turns = self._turns[:overflow], self._turns[overflow:]
            digest = self._digest(evicted)
            self._summary = f"{self._summary}\n{digest}" if self._summary else digest

    @staticmethod
    def _digest(turns: list[ConversationTurn]) -> str:
        """One clipped line per evicted turn, wrapped in a summary marker."""
        parts = []
        for t in turns:
            label = "User" if t.role == "user" else "Assistant"
            text = t.content if len(t.content) <= 100 else t.content[:100] + "..."
            parts.append(f"{label}: {text}")
        return "[Earlier conversation summary: " + " | ".join(parts) + "]"

    # -------------------------------------------------------------- query

    def get_context_for_prompt(
        self,
        include_summary: bool = True,
        max_recent_turns: Optional[int] = None,
    ) -> str:
        parts: list[str] = []
        if include_summary and self._summary:
            parts.append(self._summary)
        turns = self._turns[-max_recent_turns:] if max_recent_turns else self._turns
        for t in turns:
            label = "User" if t.role == "user" else "Assistant"
            parts.append(f"{label}: {t.content}")
        return "\n".join(parts)

    def get_messages_for_chat(self) -> list[dict]:
        """Chat-template message list (content as typed parts)."""
        return [
            {"role": t.role, "content": [{"type": "text", "text": t.content}]}
            for t in self._turns
        ]

    def get_last_user_query(self) -> Optional[str]:
        return next(
            (t.content for t in reversed(self._turns) if t.role == "user"), None
        )

    def get_last_assistant_response(self) -> Optional[str]:
        return next(
            (t.content for t in reversed(self._turns) if t.role == "assistant"),
            None,
        )

    def get_mentioned_timestamps(self) -> list[float]:
        return list(self._video_timestamps_mentioned)

    def get_last_mentioned_timestamp(self) -> Optional[float]:
        return (
            self._video_timestamps_mentioned[-1]
            if self._video_timestamps_mentioned
            else None
        )

    def get_turn_count(self) -> int:
        return len(self._turns)

    @staticmethod
    def is_follow_up_query(query: str) -> bool:
        """Heuristic: does this query need prior conversation context?"""
        q = query.lower().strip()
        return any(p.search(q) for p in _FOLLOW_UP_PATTERNS)

    def clear(self) -> None:
        self._turns.clear()
        self._summary = None
        self._video_timestamps_mentioned.clear()
        self._session_start = time.time()

    # ---------------------------------------------------------- serialize

    def to_dict(self) -> dict:
        return {
            "turns": [t.to_dict() for t in self._turns],
            "summary": self._summary,
            "video_timestamps_mentioned": self._video_timestamps_mentioned,
            "session_start": self._session_start,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ConversationHistory":
        history = cls()
        history._turns = [
            ConversationTurn.from_dict(t) for t in data.get("turns", [])
        ]
        history._summary = data.get("summary")
        history._video_timestamps_mentioned = data.get(
            "video_timestamps_mentioned", []
        )
        history._session_start = data.get("session_start", time.time())
        return history

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "ConversationHistory":
        return cls.from_dict(json.loads(Path(path).read_text()))
