"""Special-token vocabulary for multimodal interleaving (the port's copy of
:mod:`gvl_tpu.agent.special_tokens`).

Data-schema reservation for splicing projected embeddings between text
tokens: ``<ts=MM:SS>`` timestamp markers plus per-modality placeholders
(``<v>`` video, ``<r>`` region, ``<a>`` audio; ``*_emb`` variants mark
positions that receive real ``inputs_embeds`` injection).  Parity surface:
reference `qwen_reasoning_core.py:755-832`.
"""

from __future__ import annotations

import re
from typing import Optional


class SpecialTokens:
    """Token constants + interleaved-context formatting."""

    TIMESTAMP_PREFIX = "<ts="
    TIMESTAMP_SUFFIX = ">"
    VIDEO_TOKEN = "<v>"
    REGION_TOKEN = "<r>"
    AUDIO_TOKEN = "<a>"
    VIDEO_EMB = "<v_emb>"
    REGION_EMB = "<r_emb>"
    AUDIO_EMB = "<a_emb>"

    _TS_RE = re.compile(r"<ts=(\d+):(\d+)>")

    @staticmethod
    def format_timestamp(seconds: float) -> str:
        return f"<ts={int(seconds // 60):02d}:{int(seconds % 60):02d}>"

    @classmethod
    def parse_timestamp(cls, token: str) -> Optional[float]:
        match = cls._TS_RE.match(token)
        if not match:
            return None
        mins, secs = int(match.group(1)), int(match.group(2))
        return float(mins * 60 + secs)

    @classmethod
    def modality_token(cls, modality: str, embedding: bool) -> str:
        table = {
            "visual": (cls.REGION_TOKEN, cls.REGION_EMB),
            "audio": (cls.AUDIO_TOKEN, cls.AUDIO_EMB),
            "video": (cls.VIDEO_TOKEN, cls.VIDEO_EMB),
        }
        if modality not in table:
            return ""
        return table[modality][1 if embedding else 0]

    @classmethod
    def format_interleaved_context(
        cls, events: list, include_embeddings: bool = False
    ) -> str:
        """``<ts=MM:SS> [<mod>] description`` per event."""
        lines = []
        for event in events:
            ts = cls.format_timestamp(event.timestamp)
            modality = getattr(event, "modality", "text")
            modality = getattr(modality, "value", modality)  # Enum or str
            mod = cls.modality_token(modality, include_embeddings)
            lines.append(
                f"{ts} {mod} {event.description}" if mod
                else f"{ts} {event.description}"
            )
        return "\n".join(lines)
