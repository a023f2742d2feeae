"""Autonomous tool calling: parse, execute, and re-prompt.

The model requests external lookups by emitting
``<tool_call>search_web("query")</tool_call>`` lines; this module extracts
them, routes them to the knowledge searcher (or reports unavailability in
offline environments), strips the calls from the visible text, and formats
results for the second generation pass.  The port's copy of
:mod:`gvl_tpu.agent.tools`.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class ToolCall:
    tool_name: str
    arguments: str
    raw_match: str


class ToolCallParser:
    """Extracts and executes ``<tool_call>name("args")</tool_call>``."""

    TOOL_CALL_PATTERN = re.compile(
        r'<tool_call>\s*(\w+)\s*\(\s*["\'](.+?)["\']\s*\)\s*</tool_call>',
        re.IGNORECASE | re.DOTALL,
    )

    def __init__(self, knowledge_searcher=None):
        self._knowledge_searcher = knowledge_searcher
        self._available_tools = {"search_web"}

    def parse_tool_calls(self, text: str) -> list[ToolCall]:
        calls = []
        for match in self.TOOL_CALL_PATTERN.finditer(text):
            name = match.group(1).lower()
            if name in self._available_tools:
                calls.append(
                    ToolCall(
                        tool_name=name,
                        arguments=match.group(2),
                        raw_match=match.group(0),
                    )
                )
        return calls

    def has_tool_calls(self, text: str) -> bool:
        return bool(self.TOOL_CALL_PATTERN.search(text))

    def execute_tool(self, tool_call: ToolCall) -> str:
        logger.info("tool call: %s(%r)", tool_call.tool_name, tool_call.arguments)
        if tool_call.tool_name == "search_web":
            return self._search(tool_call.arguments)
        return f"[Unknown tool: {tool_call.tool_name}]"

    def _search(self, query: str) -> str:
        if self._knowledge_searcher is not None:
            try:
                return self._knowledge_searcher.execute_tool_call(query, "general")
            except Exception as exc:  # network failures degrade gracefully
                logger.warning("knowledge search failed: %s", exc)
                return f"[Search failed: {exc}]"
        return "[Search unavailable: no knowledge searcher configured]"

    def execute_all_tools(self, text: str) -> tuple[str, list[str]]:
        """Run every call; return (text with calls removed, results)."""
        calls = self.parse_tool_calls(text)
        if not calls:
            return text, []
        results = []
        cleaned = text
        for call in calls:
            results.append(self.execute_tool(call))
            cleaned = cleaned.replace(call.raw_match, "")
        return cleaned.strip(), results

    @staticmethod
    def format_tool_results_for_prompt(results: list[str]) -> str:
        if not results:
            return ""
        out = "\n\n## Tool Results\n\n"
        if len(results) == 1:
            out += results[0] + "\n"
        else:
            for i, result in enumerate(results, 1):
                out += f"### Result {i}\n{result}\n\n"
        out += (
            "\nNow use these results to provide a complete answer to the "
            "user's question.\n"
        )
        return out
