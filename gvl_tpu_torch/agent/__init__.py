"""Agent core: conversation, retrieval, tools, triggers, prompts, reasoning
(the port's copy of :mod:`gvl_tpu.agent`; the web search is
:mod:`gvl_tpu_torch.agent.search`).

Everything here is host code except the chat backend, which drives the
port's Qwen3 engine on the card."""

from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.agent.conversation import ConversationHistory, ConversationTurn
from gvl_tpu_torch.agent.confidence import ConfidenceScorer
from gvl_tpu_torch.agent.tools import ToolCall, ToolCallParser
from gvl_tpu_torch.agent.trigger import TriggerDetector, TriggerEvent
from gvl_tpu_torch.agent.temporal_context import TemporalContextManager
from gvl_tpu_torch.agent.retriever import HashingTextEmbedder, TimelineRetriever
from gvl_tpu_torch.agent.core import (
    Qwen3ChatBackend,
    ReasoningCore,
    TemplateFakeBackend,
    TimelineGroundedFakeBackend,
    create_reasoning_core,
)
from gvl_tpu_torch.agent.loop import PerceptionReasoningLoop, create_perception_loop

__all__ = [
    "ReasoningCoreConfig",
    "ConversationHistory",
    "ConversationTurn",
    "ConfidenceScorer",
    "ToolCall",
    "ToolCallParser",
    "TriggerDetector",
    "TriggerEvent",
    "TemporalContextManager",
    "HashingTextEmbedder",
    "TimelineRetriever",
    "Qwen3ChatBackend",
    "ReasoningCore",
    "TemplateFakeBackend",
    "TimelineGroundedFakeBackend",
    "create_reasoning_core",
    "PerceptionReasoningLoop",
    "create_perception_loop",
]
