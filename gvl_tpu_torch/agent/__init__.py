"""Agent core: conversation, retrieval, tools, triggers, prompts, reasoning
(the port's copy of :mod:`gvl_tpu.agent`).

Everything here is host code except the chat backends, which drive the
port's Qwen3 engines and its Qwen3-VL model on the card."""

from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.agent.conversation import ConversationHistory, ConversationTurn
from gvl_tpu_torch.agent.confidence import ConfidenceScorer
from gvl_tpu_torch.agent.tools import ToolCall, ToolCallParser
from gvl_tpu_torch.agent.trigger import TriggerDetector, TriggerEvent
from gvl_tpu_torch.agent.temporal_context import TemporalContextManager
from gvl_tpu_torch.agent.retriever import HashingTextEmbedder, TimelineRetriever
from gvl_tpu_torch.agent.special_tokens import SpecialTokens
from gvl_tpu_torch.agent.core import (
    Qwen3ChatBackend,
    Qwen3VLChatBackend,
    ReasoningCore,
    TemplateFakeBackend,
    TimelineGroundedFakeBackend,
    VisualInputProcessor,
    create_reasoning_core,
)
from gvl_tpu_torch.agent.loop import PerceptionReasoningLoop, create_perception_loop
from gvl_tpu_torch.agent.search import (
    GameDetector,
    GameKnowledgeSearcher,
    SearchCache,
    create_search_enhanced_system_prompt,
)

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
    "SpecialTokens",
    "Qwen3ChatBackend",
    "Qwen3VLChatBackend",
    "ReasoningCore",
    "TemplateFakeBackend",
    "TimelineGroundedFakeBackend",
    "VisualInputProcessor",
    "create_reasoning_core",
    "PerceptionReasoningLoop",
    "create_perception_loop",
    "GameKnowledgeSearcher",
    "GameDetector",
    "SearchCache",
    "create_search_enhanced_system_prompt",
]
