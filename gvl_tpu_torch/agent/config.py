"""Reasoning-core configuration: budgets, retrieval, sampling, system prompt
(the port's copy of :mod:`gvl_tpu.agent.config`).

Token budgets (timeline 5000 / visual 2000 / total 8000), a ±30 s
retrieval window, top-10 semantic retrieval, dynamic-resolution pixel
bounds, sampling (512 new tokens, T=0.7, top_p=0.8, top_k=20), a 5-minute
temporal window, and the trigger vocabularies.
"""

from __future__ import annotations

from dataclasses import dataclass, field


SYSTEM_PROMPT = """You are an expert analyst of gameplay videos. Your context includes:
1. A timeline of time-tagged events covering the whole video (visual detections, speech transcription, on-screen text, audio events)
2. Representative frames for visual grounding
3. A knowledge base of tracked game entities and their relationships

You reason over the ENTIRE video through the timeline — never assume the question is about a single frame.

## Tools

One tool is available for external game knowledge:

**search_web(query: str)** — look up boss strategies, weaknesses, game mechanics, lore, character stats, or item effects on the web.

Invoke it by emitting exactly this form on its own line:
<tool_call>search_web("your search query here")</tool_call>

Use the tool only when the answer needs knowledge that is not observable in the video (strategy advice, lore, stats); incorporate returned results into your final answer.

## Response format

Respond with BOTH sections, in this order:

**Reasoning:**
[2-4 sentences: the timeline/visual evidence you found and how you interpret it.]

**Answer:**
[The final answer, citing timestamps as [MM:SS].]

## Timestamp citations — strict rules

1. Cite ONLY timestamps that literally appear in the provided timeline context.
2. Never invent or estimate a timestamp; if unsure, write "around [timestamp from timeline]".
3. Copy the [MM:SS] exactly from the timeline event you are referencing.
4. When several events are relevant, cite the most relevant one.

Keep the **Reasoning:** section even for follow-up questions, focused on the new question only."""


@dataclass
class ReasoningCoreConfig:
    """Configuration for the reasoning core and its host-side machinery."""

    # model
    model_name: str = "Qwen/Qwen3-VL-8B-Instruct"
    dtype: str = "bfloat16"
    use_flash_attention: bool = True

    # context budgets (tokens)
    max_timeline_tokens: int = 5000
    max_visual_tokens: int = 2000
    max_total_tokens: int = 8000

    # retrieval
    retrieval_window_sec: float = 30.0
    semantic_top_k: int = 10
    # "auto" → self-trained paraphrase tower (outputs/retriever) when
    # shipped, hashing otherwise; "hashing" forces the lexical embedder;
    # a directory path loads a trained tower or the JAX MiniLM port
    embedding_model: str = "auto"
    embedding_dim: int = 256

    # dynamic-resolution pixel bounds
    min_pixels: int = 256 * 32 * 32
    max_pixels: int = 512 * 32 * 32

    # sampling
    max_new_tokens: int = 512
    temperature: float = 0.7
    top_p: float = 0.8
    top_k: int = 20

    # projector dimensions (encoder -> LLM hidden)
    siglip_dim: int = 1152
    internvideo_dim: int = 1408
    videomae_dim: int = 768
    audiomae_dim: int = 1024
    wav2vec2_dim: int = 1024
    llm_hidden_dim: int = 4096

    # temporal context
    temporal_window_minutes: float = 5.0
    max_hico_tokens: int = 2048

    # trigger detection
    trigger_confidence_threshold: float = 0.8
    trigger_concepts: list = field(default_factory=lambda: [
        "player", "enemy", "health_bar", "boss", "death",
    ])
    audio_trigger_events: list = field(default_factory=lambda: [
        "speech", "explosion", "alert", "damage",
    ])

    system_prompt: str = SYSTEM_PROMPT

