"""The reasoning core: retrieval -> prompt assembly -> generation -> scoring
(the port's copy of :mod:`gvl_tpu.agent.core`).

- :class:`ReasoningCore` renders the prompt from the timeline, the
  knowledge base and the conversation, streams the backend's answer and
  runs the two-pass tool-call loop; its messages are held byte-identical
  to the JAX package's (``tests/test_torch_reasoning.py``).
- :class:`Qwen3ChatBackend` drives the port's Qwen3 engine with the Qwen
  chat template; :func:`create_qa_backend` serves the self-trained
  byte-level QA model behind it, :func:`create_hf_backend` an HF Qwen3
  checkpoint with its session, speculative or prompt-lookup engine.
- :class:`Qwen3VLChatBackend` serves Qwen3-VL: the frame resized as Pillow
  resizes it (:func:`gvl_tpu_torch.runtime.resize.pil_bilinear`),
  patchified and spliced into the prompt as image tokens.
- :class:`TemplateFakeBackend` and :class:`TimelineGroundedFakeBackend`
  are the deterministic no-weights backends.

LoRA adapters merge into the QA model and into an HF base
(:func:`~gvl_tpu_torch.models.qwen3.load_adapter_and_merge`).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Iterator, Optional, Protocol, Union

import numpy as np
import torch

from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.agent.confidence import ConfidenceScorer
from gvl_tpu_torch.agent.conversation import ConversationHistory
from gvl_tpu_torch.agent.retriever import TimelineRetriever
from gvl_tpu_torch.agent.tools import ToolCallParser

logger = logging.getLogger(__name__)


class VisualInputProcessor:
    """Dynamic-resolution frame dicts + region-token text (reference
    :1572-1644)."""

    def __init__(self, config: ReasoningCoreConfig):
        self.config = config

    def process_frame(self, image: Any, detail_level: str = "auto") -> dict:
        if detail_level == "low":
            min_pix, max_pix = 128 * 32 * 32, 256 * 32 * 32
        elif detail_level == "high":
            min_pix, max_pix = 512 * 32 * 32, 1024 * 32 * 32
        else:
            min_pix, max_pix = self.config.min_pixels, self.config.max_pixels
        return {
            "type": "image",
            "image": image,
            "min_pixels": min_pix,
            "max_pixels": max_pix,
        }

    @staticmethod
    def process_region_tokens(regions: list[dict]) -> str:
        if not regions:
            return ""
        lines = ["Detected regions in frame:"]
        for i, region in enumerate(regions):
            label = region.get("label", f"region_{i}")
            bbox = region.get("bbox", [])
            conf = region.get("confidence", 0.0)
            if bbox:
                lines.append(f"  - {label}: bbox={bbox}, confidence={conf:.2f}")
            else:
                lines.append(f"  - {label}: confidence={conf:.2f}")
        return "\n".join(lines)


class ChatBackend(Protocol):
    def stream(
        self,
        messages: list[dict],
        config: ReasoningCoreConfig,
        inputs_embeds_prefix: Optional[np.ndarray] = None,
    ) -> Iterator[str]: ...


def _messages_text(messages: list[dict]) -> str:
    chunks = []
    for message in messages:
        content = message.get("content", "")
        if isinstance(content, str):
            chunks.append(content)
        else:
            chunks.extend(
                part.get("text", "") for part in content
                if isinstance(part, dict) and part.get("type") == "text"
            )
    return "\n".join(chunks)


class TemplateFakeBackend:
    """Deterministic, context-grounded response generator (no weights)."""

    def stream(self, messages, config, inputs_embeds_prefix=None):
        text = _messages_text(messages)
        timestamps = re.findall(r"\[(\d{2}:\d{2})\]", text)
        question_match = re.search(r"## Question\n(.+)", text)
        question = question_match.group(1).strip() if question_match else "the scene"
        cite = f"[{timestamps[0]}]" if timestamps else "the available context"
        n_events = len(timestamps)
        reasoning = (
            f"**Reasoning:** The timeline context contains {n_events} "
            f"time-tagged events relevant to \"{question[:60]}\". "
            f"The earliest relevant observation occurs at {cite}."
        )
        answer = (
            f"**Answer:** Based on the timeline, the relevant activity "
            f"occurs at {cite}."
        )
        for piece in (reasoning + "\n\n" + answer).split(" "):
            yield piece + " "


def _lev_le1(a: str, b: str) -> bool:
    """Levenshtein(a, b) <= 1 (cheap OCR-noise tolerance)."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > 1:
        return False
    if la > lb:
        a, b, la, lb = b, a, lb, la
    # a is shorter or equal; try one substitution / one insertion
    i = j = diff = 0
    while i < la and j < lb:
        if a[i] == b[j]:
            i += 1
            j += 1
            continue
        diff += 1
        if diff > 1:
            return False
        if la == lb:
            i += 1
        j += 1
    return diff + (lb - j) <= 1


def _tokens(text: str) -> list[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


class TimelineGroundedFakeBackend:
    """Deterministic no-weights backend that READS the prompt it is given.

    Parses the question, MCQ options and retrieved timeline lines out of
    the rendered chat messages — the same information a real LLM sees —
    and answers from that context alone, in the mandated
    ``**Reasoning:**``/``**Answer:**`` format with ``[MM:SS]`` citations:

    - presence questions ("Does a boss appear …?") scan the retrieved
      events for the asked term (edit-distance ≤ 1 per token, so OCR'd
      text still matches);
    - MCQ options are scored by fuzzy token overlap against the events,
      with "None of …" chosen when nothing else grounds;
    - open questions cite the earliest retrieved event.

    A correct answer therefore proves the retrieval → prompt assembly →
    generation → parsing loop works end to end; the harness scoring >0 on
    grounded synthetic samples is a regression gate, not an accident.
    """

    _PRESENCE_RE = re.compile(
        r"(?:does|do|is|are)\b.*?\b(?:a|an|the|any)\s+([\w /-]+?)\s+"
        r"(?:appear|present|visible|show|occur)", re.IGNORECASE)

    def _parse_prompt(self, text: str):
        ctx = re.search(r"## Timeline Context\n(.*?)(?:\n## |\Z)",
                        text, re.DOTALL)
        events: list[tuple[str, str]] = []   # (MM:SS, line text)
        if ctx:
            for line in ctx.group(1).splitlines():
                m = re.match(r"\[(\d{1,2}:\d{2})\]\s*(.*)", line.strip())
                if m:
                    events.append((m.group(1), m.group(2)))
        # single-frame mode (BenchmarkModelRunner): no timeline — the
        # "[Visual Analysis]" detections are the groundable context
        va = re.search(r"\[Visual Analysis\]\n(.*?)(?:\n\n|\Z)",
                       text, re.DOTALL)
        if va:
            for line in va.group(1).splitlines():
                m = re.match(r"-\s*Detected:\s*(.+?)\s*\(", line.strip())
                if m:
                    events.append(("", m.group(1)))
        qm = re.search(r"## Question\n(.+)\Z", text, re.DOTALL)
        q_block = qm.group(1).strip() if qm else text[-500:]
        options = re.findall(r"^\s*\(?([A-H])\)\s*(.+)$", q_block,
                             re.MULTILINE)
        question = re.split(r"\n\s*Options:", q_block)[0].strip()
        return question, options, events

    @staticmethod
    def _term_in_events(term: str, events) -> Optional[str]:
        """Timestamp of the first event containing every token of
        ``term`` (edit distance ≤ 1 per token), else None."""
        want = _tokens(term)
        if not want:
            return None
        for ts, line in events:
            have = _tokens(line)
            if all(any(_lev_le1(w, h) for h in have) for w in want):
                return ts
        return None

    def _score_option(self, option: str, events) -> tuple[float, str]:
        """(best fraction of option tokens grounded in one event, ts)."""
        want = _tokens(option)
        if not want:
            return 0.0, ""
        best, best_ts = 0.0, ""
        for ts, line in events:
            have = _tokens(line)
            hit = sum(any(_lev_le1(w, h) for h in have) for w in want)
            frac = hit / len(want)
            if frac > best:
                best, best_ts = frac, ts
        return best, best_ts

    def stream(self, messages, config, inputs_embeds_prefix=None):
        question, options, events = self._parse_prompt(
            _messages_text(messages))
        opt_texts = [t.strip() for _, t in options]
        is_binary = (len(opt_texts) == 2 and
                     {t.lower() for t in opt_texts} == {"yes", "no"})

        if is_binary or (not options and re.search(
                r"\byes or no\b", question, re.IGNORECASE)):
            m = self._PRESENCE_RE.search(question)
            term = m.group(1) if m else None
            if term is None:
                quoted = re.search(r"['\"]([^'\"]+)['\"]", question)
                term = quoted.group(1) if quoted else question
            ts = self._term_in_events(term, events)
            if ts is not None:
                cite = f" at [{ts}]" if ts else " in the current frame"
                reasoning = (
                    f"**Reasoning:** The retrieved context contains a "
                    f"matching observation of \"{term.strip()}\"{cite}.")
                answer = (f"**Answer:** Yes — \"{term.strip()}\" appears"
                          f"{cite}.")
            else:
                reasoning = (
                    f"**Reasoning:** None of the {len(events)} retrieved "
                    f"timeline events mention \"{term.strip()}\".")
                answer = (f"**Answer:** No — \"{term.strip()}\" does not "
                          f"appear in the retrieved timeline.")
        elif options and (imp := re.search(
                r"sound at \[(\d{2}:\d{2})\] imply", question)):
            # audio-implication MCQ (VERDICT r3 #8): look up the audio
            # event AT the cited timestamp and answer with its gameplay
            # implication — the option text never matches the timeline
            # surface, so generic token-overlap scoring cannot solve it
            from gvl_tpu_torch.audio.event_model import CLASS_IMPLICATIONS

            ts = imp.group(1)
            desc = next(
                (line for ets, line in events
                 if ets == ts and "audio" in line.lower()), "")
            m = re.search(r"\(Audio:\s*([^)]+)\)", desc)
            implied = CLASS_IMPLICATIONS.get(m.group(1).strip()) if m \
                else None
            pick = 0
            if implied is not None:
                want = _tokens(implied)
                overlap = [
                    sum(any(_lev_le1(w, h) for h in _tokens(t))
                        for w in want) / max(len(want), 1)
                    for t in opt_texts]
                pick = int(max(range(len(opt_texts)),
                               key=lambda i: overlap[i]))
                reasoning = (
                    f"**Reasoning:** The timeline shows \"{m.group(1)}\" "
                    f"at [{ts}], which implies {implied}.")
            else:
                reasoning = (
                    f"**Reasoning:** No audio event is recorded at "
                    f"[{ts}] in the retrieved timeline.")
            answer = (f"**Answer:** {options[pick][0]}) "
                      f"{opt_texts[pick]}")
        elif options:
            none_idx = [i for i, t in enumerate(opt_texts)
                        if re.match(r"none\b", t, re.IGNORECASE)]
            scored = []
            for i, text in enumerate(opt_texts):
                if i in none_idx:
                    scored.append((0.0, ""))
                else:
                    scored.append(self._score_option(text, events))
            best = max(range(len(opt_texts)), key=lambda i: scored[i][0])
            if scored[best][0] < 0.5 and none_idx:
                pick = none_idx[0]
                reasoning = (
                    "**Reasoning:** No retrieved timeline event grounds "
                    "any of the listed options.")
            else:
                pick = best
                ts = scored[best][1]
                reasoning = (
                    f"**Reasoning:** Option {options[pick][0]} "
                    f"(\"{opt_texts[pick]}\") is supported by the "
                    f"timeline at [{ts}]." if ts else
                    f"**Reasoning:** Option {options[pick][0]} best "
                    f"matches the retrieved context.")
            answer = (f"**Answer:** {options[pick][0]}) "
                      f"{opt_texts[pick]}")
        else:
            cite = f"[{events[0][0]}]" if events else "the available context"
            reasoning = (
                f"**Reasoning:** The timeline context contains "
                f"{len(events)} time-tagged events relevant to "
                f"\"{question[:60]}\". The earliest relevant observation "
                f"occurs at {cite}.")
            answer = (f"**Answer:** Based on the timeline, the relevant "
                      f"activity occurs at {cite}.")

        for piece in (reasoning + "\n\n" + answer).split(" "):
            yield piece + " "


def messages_to_plain_text(messages: list[dict]) -> list[dict]:
    """Flatten typed content parts into plain-string messages."""
    out = []
    for message in messages:
        content = message.get("content", "")
        if not isinstance(content, str):
            content = "\n".join(
                part.get("text", "[image]") if part.get("type") == "text"
                else "[image]"
                for part in content
            )
        out.append({"role": message["role"], "content": content})
    return out


class Qwen3ChatBackend:
    """Qwen3 engine + tokenizer + Qwen ChatML rendering.

    ``stream(messages, config)`` yields text pieces as they decode;
    ``config`` carries ``max_new_tokens``, ``temperature``, ``top_p`` and
    ``top_k`` (e.g. :class:`gvl_tpu_torch.agent.config.ReasoningCoreConfig`).

    With ``spec_engine`` (a :class:`~gvl_tpu_torch.models.speculative.
    SpeculativeEngine` or ``PromptLookupEngine``), text-only turns decode
    speculatively; with ``session`` (a :class:`~gvl_tpu_torch.models.
    session.Qwen3ChatSession`), text-only turns reuse the conversation's KV
    cache and prefill only the transcript delta.  Turns with an embedding
    prefix always take the plain engine.  Priority: spec_engine > session >
    engine.
    """

    def __init__(self, engine, tokenizer, spec_engine=None, session=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.spec_engine = spec_engine
        self.session = session

    def _render(self, messages: list[dict]) -> list[int]:
        plain = messages_to_plain_text(messages)
        if hasattr(self.tokenizer, "apply_chat_template"):
            return self.tokenizer.apply_chat_template(
                plain, tokenize=True, add_generation_prompt=True)
        # manual Qwen ChatML rendering (the byte tokenizer has no template)
        parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                 for m in plain]
        parts.append("<|im_start|>assistant\n")
        return self.tokenizer.encode("".join(parts))

    def stream(self, messages, config, inputs_embeds_prefix=None):
        ids = self._render(messages)
        if inputs_embeds_prefix is not None:
            hid = getattr(getattr(self.engine, "config", None), "hidden_size", None)
            got = int(np.shape(inputs_embeds_prefix)[-1])
            if hid and got != hid:
                # projector output sized for a different LLM: degrade to
                # text-only rather than fail inside prefill
                logger.warning("dropping %d-dim embeds prefix (engine hidden %d)",
                               got, hid)
                inputs_embeds_prefix = None
        limit = getattr(getattr(self.engine, "config", None), "max_cache_length", None)
        if limit:
            # keep the HEAD (the system protocol) and the TAIL (recent
            # context + the question), drop the middle, and leave room for
            # the answer: an over-long prompt degrades instead of failing
            n_prefix = (0 if inputs_embeds_prefix is None
                        else int(np.shape(inputs_embeds_prefix)[0]))
            keep = max(limit - config.max_new_tokens - n_prefix, limit // 2)
            if len(ids) > keep:
                head = min(keep // 4, 1024)
                logger.warning(
                    "prompt %d tokens > budget %d (cache %d); middle-trimming "
                    "(head %d)", len(ids), keep, limit, head)
                ids = ids[:head] + ids[-(keep - head):]
        produced: list[int] = []
        emitted = 0
        if inputs_embeds_prefix is None and self.spec_engine is not None:
            engine, kwargs = self.spec_engine, {}
        elif inputs_embeds_prefix is None and self.session is not None:
            engine, kwargs = self.session, {}
        else:
            engine = self.engine
            kwargs = {"inputs_embeds_prefix": inputs_embeds_prefix}
        for token in engine.stream(
            ids,
            max_new_tokens=config.max_new_tokens,
            temperature=config.temperature,
            top_p=config.top_p,
            top_k=config.top_k,
            **kwargs,
        ):
            produced.append(token)
            text = self.tokenizer.decode(produced, skip_special_tokens=True)
            if len(text) > emitted and not text.endswith("�"):
                yield text[emitted:]
                emitted = len(text)


class Qwen3VLChatBackend:
    """Full multimodal backend: the attached frame is resized to
    ``image_size`` square, patchified and spliced as image tokens into the
    prompt (real pixels through the vision tower), as
    ``gvl_tpu.agent.core.Qwen3VLChatBackend``.

    Token protocol: ``<|vision_start|><|image_pad|>*N<|vision_end|>`` per
    frame, N the merged token count of the frame's grid; the image span
    goes first, before the system turn (the JAX code's order).
    ``cache_dtype`` is the decode cache's type (bf16 by default; the decode
    kernel reads bf16 only, ROADMAP C11) and ``generator`` the sampler's
    (temperature above 0).  ``last_tokens`` keeps the latest answer's ids.
    """

    def __init__(
        self,
        vl_model,            # gvl_tpu_torch.models.qwen3vl.Qwen3VL
        tokenizer,
        image_token_id: int = 151655,
        vision_start_id: int = 151652,
        vision_end_id: int = 151653,
        eos_token_id: int = 151645,
        image_size: int = 256,
        cache_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        self.vl = vl_model
        self.tokenizer = tokenizer
        self.image_token_id = image_token_id
        self.vision_start_id = vision_start_id
        self.vision_end_id = vision_end_id
        self.eos_token_id = eos_token_id
        self.image_size = image_size
        self.cache_dtype = cache_dtype
        self.generator = generator
        self.last_tokens: list[int] = []

    def _extract_frame(self, messages):
        for message in messages:
            content = message.get("content", "")
            if isinstance(content, list):
                for part in content:
                    if isinstance(part, dict) and part.get("type") == "image":
                        return part.get("image")
        return None

    def _prepare(self, messages):
        """(input_ids [1, S], patches, grid): image tokens inline when a
        frame is attached."""
        from gvl_tpu_torch.models.qwen3vl import patchify_frames
        from gvl_tpu_torch.runtime.resize import pil_bilinear

        frame = self._extract_frame(messages)
        patches = grid = None
        image_ids: list[int] = []
        if frame is not None:
            arr = np.asarray(frame)
            if arr.ndim == 3:
                arr = arr[None]  # single frame -> [1, H, W, 3]
            side = self.image_size
            arr = np.stack([pil_bilinear(f.astype(np.uint8), (side, side)) for f in arr])
            patches, grid = patchify_frames(arr, self.vl.vision_config)
            merge = self.vl.vision_config.spatial_merge_size ** 2
            n_tokens = patches.shape[0] // merge
            image_ids = ([self.vision_start_id]
                         + [self.image_token_id] * n_tokens
                         + [self.vision_end_id])

        parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                 for m in messages_to_plain_text(messages)]
        parts.append("<|im_start|>assistant\n")
        ids = image_ids + list(self.tokenizer.encode("".join(parts)))
        return np.asarray([ids], np.int64), patches, grid

    def stream(self, messages, config, inputs_embeds_prefix=None):
        ids, patches, grid = self._prepare(messages)
        self.last_tokens = self.vl.generate(
            ids, patches, grid,
            max_new_tokens=config.max_new_tokens,
            temperature=config.temperature,
            top_p=config.top_p,
            top_k=config.top_k,
            eos_token_id=self.eos_token_id,
            generator=self.generator,
            cache_dtype=self.cache_dtype,
        )
        produced: list[int] = []
        emitted = 0
        for token in self.last_tokens:
            produced.append(token)
            text = self.tokenizer.decode(produced, skip_special_tokens=True)
            if len(text) > emitted and not text.endswith("�"):
                yield text[emitted:]
                emitted = len(text)


class ReasoningCore:
    """Retrieval-augmented multimodal reasoning with multi-turn memory.

    Method surface (as ``gvl_tpu.agent.core.ReasoningCore``):
    ``reason`` / ``reason_streaming`` / ``build_prompt`` /
    ``format_timeline_context`` / ``index_timeline`` / conversation
    save-load.
    """

    def __init__(
        self,
        config: Optional[ReasoningCoreConfig] = None,
        backend: Optional[ChatBackend] = None,
        knowledge_searcher=None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or ReasoningCoreConfig()
        self.backend = backend or TimelineGroundedFakeBackend()
        self.retriever = TimelineRetriever(self.config, device=device)
        self.visual_processor = VisualInputProcessor(self.config)
        self.conversation_history = ConversationHistory()
        self.confidence_scorer = ConfidenceScorer()
        self._knowledge_searcher = knowledge_searcher
        self.tool_parser = ToolCallParser(knowledge_searcher)
        self._last_retrieved_events: list = []
        # p50 TTFT is a tracked north-star metric (BASELINE.md)
        self.last_ttft_sec: Optional[float] = None
        self._ttft_history: list = []

    # ------------------------------------------------------------ indexing

    def index_timeline(self, timeline_indexer) -> None:
        self.retriever.index_timeline(timeline_indexer)

    # ------------------------------------------------------------- prompts

    def format_timeline_context(
        self, events: list, max_tokens: Optional[int] = None
    ) -> str:
        """Compact event lines under a ~4 chars/token budget."""
        if not events:
            return "No relevant events found in timeline."
        char_limit = (max_tokens or self.config.max_timeline_tokens) * 4
        lines, used = [], 0
        for event in sorted(events, key=lambda e: e.timestamp):
            line = (
                event.format_compact()
                if hasattr(event, "format_compact")
                else f"[{int(event.timestamp // 60):02d}:"
                     f"{int(event.timestamp % 60):02d}] {event.description}"
            )
            if used + len(line) > char_limit:
                lines.append("... (more events truncated)")
                break
            lines.append(line)
            used += len(line)
        return "\n".join(lines)

    def build_prompt(
        self,
        query: str,
        timeline_context: str,
        current_frame: Any = None,
        region_tokens: Optional[str] = None,
        knowledge_base_context: Optional[str] = None,
        include_conversation_history: bool = True,
        web_search_results: Optional[str] = None,
    ) -> list[dict]:
        """Assemble the chat message list (system + history + user turn)."""
        system_text = self.config.system_prompt
        if (
            include_conversation_history
            and self.conversation_history.get_turn_count() > 0
        ):
            system_text += (
                "\n\nYou have access to the conversation history. Use it to "
                "understand follow-up questions and maintain context."
            )
        ctx = getattr(self._knowledge_searcher, "game_context", None)
        if ctx is not None and getattr(ctx, "game_name", None):
            system_text += f"\n\nCurrent game: **{ctx.game_name}**"
            if getattr(ctx, "game_genre", None):
                system_text += f" ({ctx.game_genre})"

        messages: list[dict] = [
            {"role": "system", "content": [{"type": "text", "text": system_text}]}
        ]
        if include_conversation_history:
            messages.extend(self.conversation_history.get_messages_for_chat())

        user_content: list[dict] = []
        if current_frame is not None:
            user_content.append(self.visual_processor.process_frame(current_frame))

        context_parts = []
        if timeline_context:
            context_parts.append("## Timeline Context\n" + timeline_context)
        if region_tokens:
            context_parts.append("## Visual Regions\n" + region_tokens)
        if knowledge_base_context:
            # export_for_llm already emits the section header; only add
            # one for bare-context callers (was double-headed before)
            kb = knowledge_base_context
            if not kb.lstrip().startswith("## Entity Knowledge Base"):
                kb = "## Entity Knowledge Base\n" + kb
            context_parts.append(kb)
        if web_search_results:
            context_parts.append(web_search_results)
        if (
            include_conversation_history
            and self.conversation_history.is_follow_up_query(query)
        ):
            conv = self.conversation_history.get_context_for_prompt(
                max_recent_turns=4
            )
            if conv:
                context_parts.append("## Recent Conversation\n" + conv)
        if context_parts:
            user_content.append(
                {"type": "text", "text": "\n\n".join(context_parts)}
            )
        user_content.append(
            {"type": "text", "text": f"\n## Question\n{query}"}
        )
        messages.append({"role": "user", "content": user_content})
        return messages

    # ------------------------------------------------------------- reason

    def _prepare(
        self,
        query: str,
        timeline_indexer,
        knowledge_base,
        region_detections,
        video_timestamp,
        track_conversation: bool,
        current_frame,
    ) -> tuple[list[dict], Optional[float]]:
        if self.conversation_history.is_follow_up_query(query):
            if video_timestamp is None:
                video_timestamp = (
                    self.conversation_history.get_last_mentioned_timestamp()
                )
        elif video_timestamp is None:
            # record the moment the user asked about so follow-ups anchor
            video_timestamp = self.retriever.parse_timestamp(query)
        if timeline_indexer is not None:
            self.retriever.index_timeline(timeline_indexer)
        events = self.retriever.hybrid_retrieve(query, timeline_indexer)
        self._last_retrieved_events = events
        # byte-level engines (the trained QA-LM rung) have 1 token ==
        # 1 byte, so the reference's ~4-chars/token budgets overflow
        # their cache ~4x on event-dense videos and the backend's
        # emergency trim then cuts real context.  When the backend
        # declares its byte capacity, fit each section to it up front.
        # No backend declares one (ROADMAP C3): kept equal to the JAX
        # package, whose prompts this one is held to byte for byte.
        byte_budget = getattr(self.backend, "context_byte_budget", None)
        if byte_budget:
            avail = max(int(byte_budget) - self.config.max_new_tokens
                        - 256, 512)        # 256 = ChatML + question slack
            timeline_context = self.format_timeline_context(
                events, max_tokens=max(avail * 35 // 100 // 4, 64))
        else:
            timeline_context = self.format_timeline_context(events)

        region_tokens = (
            self.visual_processor.process_region_tokens(region_detections)
            if region_detections else None
        )
        kb_context = (
            knowledge_base.export_for_llm(max_entities=15, max_relationships=20)
            if knowledge_base is not None else None
        )
        if byte_budget and kb_context:
            kb_cap = avail * 30 // 100
            if len(kb_context) > kb_cap:
                kb_context = kb_context[:kb_cap] + "\n... (truncated)"
        messages = self.build_prompt(
            query=query,
            timeline_context=timeline_context,
            current_frame=current_frame,
            region_tokens=region_tokens,
            knowledge_base_context=kb_context,
            include_conversation_history=track_conversation,
        )
        return messages, video_timestamp

    def reason(
        self,
        query: str,
        current_frame: Any = None,
        timeline_indexer=None,
        knowledge_base=None,
        region_detections: Optional[list[dict]] = None,
        video_timestamp: Optional[float] = None,
        track_conversation: bool = True,
        return_confidence: bool = False,
        inputs_embeds_prefix: Optional[np.ndarray] = None,
    ) -> Union[str, tuple[str, float]]:
        """Full pipeline; returns the response (optionally with confidence)."""
        pieces = list(
            self.reason_streaming(
                query,
                current_frame=current_frame,
                timeline_indexer=timeline_indexer,
                knowledge_base=knowledge_base,
                region_detections=region_detections,
                video_timestamp=video_timestamp,
                track_conversation=track_conversation,
                inputs_embeds_prefix=inputs_embeds_prefix,
            )
        )
        response = "".join(pieces).strip()
        confidence = self.confidence_scorer.score_response(
            query, response, context_events=self._last_retrieved_events
        )
        return (response, confidence) if return_confidence else response

    def reason_streaming(
        self,
        query: str,
        current_frame: Any = None,
        timeline_indexer=None,
        knowledge_base=None,
        region_detections: Optional[list[dict]] = None,
        video_timestamp: Optional[float] = None,
        track_conversation: bool = True,
        inputs_embeds_prefix: Optional[np.ndarray] = None,
    ) -> Iterator[str]:
        """Stream response pieces; runs the two-pass tool-call loop."""
        import time as _time

        t_start = _time.perf_counter()
        messages, video_timestamp = self._prepare(
            query, timeline_indexer, knowledge_base, region_detections,
            video_timestamp, track_conversation, current_frame,
        )

        pieces: list[str] = []
        first = True
        for piece in self.backend.stream(
            messages, self.config, inputs_embeds_prefix=inputs_embeds_prefix
        ):
            if first:
                self.last_ttft_sec = _time.perf_counter() - t_start
                self._ttft_history.append(self.last_ttft_sec)
                first = False
            pieces.append(piece)
            yield piece
        response = "".join(pieces)

        # tool-call pass: execute, re-prompt, stream the final answer
        if self.tool_parser.has_tool_calls(response):
            cleaned, results = self.tool_parser.execute_all_tools(response)
            tool_block = self.tool_parser.format_tool_results_for_prompt(results)
            followup = self.build_prompt(
                query=query,
                timeline_context=self.format_timeline_context(
                    self._last_retrieved_events
                ),
                current_frame=current_frame,
                include_conversation_history=track_conversation,
                web_search_results=tool_block,
            )
            yield "\n"
            pieces = ["\n"]
            for piece in self.backend.stream(followup, self.config):
                pieces.append(piece)
                yield piece
            response = cleaned + "".join(pieces)

        if track_conversation:
            self.conversation_history.add_user_message(
                query, video_timestamp=video_timestamp
            )
            confidence = self.confidence_scorer.score_response(
                query, response, context_events=self._last_retrieved_events
            )
            self.conversation_history.add_assistant_message(
                response.strip(), confidence=confidence
            )

    # -------------------------------------------------------- conversation

    def clear_conversation(self) -> None:
        self.conversation_history.clear()

    def save_conversation(self, path: str) -> None:
        self.conversation_history.save(path)

    def load_conversation(self, path: str) -> None:
        self.conversation_history = ConversationHistory.load(path)

    def get_ttft_stats(self) -> dict:
        """p50/p95 time-to-first-token over this session."""
        if not self._ttft_history:
            return {"count": 0, "p50_sec": None, "p95_sec": None}
        import numpy as _np

        arr = _np.asarray(self._ttft_history)
        return {
            "count": len(arr),
            "p50_sec": float(_np.percentile(arr, 50)),
            "p95_sec": float(_np.percentile(arr, 95)),
            "last_sec": float(arr[-1]),
        }

    def get_conversation_summary(self) -> dict:
        last = self.conversation_history.get_last_assistant_response()
        return {
            "turn_count": self.conversation_history.get_turn_count(),
            "timestamps_mentioned":
                self.conversation_history.get_mentioned_timestamps(),
            "last_query": self.conversation_history.get_last_user_query(),
            "last_response": (last[:100] + "...") if last else None,
        }


def create_qa_backend(checkpoint_path, device="cuda", lora_path=None) -> Qwen3ChatBackend:
    """The self-trained byte-level QA model behind a chat backend, served
    by the port's engine on ``device``; with ``lora_path`` (a directory
    holding ``adapter_config.json``) its LoRA adapter merged in first.

    ROADMAP C6, settled as JAX's branch: an adapter whose tensors do not
    fit the base geometry (``ValueError`` from
    :func:`~gvl_tpu_torch.models.qwen3.load_adapter_and_merge`) is skipped
    with a warning and the base weights are served; any other failure
    (an unreadable npz or config) raises, as in JAX, where the reference's
    PEFT ladder falls back on every exception."""
    from pathlib import Path

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine, load_adapter_and_merge
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    config, state_dict = load_qa_lm(checkpoint_path, device=device)
    if lora_path and Path(lora_path, "adapter_config.json").exists():
        try:
            config, state_dict = load_adapter_and_merge(config, state_dict, lora_path)
        except ValueError as exc:
            # stale adapter trained over a different base geometry: serve
            # the base weights rather than dying at merge time
            logger.warning("skipping LoRA adapter %s: %s", lora_path, exc)
    engine = Qwen3Engine(config, state_dict, eos_token_id=EOS_ID, device=device)
    return Qwen3ChatBackend(engine, ByteTokenizer())


def create_hf_backend(checkpoint_path, device="cuda", lora_path=None,
                      draft_checkpoint_path=None, speculative_gamma: int = 4,
                      use_prompt_lookup: bool = False) -> Qwen3ChatBackend:
    """An HF Qwen3 checkpoint (a directory with its tokenizer) behind a chat
    backend on ``device``, as the JAX factory's HF branch builds it: a LoRA
    adapter at ``lora_path`` merged in first, unguarded as in JAX (ROADMAP
    C12: a tensor whose shape misfits the base raises ``ValueError``, a
    config without ``lora_rank`` ``KeyError``, both in the merge; targets
    the base does not have add nothing), then a :class:`~gvl_tpu_torch.models.speculative.SpeculativeEngine`
    with the draft checkpoint, else a ``PromptLookupEngine`` when
    ``use_prompt_lookup``, else a :class:`~gvl_tpu_torch.models.session.
    Qwen3ChatSession` for text-only turns.  The weights are moved to the
    device once and shared by every engine."""
    from pathlib import Path

    from transformers import AutoTokenizer

    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine, load_adapter_and_merge, load_hf_qwen3

    device = resolve_device(device)

    def load(path):
        config, state = load_hf_qwen3(path)
        return config, {k: v.to(device) for k, v in state.items()}

    config, state = load(checkpoint_path)
    if lora_path and Path(lora_path, "adapter_config.json").exists():
        config, state = load_adapter_and_merge(config, state, lora_path)
    tokenizer = AutoTokenizer.from_pretrained(checkpoint_path)
    engine = Qwen3Engine(config, state, device=device)
    spec_engine = session = None
    if draft_checkpoint_path:
        from gvl_tpu_torch.models.speculative import SpeculativeEngine

        draft_config, draft_state = load(draft_checkpoint_path)
        spec_engine = SpeculativeEngine(config, state, draft_config, draft_state,
                                        gamma=speculative_gamma,
                                        eos_token_id=engine.eos_token_id, device=device)
    elif use_prompt_lookup:
        from gvl_tpu_torch.models.speculative import PromptLookupEngine

        spec_engine = PromptLookupEngine(config, state, gamma=speculative_gamma,
                                         eos_token_id=engine.eos_token_id, device=device)
    else:
        # multi-turn prefix caching: later turns prefill only the delta
        from gvl_tpu_torch.models.session import Qwen3ChatSession

        session = Qwen3ChatSession(config, state, eos_token_id=engine.eos_token_id,
                                   device=device)
    return Qwen3ChatBackend(engine, tokenizer, spec_engine=spec_engine, session=session)


def create_vl_backend(vl_checkpoint_path, device="cuda") -> Qwen3VLChatBackend:
    """An HF Qwen3-VL checkpoint (``Qwen3VLForConditionalGeneration`` and its
    tokenizer) behind :class:`Qwen3VLChatBackend` on ``device``, with the
    checkpoint's image and vision-span token ids (and, as in JAX, the
    default mRoPE sections of Qwen3-VL-8B)."""
    from transformers import AutoTokenizer, Qwen3VLForConditionalGeneration

    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.models.qwen3vl import Qwen3VL, convert_hf_qwen3vl

    device = resolve_device(device)
    hf = Qwen3VLForConditionalGeneration.from_pretrained(vl_checkpoint_path)
    vision_cfg, text_cfg, state = convert_hf_qwen3vl(hf)
    cfg = hf.config
    vl = Qwen3VL(vision_cfg, text_cfg, state, image_token_id=cfg.image_token_id,
                 device=device)
    tokenizer = AutoTokenizer.from_pretrained(vl_checkpoint_path)
    return Qwen3VLChatBackend(vl, tokenizer, image_token_id=cfg.image_token_id,
                              vision_start_id=cfg.vision_start_token_id,
                              vision_end_id=cfg.vision_end_token_id)


def create_reasoning_core(
    config: Optional[ReasoningCoreConfig] = None,
    checkpoint_path: Optional[str] = None,
    lora_path: Optional[str] = None,
    knowledge_searcher=None,
    vl_checkpoint_path: Optional[str] = None,
    draft_checkpoint_path: Optional[str] = None,
    speculative_gamma: int = 4,
    use_prompt_lookup: bool = False,
    device: str | torch.device = "cuda",
) -> ReasoningCore:
    """Factory (``gvl_tpu.agent.core.create_reasoning_core``) on ``device``:
    the Qwen3-VL backend for ``vl_checkpoint_path``
    (:func:`create_vl_backend`), else the QA model when ``checkpoint_path``
    is a qa_lm checkpoint (:func:`create_qa_backend`; ``lora_path`` with
    ROADMAP C6's fallback), else an HF Qwen3 checkpoint
    (:func:`create_hf_backend`: ``lora_path``, then
    ``draft_checkpoint_path`` with ``speculative_gamma``, else
    ``use_prompt_lookup``, else the session engine), else the grounded fake.
    """
    from gvl_tpu_torch.training.qa_lm_train import is_qa_lm_checkpoint

    config = config or ReasoningCoreConfig()
    if vl_checkpoint_path:
        backend = create_vl_backend(vl_checkpoint_path, device=device)
    elif checkpoint_path and is_qa_lm_checkpoint(checkpoint_path):
        backend = create_qa_backend(checkpoint_path, device=device, lora_path=lora_path)
    elif checkpoint_path:
        backend = create_hf_backend(checkpoint_path, device=device, lora_path=lora_path,
                                    draft_checkpoint_path=draft_checkpoint_path,
                                    speculative_gamma=speculative_gamma,
                                    use_prompt_lookup=use_prompt_lookup)
    else:
        backend = TimelineGroundedFakeBackend()
    return ReasoningCore(config, backend=backend,
                         knowledge_searcher=knowledge_searcher, device=device)
