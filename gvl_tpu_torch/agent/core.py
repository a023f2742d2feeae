"""Chat backend of the reasoning core over the port's Qwen3 engine.

Counterpart of ``gvl_tpu.agent.core.Qwen3ChatBackend`` and
``messages_to_plain_text``, plus :func:`create_qa_backend`, the port's
form of the QA-model branch of ``gvl_tpu.agent.core.create_reasoning_core``.
LoRA adapters are not ported yet.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


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
    ``top_k`` (e.g. :class:`gvl_tpu_torch.agent.config.GenerationConfig`).

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


def create_qa_backend(checkpoint_path, device="cuda") -> Qwen3ChatBackend:
    """The self-trained byte-level QA model behind a chat backend, served
    by the port's engine on ``device``."""
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    config, state_dict = load_qa_lm(checkpoint_path, device=device)
    engine = Qwen3Engine(config, state_dict, eos_token_id=EOS_ID, device=device)
    return Qwen3ChatBackend(engine, ByteTokenizer())
