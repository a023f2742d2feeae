"""Multi-turn chat session with a persistent KV cache (prefix caching).

Counterpart of :mod:`gvl_tpu.models.session`.  A session keeps its cache
across turns and ingests only the transcript delta (the new user turn) as
one chunk at the current cache offset: the ``chunk_verify`` attention mode
(each chunk row attends over the cached prefix plus its causal part of the
chunk) makes the chunk exact, so a turn's prefill costs O(new tokens), not
O(transcript).  A prompt that does not extend the cached transcript starts
the cache over.

The delta is padded to a :data:`DELTA_BUCKETS` size, as in the JAX package.
Where the cached prefix plus that bucket would pass ``max_cache_length``,
the session starts over from offset 0 with the whole prompt, the remedy of
the batching engine's admission: the JAX session writes the padded bucket
anyway, its ``dynamic_update_slice`` start clamps, and the write lands on
the cached prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import (
    KVCache,
    Qwen3Config,
    call_generator,
    load_model,
    sample_logits,
)

DELTA_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def delta_bucket(n: int, max_cache_length: int) -> int:
    """The padded size of an n-token delta."""
    size = next((b for b in DELTA_BUCKETS if n <= b), max_cache_length)
    return min(size, max_cache_length)


class Qwen3ChatSession:
    """One conversation, one persistent KV cache.

    >>> session = Qwen3ChatSession(config, state_dict, device="cuda")
    >>> out1 = session.generate(turn1_ids, temperature=0.0)
    >>> out2 = session.generate(turn1_ids + out1 + turn2_ids)  # only the
    ...     # delta is prefilled; see last_ingested

    Greedy outputs equal a fresh :class:`~gvl_tpu_torch.models.qwen3.
    Qwen3Engine` on the full transcript (same weights; an f32 cache gives
    equal tokens, a bf16 cache may flip near-tied argmaxes).
    """

    def __init__(self, config: Qwen3Config, state_dict: dict[str, torch.Tensor],
                 eos_token_id: int = 151645, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        self.config = dataclasses.replace(config, chunk_verify=True)
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        self.device = resolve_device(device)
        self.model = load_model(self.config, state_dict, self.device)
        self.cache: Optional[KVCache] = None
        self._cached: list[int] = []   # tokens whose K/V live in the cache
        self.last_ingested: int = 0    # delta size of the latest turn

    def reset(self) -> None:
        self.cache = None
        self._cached = []

    def cache_nbytes(self) -> int:
        """Device bytes one live session pins (K+V, all layers)."""
        cfg = self.config
        return (2 * cfg.num_layers * cfg.num_kv_heads * cfg.max_cache_length
                * cfg.head_dim * self.dtype.itemsize)

    def release(self) -> None:
        """Drop the KV cache's tensors now (the server's eviction path), so
        their memory returns to PyTorch's allocator for other requests."""
        self.reset()

    @torch.inference_mode()
    def stream(
        self,
        prompt_ids,
        max_new_tokens: int = 512,
        temperature: float = 0.7,
        top_p: float = 0.8,
        top_k: int = 20,
        generator: Optional[torch.Generator] = None,
    ) -> Iterator[int]:
        """Yield generated token ids; reuses the cached transcript prefix
        (without ``generator``, sampled from a new one seeded 0)."""
        cfg = self.config
        generator = call_generator(generator, self.device)
        ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if len(ids) + max_new_tokens > cfg.max_cache_length:
            raise ValueError("prompt + max_new_tokens exceeds cache")

        if self.cache is None:
            self.cache = KVCache.zeros(cfg, 1, dtype=self.dtype, device=self.device)
            self._cached = []
        elif ids[:len(self._cached)] != self._cached:
            # not an extension of the cached transcript: start over (stale
            # rows past the length are masked and overwritten)
            self.cache.length = 0
            self._cached = []
        delta = ids[len(self._cached):]
        if not delta:
            # same transcript re-asked: re-ingest the final token so there
            # are logits to sample from
            delta = ids[-1:]
            self._cached = self._cached[:-1]
            self.cache.length -= 1
        size = delta_bucket(len(delta), cfg.max_cache_length)
        if len(self._cached) + size > cfg.max_cache_length:
            # the padded delta would run past the cache: ingest the whole
            # prompt from offset 0 instead (it fits: len(ids) < S_max)
            self.cache.length = 0
            self._cached = []
            delta = ids
            size = delta_bucket(len(delta), cfg.max_cache_length)
        self.last_ingested = len(delta)

        offset = self.cache.length
        tokens = torch.tensor([delta + [0] * (size - len(delta))],
                              device=self.device)
        positions = torch.arange(offset, offset + size, device=self.device)
        logits, _ = self.model(tokens, positions=positions, cache=self.cache)
        # the padded rows stay in the cache past the length: masked, then
        # overwritten by the next writes
        self.cache.length = offset + len(delta)
        token = sample_logits(logits[:, len(delta) - 1], generator,
                              temperature, top_p, top_k)
        self._cached = list(ids)

        for _ in range(max_new_tokens):
            tok = int(token[0])
            if tok == self.eos_token_id:
                return
            yield tok
            self._cached.append(tok)
            length = self.cache.length
            logits, _ = self.model(
                token[:, None].long(),
                positions=torch.arange(length, length + 1, device=self.device),
                cache=self.cache)
            token = sample_logits(logits[:, -1], generator, temperature, top_p,
                                  top_k)

    def generate(self, prompt_ids, **kw) -> list[int]:
        return list(self.stream(prompt_ids, **kw))
