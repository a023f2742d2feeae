"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of :mod:`gvl_tpu.models.speculative`.  The draft proposes
``gamma`` tokens, then the target scores ``[last token] + proposal`` in one
chunk forward against its KV cache (``chunk_verify``).  Greedy mode accepts
the longest prefix on which the target's argmax agrees with the draft and
emits the target's argmax at the first disagreement, so the output is the
target's greedy decode.  Stochastic mode applies the rejection rule (accept
``d_i`` with probability ``min(1, p(d_i) / q(d_i))``; on rejection sample
from ``norm(max(0, p - q))``), so the output is distributed as the target's
samples.  The random numbers come from a ``torch.Generator``: the port does
not reproduce ``jax.random``'s bits, only the rule.

Both caches roll back between rounds by resetting their lengths: rejected
rows past the length are masked out of every read and overwritten later.
Each round reads its result back from the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import KVCache, Qwen3Config, call_generator, load_model

PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, maximum: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return min(b, maximum)
    return maximum


class SpeculativeEngine:
    """Draft-verify decoding around two Qwen3 models, batch size 1.

    >>> engine = SpeculativeEngine(target_cfg, target_state, draft_cfg,
    ...                            draft_state, gamma=4, device="cuda")
    >>> tokens = engine.generate(prompt_ids, max_new_tokens=64,
    ...                          temperature=0.0)   # == target greedy
    >>> engine.last_stats["acceptance_rate"]

    Both models run with ``chunk_verify=True``, so every multi-token forward
    (prompt ingest, draft catch-up, verify) is a chunk at the cache offset.
    """

    def __init__(
        self,
        target_config: Qwen3Config,
        target_state: dict[str, torch.Tensor],
        draft_config: Qwen3Config,
        draft_state: dict[str, torch.Tensor],
        gamma: int = 4,
        eos_token_id: int = 151645,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        self.gamma = int(gamma)
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        self.device = resolve_device(device)
        self.target_config = dataclasses.replace(target_config, chunk_verify=True)
        self.draft_config = dataclasses.replace(draft_config, chunk_verify=True)
        self.mesh = mesh          # tensor-parallel: every model rank calls alike
        self.target_model = load_model(self.target_config, target_state, self.device, mesh)
        self.draft_model = load_model(self.draft_config, draft_state, self.device, mesh)
        self.last_stats: dict = {}

    # ------------------------------------------------------------ forwards

    def _ingest(self, model, cache: KVCache, ids: list[int],
                max_length: int) -> torch.Tensor:
        """``ids`` as one padded chunk at the cache offset; the cache's
        length ends after ``ids``.  Returns the logits of the last id [V].

        The pad stops at the cache's end: the JAX engine pads to the full
        bucket, whose write start then clamps onto cached rows."""
        offset = cache.length
        size = min(_bucket(len(ids), max_length), max_length - offset)
        tokens = torch.tensor([ids + [0] * (size - len(ids))], device=self.device)
        positions = torch.arange(offset, offset + size, device=self.device)
        logits, _ = model(tokens, positions=positions, cache=cache)
        cache.length = offset + len(ids)
        return logits[0, len(ids) - 1].float()

    def _choose(self, logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]):
        """(token [] int64, proposal probabilities [V] or None) on device."""
        if temperature <= 0.0:
            return torch.argmax(logits), None
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[0], probs

    def _verify(self, cache: KVCache, last_token: int, draft: torch.Tensor,
                draft_probs: Optional[torch.Tensor], temperature: float,
                generator: Optional[torch.Generator]) -> tuple[int, list[int]]:
        """Target chunk forward over ``[last_token] + draft`` and the accept
        rule.  Returns (accepted count, the round's new tokens); the cache
        leaves rolled back to the committed prefix."""
        gamma = self.gamma
        offset = cache.length
        chunk = torch.cat([torch.tensor([last_token], device=self.device),
                           draft.to(self.device).long()])[None]
        positions = torch.arange(offset, offset + gamma + 1, device=self.device)
        logits, _ = self.target_model(chunk, positions=positions, cache=cache)
        logits = logits[0].float()                          # [g+1, V]
        if temperature <= 0.0:
            t_choice = torch.argmax(logits, dim=-1)
            matches = (draft == t_choice[:gamma]).long()
            n_accept = torch.cumprod(matches, 0).sum()
            closer = t_choice[n_accept]
        else:
            p = torch.softmax(logits / temperature, dim=-1)
            idx = torch.arange(gamma, device=self.device)
            p_tok = p[idx, draft]
            q_tok = draft_probs[idx, draft]
            u = torch.rand(gamma, generator=generator, device=self.device)
            accept = (u * q_tok < p_tok).long()             # u < p / q
            n_accept = torch.cumprod(accept, 0).sum()
            residual = torch.clamp(p[:gamma] - draft_probs, min=0.0)
            residual = residual / torch.clamp(residual.sum(-1, keepdim=True),
                                              min=1e-30)
            fallback = torch.multinomial(residual + 1e-30, 1, generator=generator)[:, 0]
            bonus = torch.multinomial(p[gamma], 1, generator=generator)[0]
            closer = torch.where(n_accept == gamma, bonus,
                                 fallback[torch.clamp(n_accept, max=gamma - 1)])
        sel = torch.arange(gamma + 1, device=self.device)
        padded = torch.cat([draft.long(), draft.new_zeros(1).long()])
        out = torch.where(sel < n_accept, padded, closer)
        # one read back per round
        n_accept, *out = torch.cat([n_accept.reshape(1), out]).tolist()
        # of the g+1 rows written, the old last token and the accepted
        # drafts belong to the committed prefix
        cache.length = offset + 1 + n_accept
        return n_accept, out[:n_accept + 1]

    # -------------------------------------------------------- draft hooks
    # A subclass may replace the proposal (prompt lookup needs no model);
    # the verify pass is shared.

    def _draft_reset(self) -> None:
        """Called once per stream: the draft's own cache."""
        self._draft_cache = KVCache.zeros(self.draft_config, 1, dtype=self.dtype,
                                          device=self.device, mesh=self.mesh)
        self._draft_len = 0    # committed tokens the draft has processed

    def _draft_propose(self, committed: list[int], temperature: float,
                       generator: Optional[torch.Generator]):
        """(draft tokens [g] on device, their proposal probabilities [g, V]
        or None): catch-up ingest, then gamma proposals without reading
        anything back."""
        cache = self._draft_cache
        logits = self._ingest(self.draft_model, cache, committed[self._draft_len:],
                              self.draft_config.max_cache_length)
        self._draft_len = len(committed)
        token, probs = self._choose(logits, temperature, generator)
        tokens, all_probs = [token], [probs]
        for _ in range(self.gamma - 1):
            length = cache.length
            logits, _ = self.draft_model(
                token.reshape(1, 1),
                positions=torch.arange(length, length + 1, device=self.device),
                cache=cache)
            token, probs = self._choose(logits[0, 0].float(), temperature,
                                        generator)
            tokens.append(token)
            all_probs.append(probs)
        draft_probs = None if temperature <= 0.0 else torch.stack(all_probs)
        return torch.stack(tokens), draft_probs

    def _draft_commit(self, n_accept: int) -> None:
        """After each verify round: of the drafted rows, only the accepted
        ones that were fed as step inputs (d_1 .. d_{g-1}) keep valid K/V
        in the draft cache."""
        keep = min(n_accept, self.gamma - 1)
        self._draft_cache.length -= (self.gamma - 1) - keep
        self._draft_len += keep

    # ----------------------------------------------------------- generate

    def generate(self, prompt_ids: list[int], max_new_tokens: int = 128,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> list[int]:
        """Decode ``max_new_tokens`` (or until EOS); returns new tokens only.
        At temperature 0 the output is the target's greedy decode (equal
        tokens when the chunk and single-token forwards give equal logits,
        as in f32; bf16 may flip near-tied argmaxes)."""
        return list(self.stream(prompt_ids, max_new_tokens, temperature,
                                generator))

    @torch.inference_mode()
    def stream(
        self,
        prompt_ids: list[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        top_p: Optional[float] = None,     # accepted for the engine API;
        top_k: Optional[int] = None,       # not applied (as in JAX)
        inputs_embeds_prefix=None,
    ) -> Iterator[int]:
        """Yield new tokens (in bursts of up to gamma + 1 per round;
        without ``generator``, sampled from a new one seeded 0)."""
        generator = call_generator(generator, self.device)
        if inputs_embeds_prefix is not None:
            raise ValueError(
                "speculative decoding does not support embedding-prefix "
                "injection; use the plain engine for that path")
        gamma = self.gamma
        tcfg, dcfg = self.target_config, self.draft_config
        prompt_ids = [int(t) for t in prompt_ids]
        if len(prompt_ids) + max_new_tokens + gamma + 1 > min(
                tcfg.max_cache_length, dcfg.max_cache_length):
            raise ValueError("prompt + max_new_tokens exceeds cache")

        target_cache = KVCache.zeros(tcfg, 1, dtype=self.dtype, device=self.device,
                                     mesh=self.mesh)
        self._draft_reset()
        # target prefill: the cache then holds K/V for committed[:-1]
        logits = self._ingest(self.target_model, target_cache, prompt_ids,
                              tcfg.max_cache_length)
        first, _ = self._choose(logits, temperature, generator)
        committed = prompt_ids + [int(first)]
        generated = [committed[-1]]
        rounds = drafted = accepted = 0
        yield committed[-1]

        while (len(generated) < max_new_tokens
               and generated[-1] != self.eos_token_id):
            draft, draft_probs = self._draft_propose(committed, temperature,
                                                     generator)
            drafted += gamma
            n_accept, new_tokens = self._verify(
                target_cache, committed[-1], draft, draft_probs, temperature,
                generator)
            accepted += n_accept
            rounds += 1
            self._draft_commit(n_accept)
            for tok in new_tokens:
                committed.append(tok)
                generated.append(tok)
                yield tok
                if tok == self.eos_token_id or len(generated) >= max_new_tokens:
                    break

        self.last_stats = {
            "rounds": rounds,
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": accepted / drafted if drafted else 0.0,
            "tokens_per_round": (len(generated) - 1) / rounds if rounds else 0.0,
        }


class PromptLookupEngine(SpeculativeEngine):
    """Speculation without a draft model: drafts are copied from the
    transcript (the continuation of the latest earlier occurrence of the
    last ``ngram`` tokens).  The inherited verify pass keeps greedy output
    equal to the target's greedy decode, and stochastic output distributed
    as the target's samples (a point-mass proposal, ``q(d_i) = 1``).

    >>> engine = PromptLookupEngine(cfg, state_dict, gamma=8, ngram=3)
    >>> tokens = engine.generate(prompt_ids, temperature=0.0)
    """

    def __init__(
        self,
        target_config: Qwen3Config,
        target_state: dict[str, torch.Tensor],
        gamma: int = 8,
        ngram: int = 3,
        eos_token_id: int = 151645,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        super().__init__(target_config, target_state, target_config,
                         target_state, gamma=gamma, eos_token_id=eos_token_id,
                         dtype=dtype, device=device, mesh=mesh)
        self.ngram = int(ngram)

    def _draft_reset(self) -> None:  # no draft model, no draft cache
        pass

    def _draft_commit(self, n_accept: int) -> None:
        pass

    def _ngram_draft(self, committed: list[int]) -> list[int]:
        """gamma guesses: the continuation of the latest earlier match of the
        final ngram (falling back to shorter ngrams, then repetition)."""
        gamma = self.gamma
        for n in range(min(self.ngram, len(committed) - 1), 0, -1):
            tail = committed[-n:]
            # right to left: the most recent earlier occurrence
            for i in range(len(committed) - n - 1, -1, -1):
                if committed[i:i + n] == tail:
                    continuation = committed[i + n:i + n + gamma]
                    if continuation:
                        return (continuation
                                + continuation[-1:] * (gamma - len(continuation)))
        # no match anywhere: repeat the last token (the verify corrects it)
        return committed[-1:] * gamma

    def _draft_propose(self, committed: list[int], temperature: float,
                       generator: Optional[torch.Generator]):
        draft = torch.tensor(self._ngram_draft(committed), device=self.device)
        if temperature <= 0.0:
            return draft, None
        probs = torch.nn.functional.one_hot(
            draft, self.target_config.vocab_size).float()
        return draft, probs
