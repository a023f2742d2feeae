"""Continuous batching for the reasoning core.

Counterpart of :mod:`gvl_tpu.serving.batch_engine`.  Fixed decode slots
share one KV cache with per-slot lengths: every step decodes all slots in
one forward, a finished slot frees at once, and queued requests are
admitted into free slots between steps.  An admission ingests the prompt
(or, for a returning session whose slot still holds its transcript, only
the delta) as one chunk at the slot's offset through the ``chunk_verify``
model, whose attention is ``chunk_attention``.

Inactive slots run in the step as in the JAX engine: each writes one row
at its length, and its length is then set back, so what they hold is
unchanged and the active slots' numbers do not depend on them.  Lengths
live on the host; each step reads its tokens back from the device once.

``mesh=`` serves DP x TP in lockstep (the JAX engine's one sharded program,
written out on ``torch.distributed``): every rank runs the same steps.  The
slots shard over ``data`` (replica ``d`` holds slots ``d * S/D`` to
``(d+1) * S/D - 1`` in its cache and advances them), the weights over
``model`` (:mod:`gvl_tpu_torch.models.qwen3`).  Rank 0 holds the queue:
each step starts with rank 0 broadcasting the requests submitted since the
last one (:func:`~gvl_tpu_torch.parallel.collectives.broadcast_objects`),
so every rank admits alike and keeps every slot's host state; after each
admission and each decode step the tokens are gathered over ``data``.
Every rank draws every slot's random numbers from its own copy of the
engine's generator and keeps its own slots' samples, so sampled streams
are the unsharded engine's.  Ranks other than 0 run :meth:`follow` until
rank 0 calls :meth:`release_followers`.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from dataclasses import dataclass, field
from typing import Optional

import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import (
    KVCache,
    Qwen3Config,
    call_generator,
    load_model,
    sample_logits,
)
from gvl_tpu_torch.parallel.collectives import all_gather_cat, broadcast_objects
from gvl_tpu_torch.parallel.mesh import as_mesh

logger = logging.getLogger(__name__)


@dataclass
class Request:
    request_id: int
    prompt_ids: list[int]
    max_new_tokens: int = 128
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    session_key: Optional[str] = None
    prefilled: int = 0           # tokens actually prefilled at admission
    error: Optional[str] = None  # set when this request's prefill failed


class ContinuousBatchingEngine:
    """Multi-slot decode over one shared KV cache.

    >>> engine = ContinuousBatchingEngine(cfg, state_dict, eos_token_id=2)
    >>> ids = [engine.submit(p) for p in prompts]
    >>> results = engine.run()           # {request_id: [token, ...]}
    """

    PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    DELTA_BUCKETS = (8, 16, 32, 64) + PROMPT_BUCKETS

    def __init__(
        self,
        config: Qwen3Config,
        state_dict: dict[str, torch.Tensor],
        eos_token_id: int = 151645,
        num_slots: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        temperature: float = 0.0,
        top_p: float = 0.8,
        top_k: int = 20,
        generator: Optional[torch.Generator] = None,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self.mesh = mesh = as_mesh(mesh)
        data_size = 1 if mesh is None else mesh.shape["data"]
        if num_slots % data_size:
            raise ValueError(
                f"num_slots={num_slots} must divide over the data "
                f"axis ({data_size})")
        # this replica's slots: [lo, hi)
        local = num_slots // data_size
        self._lo = 0 if mesh is None else mesh.data_index * local
        self._hi = self._lo + local
        self._lockstep = mesh is not None and mesh.data_group is not None
        self.config = config
        self.eos_token_id = eos_token_id
        self.num_slots = num_slots
        self.dtype = dtype
        self.device = resolve_device(device)
        self._sampling = (float(temperature), float(top_p), int(top_k))
        # one generator for the engine, seeded 0 unless given (JAX: one key)
        self._generator = call_generator(generator, self.device)
        self.model = load_model(config, state_dict, self.device, mesh)
        # the same weights, with multi-token chunks attending at the offset
        self._chunk_model = load_model(
            dataclasses.replace(config, chunk_verify=True),
            self.model.state_dict(), self.device, mesh)
        self._submitted: list[Request] = []   # since the last step (lockstep)

        self.reset_cache()   # the cache and the per-slot state
        self._queue: list[Request] = []
        self._requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self._slot_last_used: list[int] = [0] * num_slots
        self._ticks = 0

    # -------------------------------------------------------------- public

    def submit(self, prompt_ids: list[int], max_new_tokens: int = 128,
               session_key: Optional[str] = None) -> int:
        """Queue a prompt.  ``session_key`` enables per-slot prefix caching:
        when the same key returns with a prompt that extends its previous
        transcript, only the delta is prefilled.

        Raises ValueError when prompt + decode budget cannot fit the KV
        cache, so the HTTP layer can answer 400.
        """
        need = len(prompt_ids) + max_new_tokens + 1
        if need > self.config.max_cache_length:
            raise ValueError(
                f"prompt ({len(prompt_ids)} tokens) + max_new_tokens "
                f"({max_new_tokens}) + 1 = {need} exceeds max_cache_length="
                f"{self.config.max_cache_length}")
        request = Request(request_id=next(self._ids),
                          prompt_ids=[int(t) for t in prompt_ids],
                          max_new_tokens=max_new_tokens,
                          session_key=session_key)
        self._requests[request.request_id] = request
        self._queue.append(request)
        self._submitted.append(request)
        return request.request_id

    # ------------------------------------------------------------ lockstep

    def _sync(self, stop: bool = False) -> bool:
        """Rank 0's submissions since the last step on every rank (a
        rank's own submissions, when every rank submitted alike, are the
        same requests under the same ids).  Returns False once rank 0 has
        released the followers."""
        if not self._lockstep:
            return True
        import torch.distributed as dist

        sent = [dataclasses.replace(r, tokens=[]) for r in self._submitted]
        stop, sent = broadcast_objects((stop, sent))
        self._submitted = []
        if dist.get_rank() != 0:
            for request in sent:
                if request.request_id not in self._requests:
                    self._requests[request.request_id] = request
                    self._queue.append(request)
            ids = [r.request_id for r in self._requests.values()]
            self._ids = itertools.count(max(ids, default=-1) + 1)
        return not stop

    def follow(self) -> None:
        """A rank other than 0: run every step rank 0 runs, until it calls
        :meth:`release_followers`."""
        while self._tick():
            pass

    def release_followers(self) -> None:
        """Rank 0: end the followers' :meth:`follow` (call once no step
        can run any more)."""
        if self._lockstep:
            self._sync(stop=True)

    def _gather_tokens(self, local: list[int]) -> list[int]:
        """Every replica's tokens, in slot order, on every rank."""
        if not self._lockstep:
            return local
        t = torch.tensor(local, dtype=torch.int64, device=self.device)
        return all_gather_cat(t, 0, self.mesh.data_group).tolist()

    def _owns(self, slot: int) -> bool:
        return self._lo <= slot < self._hi

    def _bucket(self, n: int) -> int:
        for b in self.DELTA_BUCKETS:
            if n <= b:
                return min(b, self.config.max_cache_length)
        return self.config.max_cache_length

    def _pick_slot(self, request: Request) -> Optional[int]:
        """Session-affine slot choice; LRU eviction of idle reservations."""
        idle = [s for s in range(self.num_slots) if self._slot_req[s] is None]
        if not idle:
            return None
        if request.session_key is not None:
            for slot in idle:
                if self._slot_session[slot] == request.session_key:
                    return slot
        unreserved = [s for s in idle if self._slot_session[s] is None]
        if unreserved:
            return unreserved[0]
        return min(idle, key=lambda s: self._slot_last_used[s])

    @torch.inference_mode()
    def _prefill(self, slot: int, delta: list[int]) -> int:
        """The delta as one padded chunk at the slot's offset; returns the
        first sampled token (the one read back of an admission).  Under a
        mesh only the slot's replica runs the chunk; every rank draws the
        sample's random numbers."""
        offset = self._lengths[slot]
        temperature, top_p, top_k = self._sampling
        if not self._owns(slot):
            # the same draws as the owner's, on a stand-in row
            sample_logits(torch.zeros(1, self.config.vocab_size, device=self.device),
                          self._generator, temperature, top_p, top_k)
            self._lengths[slot] = offset + len(delta)
            return -1
        cache = self.cache.slot(slot - self._lo)   # views: writes land in self.cache
        cache.lengths = [offset]
        size = self._bucket(len(delta))
        tokens = torch.tensor([delta + [0] * (size - len(delta))],
                              device=self.device)
        positions = torch.arange(offset, offset + size, device=self.device)
        logits, _ = self._chunk_model(tokens, positions=positions, cache=cache)
        token = sample_logits(logits[:, len(delta) - 1], self._generator,
                              temperature, top_p, top_k)
        self._lengths[slot] = offset + len(delta)
        return int(token[0])

    def _admit(self) -> None:
        """Prefill queued requests into free slots (the delta when the slot
        already caches a prefix of the prompt)."""
        while self._queue:
            request = self._queue[0]
            if request.done:    # failed or cancelled while queued
                self._queue.pop(0)
                continue
            slot = self._pick_slot(request)
            if slot is None:
                return
            self._queue.pop(0)
            prompt = request.prompt_ids
            cached = self._slot_cached[slot]
            reuse = (request.session_key is not None
                     and self._slot_session[slot] == request.session_key
                     and len(cached) <= len(prompt)
                     and prompt[:len(cached)] == cached
                     and len(prompt) + request.max_new_tokens + 1
                     <= self.config.max_cache_length)
            if reuse:
                # the padded delta must fit behind the cached prefix; if not,
                # fall back to a full prefill from offset 0 (which fits)
                trial_cached = cached if prompt[len(cached):] else cached[:-1]
                trial_delta = len(prompt) - len(trial_cached)
                if (len(trial_cached) + self._bucket(trial_delta)
                        > self.config.max_cache_length):
                    reuse = False
            if not reuse:
                # fresh slot: offset 0 (stale rows are masked and overwritten)
                self._lengths[slot] = 0
                cached = []
            delta = prompt[len(cached):]
            if not delta:       # the prompt is the cached transcript exactly
                delta = prompt[-1:]
                cached = cached[:-1]
                self._lengths[slot] = len(cached)
            try:
                token = self._prefill(slot, delta)
            except Exception as exc:  # noqa: BLE001 — attribute to request
                if self._lockstep:
                    raise    # the other replicas cannot tell: no rank goes on alone
                # the failure belongs to this request; the other slots'
                # prefixes are untouched (the chunk writes only rows past
                # this slot's offset), so only this slot's reservation goes
                logger.exception("prefill failed for request %d",
                                 request.request_id)
                request.error = f"prefill failed: {exc!r}"
                request.done = True
                self._lengths[slot] = 0
                self._slot_session[slot] = None
                self._slot_cached[slot] = []
                continue
            if self._lockstep:
                # the owner's token, from its replica's entry
                local = self.num_slots // self.mesh.shape["data"]
                token = self._gather_tokens([token])[slot // local]
            request.prefilled = len(delta)
            request.slot = slot
            self._slot_req[slot] = request
            self._slot_cached[slot] = list(prompt)
            self._slot_session[slot] = request.session_key
            self._ticks += 1
            self._slot_last_used[slot] = self._ticks
            self._record_token(request, token)

    def reset_cache(self) -> None:
        """Rebuild the KV cache and slot state from scratch (the recovery
        path after a failed step; sessions lose their prefixes and
        re-prefill)."""
        self.cache = KVCache.zeros(self.config, self._hi - self._lo, dtype=self.dtype,
                                   device=self.device, mesh=self.mesh)
        self._lengths: list[int] = [0] * self.num_slots   # every slot's, on the host
        self._slot_req: list[Optional[Request]] = [None] * self.num_slots
        self._slot_cached: list[list[int]] = [[] for _ in range(self.num_slots)]
        self._slot_session: list[Optional[str]] = [None] * self.num_slots
        self._last_token: list[int] = [0] * self.num_slots

    def _record_token(self, request: Request, token: int) -> None:
        if token == self.eos_token_id:
            request.done = True
        else:
            request.tokens.append(token)
            if len(request.tokens) >= request.max_new_tokens:
                request.done = True
        if request.done:
            self._slot_req[request.slot] = None
            request.slot = None
        else:
            self._last_token[request.slot] = token

    def step(self) -> dict[int, int]:
        """Admit queued work, run one batched decode step.

        Returns {request_id: token} for tokens produced this step.
        """
        produced: dict[int, int] = {}
        self._tick(produced)
        return produced

    @torch.inference_mode()
    def _tick(self, produced: Optional[dict] = None) -> bool:
        """One step (a follower's too); False when rank 0 has released the
        followers."""
        if not self._sync():
            return False
        produced = {} if produced is None else produced
        self._admit()
        active = [r is not None for r in self._slot_req]
        if not any(active):
            return True
        # the token fed this step enters each active slot's cache
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._slot_cached[slot].append(self._last_token[slot])
        lo, hi = self._lo, self._hi
        self.cache.lengths = self._lengths[lo:hi]
        lengths = self.cache.lengths_tensor(self.device)
        tokens = torch.tensor(self._last_token[lo:hi], dtype=torch.int64)
        if self.device.type != "cpu":
            tokens = tokens.to(self.device, non_blocking=True)
        logits, _ = self.model(tokens[:, None], positions=lengths[:, None],
                               cache=self.cache)
        temperature, top_p, top_k = self._sampling
        if hi - lo < self.num_slots:
            # every slot's random numbers: this replica's rows in place,
            # stand-in rows elsewhere, whose samples are dropped
            rows = torch.zeros(self.num_slots, logits.shape[-1], dtype=logits.dtype,
                               device=self.device)
            rows[lo:hi] = logits[:, -1]
            local = sample_logits(rows, self._generator, temperature, top_p,
                                  top_k)[lo:hi]
            nxt = self._gather_tokens(local.tolist())
        else:
            nxt = sample_logits(logits[:, -1], self._generator, temperature, top_p,
                                top_k).tolist()
        # only active slots advance: the others' rows past their lengths
        # are masked and overwritten later
        self._lengths = [n + 1 if on else n for n, on in zip(self._lengths, active)]
        for slot, request in enumerate(list(self._slot_req)):
            if request is None:
                continue
            produced[request.request_id] = nxt[slot]
            self._record_token(request, nxt[slot])
        return True

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slot_req)

    def run(self) -> dict[int, list[int]]:
        """Drive to completion; returns generated tokens per request."""
        while self.has_work:
            self.step()
        return {rid: r.tokens for rid, r in self._requests.items()}

    def generate_many(self, prompts: list[list[int]],
                      max_new_tokens: int = 128) -> list[list[int]]:
        ids = [self.submit(p, max_new_tokens) for p in prompts]
        results = self.run()
        return [results[i] for i in ids]
