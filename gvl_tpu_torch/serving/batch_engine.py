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

Chat turns (``POST /chat`` under a mesh, :meth:`submit_turn`) ride the same
broadcast: every rank runs the step's turns at its start, each through its
own :class:`~gvl_tpu_torch.models.session.Qwen3ChatSession` on its shard of
the weights, from a table of sessions that rank 0 alone keys and evicts at
``max_sessions`` (the eviction travels with the turn).  A new session's
cache is allocated before its turn runs, and the ranks agree that every
one of them could, so a rank short of memory fails the turn on all.  Under
DP every replica computes a session's batch of one, as JAX's session cache
is replicated over ``data``.

The ranks agree on a failure before they act on it.  A failed prefill
fails its request alone on every rank: the slot's replica sends
:data:`FAILED` in its token's place in the gather that follows each
admission.  A failed step (:meth:`fail_live`) fails every live request and
rebuilds the cache, on rank 0 (the engine server's stepping thread) and in
:meth:`follow` alike; it keeps the ranks in step when every rank fails at
the same point.  A fault on one rank of a ``model`` group only, after the
forward's first collective, leaves the others inside that collective: it
cannot be agreed on without timeouts.
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
from gvl_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
    broadcast_objects,
)
from gvl_tpu_torch.parallel.mesh import as_mesh

logger = logging.getLogger(__name__)

FAILED = -2   # a replica's token in the admission gather when its prefill failed


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


@dataclass
class ChatTurn:
    """One ``POST /chat`` turn, run at the start of a step (on every rank
    under a mesh).  ``evict`` is rank 0's decision: the idle sessions
    dropped before a new one opens (least recently used, at the engine's
    ``max_sessions``)."""

    turn_id: int
    session_id: str
    prompt_ids: list[int]
    max_new_tokens: int
    temperature: float
    evict: list[str] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)
    prefilled: int = 0
    error: Optional[str] = None
    done: bool = False


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
        self._turns: list[ChatTurn] = []      # chat turns queued since the last step
        self._turn_ids = itertools.count()
        # chat sessions by id, least recently used first (the same on every
        # rank), and their bound, which rank 0 plans by (the HTTP service sets it)
        self.sessions: dict[str, object] = {}
        self.max_sessions = 64

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

    def submit_turn(self, session_id: str, prompt_ids: list[int],
                    max_new_tokens: int = 128, temperature: float = 0.0) -> ChatTurn:
        """Queue a chat turn of session ``session_id`` for the next step
        (rank 0 under a mesh); the returned turn holds ``tokens``,
        ``prefilled`` and ``error`` once ``done``.  Raises ValueError when
        prompt + decode budget cannot fit a session's cache, as the session
        does."""
        ids = [int(t) for t in prompt_ids]
        if len(ids) + max_new_tokens > self.config.max_cache_length:
            raise ValueError("prompt + max_new_tokens exceeds cache")
        turn = ChatTurn(next(self._turn_ids), str(session_id), ids, max_new_tokens,
                        float(temperature))
        self._turns.append(turn)
        return turn

    # ------------------------------------------------------------ lockstep

    def _sync(self, stop: bool = False) -> Optional[list[ChatTurn]]:
        """Rank 0's submissions and chat turns since the last step on every
        rank (a rank's own submissions, when every rank submitted alike, are
        the same requests under the same ids).  Returns the turns to run in
        this step, or None once rank 0 has released the followers."""
        turns, self._turns = self._turns, []
        if not self._lockstep:
            self._plan(turns)
            return turns
        import torch.distributed as dist

        leader = dist.get_rank() == 0
        if leader:
            self._plan(turns)
        sent = [dataclasses.replace(r, tokens=[]) for r in self._submitted]
        stop, sent, shared = broadcast_objects((stop, sent, turns))
        self._submitted = []
        if not leader:
            turns = shared
            for request in sent:
                if request.request_id not in self._requests:
                    self._requests[request.request_id] = request
                    self._queue.append(request)
            ids = [r.request_id for r in self._requests.values()]
            self._ids = itertools.count(max(ids, default=-1) + 1)
        return None if stop else turns

    def follow(self) -> None:
        """A rank other than 0: run every step rank 0 runs, until it calls
        :meth:`release_followers`.  A step that fails here fails the live
        requests and rebuilds the cache, as rank 0's engine server does."""
        while True:
            turns = self._sync()
            if turns is None:
                return
            try:
                self._advance(turns)
            except Exception as exc:  # noqa: BLE001 — the follower must live
                logger.exception("engine step failed; failing the live requests")
                self.fail_live(f"engine step failed: {exc!r}")

    def release_followers(self) -> None:
        """Rank 0: end the followers' :meth:`follow` (call once no step
        can run any more)."""
        if self._lockstep:
            self._sync(stop=True)

    def fail_live(self, reason: str) -> None:
        """The recovery after a failed step, on every rank alike: every
        request not yet done fails with ``reason``, and the KV cache and slot
        state are rebuilt (the slots' sessions lose their prefixes and
        re-prefill; chat sessions keep their own caches)."""
        for request in self._requests.values():
            if not request.done:
                request.error, request.done, request.slot = reason, True, None
        self._queue.clear()
        self.reset_cache()

    # ---------------------------------------------------------- chat turns

    def _plan(self, turns: list[ChatTurn]) -> None:
        """Rank 0: each turn's ``evict``, in the order the turns run, from
        the table as it stands (least recently used first)."""
        order = list(self.sessions)
        for turn in turns:
            if turn.session_id in order:
                order.remove(turn.session_id)
            else:
                while len(order) >= self.max_sessions:
                    turn.evict.append(order.pop(0))
            order.append(turn.session_id)

    def _new_session(self):
        """A chat session on this rank's shard of the engine's weights
        (shared, not copied), its cache allocated."""
        from gvl_tpu_torch.models.session import Qwen3ChatSession

        session = Qwen3ChatSession(self.config, self.model.state_dict(),
                                   eos_token_id=self.eos_token_id, dtype=self.dtype,
                                   device=self.device, mesh=self.mesh)
        session.allocate()
        return session

    def _agree(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (one all-reduce over the world
        in lockstep)."""
        if not self._lockstep:
            return ok
        import torch.distributed as dist

        failed = torch.tensor([0 if ok else 1], device=self.device)
        return int(all_reduce_sum(failed, dist.group.WORLD)[0]) == 0

    def _open(self, turn: ChatTurn):
        """The turn's session, after rank 0's evictions, as the table's most
        recently used.  A new one (the table is the same on every rank)
        opens on every rank or on none."""
        for session_id in turn.evict:
            self.sessions.pop(session_id).release()
            logger.info("evicted chat session %r", session_id)
        session = self.sessions.pop(turn.session_id, None)
        if session is None:
            error = None
            try:
                session = self._new_session()
            except Exception as exc:  # noqa: BLE001 — agreed on below
                error = exc
            if not self._agree(error is None):
                raise error or RuntimeError("another rank could not open the session")
        self.sessions[turn.session_id] = session
        return session

    def _run_turns(self, turns: list[ChatTurn]) -> None:
        """Each turn through its session, as rank 0 decided.  A turn that
        fails fails alone, on every rank alike: its session leaves the table
        (it starts over at its next turn)."""
        for turn in turns:
            try:
                session = self._open(turn)
                turn.tokens = session.generate(turn.prompt_ids,
                                               max_new_tokens=turn.max_new_tokens,
                                               temperature=turn.temperature)
                turn.prefilled = session.last_ingested
            except Exception as exc:  # noqa: BLE001 — attribute to the turn
                logger.exception("chat turn %d failed", turn.turn_id)
                turn.error = f"chat turn failed: {exc!r}"
                self.sessions.pop(turn.session_id, None)
            turn.done = True

    # --------------------------------------------------------------- slots

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
        mesh only the slot's replica runs the chunk (the others return -1)."""
        if not self._owns(slot):
            return -1
        offset = self._lengths[slot]
        cache = self.cache.slot(slot - self._lo)   # views: writes land in self.cache
        cache.lengths = [offset]
        size = self._bucket(len(delta))
        tokens = torch.tensor([delta + [0] * (size - len(delta))],
                              device=self.device)
        positions = torch.arange(offset, offset + size, device=self.device)
        logits, _ = self._chunk_model(tokens, positions=positions, cache=cache)
        token = sample_logits(logits[:, len(delta) - 1], self._generator,
                              *self._sampling)
        return int(token[0])

    def _stand_in_sample(self) -> None:
        """The random numbers of the owner's sample after an admission, on a
        stand-in row (a replica that does not own the slot)."""
        sample_logits(torch.zeros(1, self.config.vocab_size, device=self.device),
                      self._generator, *self._sampling)

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
            error = None
            try:
                token = self._prefill(slot, delta)
            except Exception as exc:  # noqa: BLE001 — attribute to request
                logger.exception("prefill failed for request %d",
                                 request.request_id)
                error, token = f"prefill failed: {exc!r}", FAILED
            if self._lockstep:
                # the owner's outcome, from its replica's entry: every rank
                # fails the request, or every rank keeps the owner's token
                local = self.num_slots // self.mesh.shape["data"]
                token = self._gather_tokens([token])[slot // local]
                if token == FAILED:
                    error = error or f"prefill failed on data replica {slot // local}"
                else:
                    error = None    # a non-owner's own fault touches no state
                    if not self._owns(slot):
                        self._stand_in_sample()
            if error is not None:
                # the failure belongs to this request; the other slots'
                # prefixes are untouched (the chunk writes only rows past
                # this slot's offset), so only this slot's reservation goes
                request.error = error
                request.done = True
                self._lengths[slot] = 0
                self._slot_session[slot] = None
                self._slot_cached[slot] = []
                continue
            self._lengths[slot] += len(delta)
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

    def _tick(self, produced: Optional[dict] = None) -> bool:
        """One step; False when rank 0 has released the followers."""
        turns = self._sync()
        if turns is None:
            return False
        self._advance(turns, produced)
        return True

    @torch.inference_mode()
    def _advance(self, turns: list[ChatTurn], produced: Optional[dict] = None) -> None:
        """A step past its synchronisation: the chat turns, the admissions,
        one batched decode step."""
        self._run_turns(turns)
        produced = {} if produced is None else produced
        self._admit()
        active = [r is not None for r in self._slot_req]
        if not any(active):
            return
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

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._turns)
                or any(r is not None for r in self._slot_req))

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
