"""Thread-safe streaming front-end over the continuous-batching engine.

Counterpart of :mod:`gvl_tpu.serving.engine_server`.  Concurrent callers
(HTTP handlers, agent sessions) submit prompts and consume per-request
token streams while one driver thread steps the shared
:class:`~gvl_tpu_torch.serving.batch_engine.ContinuousBatchingEngine`:
every decode step advances all live requests at once.  A prefill failure
fails only its own request; a failed decode step fails the live streams,
rebuilds the engine's cache (``engine.fail_live``) and keeps stepping.
:meth:`EngineServer.chat` runs a chat turn in the engine's next
step, the path of ``POST /chat`` under a mesh, where every rank runs the
turn in lockstep (without a mesh the HTTP service runs its sessions on its
own thread).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Iterator, Optional

logger = logging.getLogger(__name__)

_DONE = object()


class EngineError(RuntimeError):
    """A request failed inside the driver thread."""


class _Failure:
    """Error sentinel pushed to a stream when its request dies."""

    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


class EngineServer:
    """Owns the batching engine + driver thread; hands out token streams.

    >>> server = EngineServer(engine)
    >>> stream = server.submit_stream([1, 2, 3], max_new_tokens=32)
    >>> tokens = list(stream)          # safe from any thread
    >>> server.shutdown()
    """

    def __init__(self, engine, poll_interval: float = 0.002):
        self.engine = engine
        self._lock = threading.Lock()
        self._streams: dict[int, queue.Queue] = {}
        self._turns: dict[int, tuple] = {}     # turn id -> (turn, its event)
        self._poll_interval = poll_interval
        self._wake = threading.Event()
        self._stop = threading.Event()
        # observability (read via stats(); written under _lock or by the
        # single driver thread)
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._tokens_out = 0
        self._steps = 0
        self._submit_time: dict[int, float] = {}
        self._ttft_ms: deque[float] = deque(maxlen=256)
        self._started = time.time()
        self._driver = threading.Thread(
            target=self._drive, daemon=True, name="engine-driver")
        self._driver.start()

    def stats(self) -> dict:
        """Serving counters + TTFT percentiles (for ``GET /metrics``)."""
        with self._lock:
            ttft = sorted(self._ttft_ms)
            pct = (lambda p: round(ttft[int(p * (len(ttft) - 1))], 1)
                   if ttft else None)
            return {
                "requests_submitted": self._submitted,
                "requests_completed": self._completed,
                "requests_failed": self._failed,
                "requests_in_flight": len(self._streams),
                "tokens_generated": self._tokens_out,
                "decode_steps": self._steps,
                "slots_total": getattr(self.engine, "num_slots", None),
                "slots_busy": sum(
                    r is not None
                    for r in getattr(self.engine, "_slot_req", [])),
                "ttft_ms_p50": pct(0.50),
                "ttft_ms_p90": pct(0.90),
                "ttft_ms_p99": pct(0.99),
                "uptime_s": round(time.time() - self._started, 1),
            }

    # -------------------------------------------------------------- public

    def submit_stream(
        self, prompt_ids: list[int], max_new_tokens: int = 128,
        session_key: Optional[str] = None,
    ) -> Iterator[int]:
        """Submit a prompt; returns an iterator of generated token ids.

        ``session_key`` opts into the engine's per-slot prefix caching —
        a returning session whose prompt extends its previous transcript
        prefills only the delta."""
        stream: queue.Queue = queue.Queue()
        with self._lock:
            request_id = self.engine.submit(prompt_ids, max_new_tokens,
                                            session_key=session_key)
            self._streams[request_id] = stream
            self._submitted += 1
            self._submit_time[request_id] = time.time()
        self._wake.set()

        def tokens():
            while True:
                item = stream.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise EngineError(item.message)
                yield item

        return tokens()

    def generate(self, prompt_ids: list[int],
                 max_new_tokens: int = 128,
                 session_key: Optional[str] = None) -> list[int]:
        return self.generate_with_info(prompt_ids, max_new_tokens,
                                       session_key=session_key)[0]

    def generate_with_info(
        self, prompt_ids: list[int], max_new_tokens: int = 128,
        session_key: Optional[str] = None,
    ) -> tuple[list[int], int]:
        """Like :meth:`generate`, also returning how many prompt tokens
        were actually prefilled (the delta, for returning sessions)."""
        stream: queue.Queue = queue.Queue()
        with self._lock:
            request_id = self.engine.submit(prompt_ids, max_new_tokens,
                                            session_key=session_key)
            self._streams[request_id] = stream
            self._submitted += 1
            self._submit_time[request_id] = time.time()
        self._wake.set()
        tokens: list[int] = []
        while True:
            item = stream.get()
            if item is _DONE:
                break
            if isinstance(item, _Failure):
                raise EngineError(item.message)
            tokens.append(item)
        return tokens, self.engine._requests[request_id].prefilled

    def chat(self, session_id: str, prompt_ids: list[int], max_new_tokens: int = 128,
             temperature: float = 0.0) -> tuple[list[int], int]:
        """One turn of chat session ``session_id``, run by the stepping thread
        at the start of its next step (``engine.submit_turn``); returns the
        tokens and how many prompt tokens were prefilled.  A failed turn
        raises :class:`EngineError` for this turn alone."""
        done = threading.Event()
        with self._lock:
            turn = self.engine.submit_turn(session_id, prompt_ids, max_new_tokens,
                                           temperature=temperature)
            self._turns[turn.turn_id] = (turn, done)
        self._wake.set()
        done.wait()
        if turn.error is not None:
            raise EngineError(turn.error)
        return turn.tokens, turn.prefilled

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._driver.join(timeout=5)
        with self._lock:     # turns no step will run
            for turn, done in self._turns.values():
                turn.error = turn.error or "engine server shut down"
                done.set()
            self._turns.clear()

    def _finish_turns(self, failure: Optional[str] = None) -> None:
        """Wake the callers whose turns have run (under ``_lock``); after a
        failed step (``failure``) also those whose turns it did not reach
        (every queued turn belonged to that step)."""
        for turn_id, (turn, done) in list(self._turns.items()):
            if failure is not None and not turn.done:
                turn.error, turn.done = failure, True
            if turn.done:
                del self._turns[turn_id]
                done.set()

    # -------------------------------------------------------------- driver

    def _drive(self) -> None:
        sent: dict[int, int] = {}
        while not self._stop.is_set():
            with self._lock:
                has_work = self.engine.has_work
            if not has_work:
                self._wake.wait(timeout=0.25)
                self._wake.clear()
                continue
            with self._lock:
                try:
                    self.engine.step()
                except Exception as exc:  # noqa: BLE001 — driver must live
                    # Prefill failures are attributed to the offending
                    # request inside engine._admit (request.error set,
                    # other streams untouched) — reaching here means the
                    # shared DECODE step failed, which cannot be pinned on
                    # one request.  Fail all live streams and keep
                    # driving; consumers must not block forever on
                    # stream.get().
                    logger.exception("engine.step() failed; "
                                     "failing %d live stream(s)",
                                     len(self._streams))
                    failure = _Failure(f"engine step failed: {exc!r}")
                    for request_id in list(self._streams):
                        self._streams.pop(request_id).put(failure)
                        sent.pop(request_id, None)
                        self._failed += 1
                        self._submit_time.pop(request_id, None)
                    # a step that failed part way may have left the cache
                    # half written: the engine fails its live requests and
                    # rebuilds it, as every follower does (sessions of the
                    # slots lose their prefixes and re-prefill)
                    try:
                        self.engine.fail_live(failure.message)
                    except Exception:
                        logger.exception("engine cache rebuild failed")
                    self._finish_turns(failure.message)
                    continue
                self._finish_turns()
                self._steps += 1
                # flush newly-recorded tokens to each request's stream
                for request_id in list(self._streams):
                    request = self.engine._requests[request_id]
                    stream = self._streams[request_id]
                    already = sent.get(request_id, 0)
                    fresh = request.tokens[already:]
                    if fresh and already == 0:
                        t0 = self._submit_time.pop(request_id, None)
                        if t0 is not None:
                            self._ttft_ms.append((time.time() - t0) * 1e3)
                    for token in fresh:
                        stream.put(token)
                    self._tokens_out += len(fresh)
                    sent[request_id] = len(request.tokens)
                    if request.done:
                        if request.error is not None:
                            stream.put(_Failure(request.error))
                            self._failed += 1
                        else:
                            stream.put(_DONE)
                            self._completed += 1
                        self._streams.pop(request_id)
                        sent.pop(request_id, None)
                        self._submit_time.pop(request_id, None)
