"""HTTP serving for gameplay-video QA.

Counterpart of :mod:`gvl_tpu.serving.api`, stdlib only (ThreadingHTTPServer
and JSON).

Endpoints
---------
- ``GET  /health``            liveness, loaded videos, whether an LLM is attached
- ``GET  /metrics``           engine counters, TTFT percentiles, sessions,
                              device memory
- ``GET  /status``            per-video loop status
- ``POST /process``           ``{"video": path}`` -> run (or reuse) perception
                              through :func:`gvl_tpu_torch.pipeline.process_video`
- ``POST /query``             ``{"video": path, "question": str,
                              "timestamp"?: float}`` -> answer
- ``POST /query/stream``      the same, chunked text/plain streaming
- ``GET  /timeline?video=..`` timeline statistics + transcript
- ``POST /generate``          ``{"prompt_ids": [int], "max_new_tokens"?}``
                              -> tokens through the shared continuous-batching
                              engine (see :meth:`InferenceService.attach_engine`)
- ``POST /generate/stream``   the same, chunked newline-delimited token ids
- ``POST /chat``              ``{"session_id": str, "prompt_ids": [int]}``
                              -> multi-turn generation with a per-session KV
                              cache; ``prefilled`` reports the delta ingested

The video routes process each video once with the service's preset
(``config``) on its ``device``.  Concurrent ``/generate`` callers share one
decode loop.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

logger = logging.getLogger(__name__)

# Server-side ceiling on caller-controlled decode length: an unauthenticated
# caller must not be able to pin a slot for an unbounded number of steps.
MAX_NEW_TOKENS_LIMIT = 2048


def _max_new_tokens(body: dict) -> int:
    value = int(body.get("max_new_tokens", 128))
    if value < 1:
        raise ValueError("max_new_tokens must be >= 1")
    return min(value, MAX_NEW_TOKENS_LIMIT)


class InferenceService:
    """Owns processed videos and routes questions to their loops."""

    def __init__(self, config=None, device: str | torch.device = "cuda"):
        from gvl_tpu_torch.config import load_preset

        self.config = config or load_preset("light")
        self.device = device
        self._videos: dict[str, object] = {}
        self._lock = threading.Lock()
        self._engine_server = None
        self._tokenizer = None
        self._session_factory = None
        self._sessions: dict = {}       # insertion-ordered: LRU via move
        self._session_lock = threading.Lock()
        # Count bound refined to an HBM-bytes bound on first session
        # creation (each session pins a full KV cache on device).
        self.max_sessions = 64
        self._sized_from_hbm = False

    # ------------------------------------------------ batched LLM serving

    def attach_engine(self, engine_server, tokenizer=None,
                      session_factory=None) -> None:
        """Attach an :class:`~gvl_tpu_torch.serving.EngineServer` so ``/generate``
        serves raw LLM requests through the shared continuous-batching
        engine. ``tokenizer`` (optional, HF-style ``encode``/``decode``)
        enables ``{"prompt": str}`` requests and decoded-text responses.
        ``session_factory`` (zero-arg callable returning a
        :class:`~gvl_tpu_torch.models.session.Qwen3ChatSession`) enables
        ``POST /chat`` with per-session KV prefix caching.
        """
        self._engine_server = engine_server
        self._tokenizer = tokenizer
        self._session_factory = session_factory

    def chat(self, body: dict) -> dict:
        """Multi-turn generation: each session keeps its KV cache, so a
        turn prefills only the transcript delta (sessions are device-
        stateful, hence serialized under one lock)."""
        if self._session_factory is None:
            raise ValueError(
                "no chat sessions attached (see attach_engine"
                "(session_factory=...))")
        session_id = str(body.get("session_id", "default"))
        prompt_ids = self._prompt_ids(body)
        max_new = _max_new_tokens(body)
        with self._session_lock:
            session = self._sessions.pop(session_id, None)
            if session is None:
                while len(self._sessions) >= self.max_sessions:
                    evicted_id, evicted = next(iter(self._sessions.items()))
                    del self._sessions[evicted_id]   # oldest-idle (LRU)
                    if hasattr(evicted, "release"):
                        evicted.release()  # free its HBM now, not at GC
                    logger.info("evicted chat session %r", evicted_id)
                session = self._session_factory()
                self._size_session_bound(session)
            self._sessions[session_id] = session  # re-insert = most recent
            tokens = session.generate(prompt_ids, max_new_tokens=max_new,
                                      temperature=float(
                                          body.get("temperature", 0.0)))
            prefilled = session.last_ingested
        result = {"session_id": session_id, "tokens": tokens,
                  "num_tokens": len(tokens), "prefilled": prefilled}
        if self._tokenizer is not None:
            result["text"] = self._tokenizer.decode(tokens)
        return result

    def _size_session_bound(self, session) -> None:
        """Refine ``max_sessions`` so total pinned KV fits device memory.

        64 idle 8B sessions at an 8K cache would pin ~75 GB.  Budget: half
        of the card's free memory (the other half stays for activations
        and the batching engine), floor of 1.  A session on the CPU keeps
        the count bound.
        """
        if self._sized_from_hbm or not hasattr(session, "cache_nbytes"):
            return
        self._sized_from_hbm = True
        device = getattr(session, "device", None)
        if device is None or device.type != "cuda":
            return
        try:
            free, _ = torch.cuda.mem_get_info(device)
            per_session = session.cache_nbytes()
            if free > 0 and per_session > 0:
                fit = max(1, int(free // 2 // per_session))
                if fit < self.max_sessions:
                    logger.info(
                        "max_sessions %d -> %d (%.1f MB KV/session, "
                        "%.1f GB free HBM)", self.max_sessions, fit,
                        per_session / 2**20, free / 2**30)
                    self.max_sessions = fit
        except RuntimeError:   # the card cannot be queried: keep the default
            logger.debug("could not size session bound from device memory",
                         exc_info=True)

    def metrics(self) -> dict:
        """Serving observability: engine counters + TTFT percentiles +
        session/video occupancy (``GET /metrics``)."""
        out: dict = {
            "videos_loaded": len(self._videos),
            "chat_sessions": len(self._sessions),
            "max_sessions": self.max_sessions,
        }
        if self._engine_server is not None:
            out["engine"] = self._engine_server.stats()
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            out["device_bytes_in_use"] = total - free
            out["device_bytes_limit"] = total
        return out

    def _prompt_ids(self, body: dict) -> list[int]:
        if "prompt_ids" in body:
            return [int(t) for t in body["prompt_ids"]]
        if "prompt" in body:
            if self._tokenizer is None:
                raise ValueError(
                    "string prompts need a tokenizer; attach_engine(...,"
                    " tokenizer=...) or send prompt_ids")
            return list(self._tokenizer.encode(body["prompt"]))
        raise KeyError("'prompt_ids' (or 'prompt')")

    def generate(self, body: dict) -> dict:
        if self._engine_server is None:
            raise ValueError("no LLM engine attached (see attach_engine)")
        prompt_ids = self._prompt_ids(body)
        max_new = _max_new_tokens(body)
        tokens, prefilled = self._engine_server.generate_with_info(
            prompt_ids, max_new, session_key=body.get("session_key"))
        result = {"tokens": tokens, "num_tokens": len(tokens)}
        if body.get("session_key") is not None:
            result["prefilled"] = prefilled
        if self._tokenizer is not None:
            result["text"] = self._tokenizer.decode(tokens)
        return result

    def generate_stream(self, body: dict):
        """Return an iterator of generated token ids (one per step).

        Validation happens eagerly (before the caller commits HTTP
        headers); only the token wait is lazy.
        """
        if self._engine_server is None:
            raise ValueError("no LLM engine attached (see attach_engine)")
        prompt_ids = self._prompt_ids(body)
        max_new = _max_new_tokens(body)
        return self._engine_server.submit_stream(
            prompt_ids, max_new, session_key=body.get("session_key"))

    def process(self, video: str) -> dict:
        from gvl_tpu_torch.pipeline import process_video

        with self._lock:
            if video not in self._videos:
                self._videos[video] = process_video(video, self.config,
                                                    device=self.device)
        processed = self._videos[video]
        return {
            "video": video,
            "timeline": processed.timeline.get_statistics(),
        }

    def query(self, video: str, question: str,
              timestamp: Optional[float] = None) -> dict:
        from gvl_tpu_torch.pipeline import answer_query

        if video not in self._videos:
            self.process(video)
        processed = self._videos[video]
        if timestamp is None:
            timestamp = (
                processed.loop.reasoning_core.retriever.parse_timestamp(
                    question)
            )
        answer = answer_query(processed, question, timestamp)
        summary = processed.loop.reasoning_core.get_conversation_summary()
        return {
            "video": video,
            "question": question,
            "answer": answer,
            "turn_count": summary["turn_count"],
        }

    def query_stream(self, video: str, question: str,
                     timestamp: Optional[float] = None):
        from gvl_tpu_torch.pipeline import answer_query_streaming

        if video not in self._videos:
            self.process(video)
        processed = self._videos[video]
        if timestamp is None:
            timestamp = (
                processed.loop.reasoning_core.retriever.parse_timestamp(
                    question)
            )
        yield from answer_query_streaming(processed, question, timestamp)

    def timeline(self, video: str) -> dict:
        if video not in self._videos:
            self.process(video)
        processed = self._videos[video]
        return {
            "video": video,
            "statistics": processed.timeline.get_statistics(),
            "transcript": processed.timeline.build_structured_transcript(),
        }

    def status(self) -> dict:
        return {
            "videos": {
                video: processed.loop.get_status()
                for video, processed in self._videos.items()
            },
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "loaded_videos": list(self._videos),
            "llm_engine": self._engine_server is not None,
        }


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if not length:
                return {}
            return json.loads(self.rfile.read(length))

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            params = urllib.parse.parse_qs(parsed.query)
            try:
                if parsed.path == "/health":
                    self._json(200, service.health())
                elif parsed.path == "/metrics":
                    self._json(200, service.metrics())
                elif parsed.path == "/status":
                    self._json(200, service.status())
                elif parsed.path == "/timeline":
                    video = params.get("video", [None])[0]
                    if not video:
                        self._json(400, {"error": "missing ?video="})
                    else:
                        self._json(200, service.timeline(video))
                else:
                    self._json(404, {"error": f"unknown path {parsed.path}"})
            except Exception as exc:
                logger.exception("GET %s failed", self.path)
                self._json(500, {"error": str(exc)})

        def do_POST(self):
            try:
                body = self._read_body()
                if self.path == "/process":
                    self._json(200, service.process(body["video"]))
                elif self.path == "/query":
                    self._json(200, service.query(
                        body["video"], body["question"],
                        body.get("timestamp"),
                    ))
                elif self.path == "/query/stream":
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for piece in service.query_stream(
                        body["video"], body["question"],
                        body.get("timestamp"),
                    ):
                        data = piece.encode()
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                elif self.path == "/generate":
                    self._json(200, service.generate(body))
                elif self.path == "/chat":
                    self._json(200, service.chat(body))
                elif self.path == "/generate/stream":
                    stream = service.generate_stream(body)  # validate first
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for token in stream:
                        data = f"{token}\n".encode()
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})
            except KeyError as exc:
                self._json(400, {"error": f"missing field {exc}"})
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
            except Exception as exc:
                logger.exception("POST %s failed", self.path)
                self._json(500, {"error": str(exc)})

    return Handler


def create_server(
    host: str = "127.0.0.1", port: int = 8080,
    service: Optional[InferenceService] = None,
) -> ThreadingHTTPServer:
    """An HTTP server for ``service`` (a new one when None); run it with
    ``serve_forever``.  The default bind is loopback: the API has no
    authentication, so exposing it needs a reverse proxy with auth."""
    service = service or InferenceService()
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service  # type: ignore[attr-defined]
    return server

