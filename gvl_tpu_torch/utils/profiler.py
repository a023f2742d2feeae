"""Stage profiler: wall-clock stage timings (the port's copy of
``gvl_tpu.utils.profiler.StageTimer``), :func:`stage_scope`,
:func:`device_memory_stats`, :class:`PromptLog`, which records the
prompts a QA engine is handed, and :class:`MessageLog`, which records the
messages a chat backend is handed.

Every stage is a :func:`stage_scope`: a ``torch.profiler.record_function``
range, and an NVTX range where there is a card, so stages show up in a
profile of the run.  A stage's clock stops when its body returns:
the pipeline's stages end in host data, which waits for the card.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Iterator

import torch


class StageTimer:
    """Accumulates per-stage wall-clock seconds.

    >>> timer = StageTimer()
    >>> with timer.stage("frame_extraction"):
    ...     frames = decode()
    >>> timer.timings["frame_extraction"]  # seconds
    """

    def __init__(self) -> None:
        self.timings: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with stage_scope(name):
                yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        if name not in self.timings:
            self._order.append(name)
            self.timings[name] = 0.0
        self.timings[name] += seconds

    @property
    def total(self) -> float:
        return sum(self.timings.values())

    def report(self, title: str = "TIMING BREAKDOWN") -> str:
        """Render the per-stage table the CLI prints after processing."""
        width = max([len(n) for n in self._order] + [10])
        lines = ["=" * (width + 24), title, "-" * (width + 24)]
        for name in self._order:
            secs = self.timings[name]
            pct = 100.0 * secs / self.total if self.total else 0.0
            lines.append(f"{name:<{width}}  {secs:8.2f}s  {pct:5.1f}%")
        lines.append("-" * (width + 24))
        lines.append(f"{'TOTAL':<{width}}  {self.total:8.2f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def stage_scope(name: str) -> Iterator[None]:
    """A named range in a ``torch.profiler`` trace, and an NVTX range when
    a card is present (``gvl_tpu.utils.profiler.stage_scope``'s trace
    annotation)."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def device_memory_stats() -> dict[str, int]:
    """The current card's allocator bytes under the JAX package's names
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``: the card's
    total); empty without a card, as JAX's CPU backend gives."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info()[1])}


class PromptLog:
    """Engine proxy that records the token ids of every prompt it streams,
    so that two paths' rendered prompts can be compared.  Set it in place
    of a chat backend's ``engine``; ``engine`` is the one it wraps."""

    def __init__(self, engine):
        self.engine, self.config, self.prompts = engine, engine.config, []

    def stream(self, prompt_ids, **kw):
        self.prompts.append([int(i) for i in prompt_ids])
        yield from self.engine.stream(prompt_ids, **kw)


class MessageLog:
    """Chat-backend proxy that records the rendered messages of every chat
    it streams (the grounded fake backends read messages, not token ids),
    so that two paths' prompts can be compared.  Set it in place of a
    reasoning core's ``backend``; ``backend`` is the one it wraps."""

    def __init__(self, backend):
        self.backend, self.messages = backend, []

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def stream(self, messages, config, **kw):
        self.messages.append(copy.deepcopy(messages))
        yield from self.backend.stream(messages, config, **kw)
