"""Stage-parallel perception pipeline (the port's copy of
:mod:`gvl_tpu.parallel.pipeline`).

Each perception stage runs in its own worker thread; items stream through
bounded queues, so stage N works on item i while stage N-1 works on item
i+1, with back-pressure when a stage falls behind.  A stage's ``device``
is a ``torch.device``: on a card its worker enters that device, a
``torch.cuda.Stream`` of its own and ``torch.inference_mode`` (all three
are per thread), and synchronises its stream before handing its output
on, so the next stage, on another stream, reads finished tensors.  With
one card every stage is on ``cuda:0``, each on its own stream.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import torch

_STOP = object()


@dataclass
class PipelineStage:
    """One pipeline stage: ``fn(item) -> item`` on the previous stage's
    output, run on ``device`` (None: the caller's default)."""

    name: str
    fn: Callable[[Any], Any]
    device: Optional[torch.device] = None

    def enter(self, stack: contextlib.ExitStack) -> Optional[torch.cuda.Stream]:
        """Enter, in the worker thread, inference mode and on a card the
        stage's device and a stream of its own (returned)."""
        stack.enter_context(torch.inference_mode())
        device = None if self.device is None else torch.device(self.device)
        if device is None or device.type != "cuda":
            return None
        stack.enter_context(torch.cuda.device(device))
        stream = torch.cuda.Stream(device)
        stack.enter_context(torch.cuda.stream(stream))
        return stream

    def run(self, item: Any, stream: Optional[torch.cuda.Stream] = None) -> Any:
        out = self.fn(item)
        if stream is not None:
            # the next stage runs on another stream: hand over finished work
            stream.synchronize()
        return out


@dataclass
class _Envelope:
    index: int
    payload: Any
    error: Optional[BaseException] = None


class PerceptionPipeline:
    """Runs items through stages with one worker thread per stage.

    >>> pipeline = PerceptionPipeline([
    ...     PipelineStage("segment", segment_fn, torch.device("cuda:0")),
    ...     PipelineStage("encode", encode_fn, torch.device("cuda:0")),
    ...     PipelineStage("ocr", ocr_fn, torch.device("cuda:0")),
    ... ])
    >>> for result in pipeline.run(frames):
    ...     ...

    Outputs come in input order; an exception raised by a stage reaches
    the consumer (the items behind it pass the remaining stages untouched).
    """

    def __init__(self, stages: Sequence[PipelineStage], queue_depth: int = 4):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        self.queue_depth = queue_depth
        self.stage_counts = {s.name: 0 for s in self.stages}

    def run(self, items: Iterable[Any]) -> Iterator[Any]:
        """Stream items through all stages; yields outputs in order."""
        queues: list[queue.Queue] = [queue.Queue(maxsize=self.queue_depth)
                                     for _ in range(len(self.stages) + 1)]

        def worker(stage: PipelineStage, q_in: queue.Queue, q_out: queue.Queue) -> None:
            with contextlib.ExitStack() as stack:
                stream = stage.enter(stack)
                while True:
                    envelope = q_in.get()
                    if envelope is _STOP:
                        q_out.put(_STOP)
                        return
                    if envelope.error is None:
                        try:
                            envelope.payload = stage.run(envelope.payload, stream)
                            self.stage_counts[stage.name] += 1
                        except BaseException as exc:  # propagate to the consumer
                            envelope.error = exc
                    q_out.put(envelope)

        threads = [threading.Thread(target=worker, args=(stage, queues[i], queues[i + 1]),
                                    daemon=True, name=f"pipeline-{stage.name}")
                   for i, stage in enumerate(self.stages)]
        for t in threads:
            t.start()

        def feeder() -> None:
            for i, item in enumerate(items):
                queues[0].put(_Envelope(index=i, payload=item))
            queues[0].put(_STOP)

        feed_thread = threading.Thread(target=feeder, daemon=True, name="pipeline-feed")
        feed_thread.start()

        while True:
            envelope = queues[-1].get()
            if envelope is _STOP:
                break
            if envelope.error is not None:
                raise envelope.error
            yield envelope.payload
        for t in threads:
            t.join()
        feed_thread.join()


def assign_stage_devices(num_stages: int,
                         devices: Optional[Sequence[torch.device]] = None
                         ) -> list[Optional[torch.device]]:
    """Round-robin stages over ``devices`` (default: every visible card;
    None for each stage where there is none)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if not devs:
        return [None] * num_stages
    return [devs[i % len(devs)] for i in range(num_stages)]


def build_perception_pipeline(stage_fns: dict[str, Callable],
                              devices: Optional[Sequence[torch.device]] = None,
                              queue_depth: int = 4) -> PerceptionPipeline:
    """Convenience constructor: ``{name: fn}`` → a device-assigned pipeline."""
    assigned = assign_stage_devices(len(stage_fns), devices)
    stages = [PipelineStage(name, fn, device)
              for (name, fn), device in zip(stage_fns.items(), assigned)]
    return PerceptionPipeline(stages, queue_depth=queue_depth)
