"""A world of gloo processes for the multi-device tests on the CPU.

One world serves a whole test module (a module-scoped fixture builds it):
``World(4)`` spawns four ranks that join one ``file://`` store and wait for
work; ``world.run(fn, *args)`` runs ``fn(*args)`` on every rank and returns
the ranks' results in rank order (an exception on any rank is raised here
with its traceback).  ``fn`` must live in a module the ranks can import
without JAX (this one, or the ``torch_*_cases`` modules beside it): the
ranks import no JAX, the test process holds JAX's side.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback


def _worker(rank: int, size: int, store: str, conn) -> None:
    import torch

    torch.set_num_threads(1)
    from gvl_tpu_torch.parallel.mesh import init_distributed

    init_distributed(init_method=store, world_size=size, rank=rank, device="cpu",
                     timeout=datetime.timedelta(seconds=120))
    while True:
        job = conn.recv()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            conn.send(("ok", fn(*args, **kwargs)))
        except Exception:  # noqa: BLE001 — sent back to the test, which raises it
            conn.send(("error", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class World:
    def __init__(self, size: int):
        self.size = size
        self._dir = tempfile.TemporaryDirectory(prefix="torch_world_")
        store = f"file://{os.path.join(self._dir.name, 'store')}"
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(size):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(rank, size, store, child), daemon=True)
            proc.start()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn, *args, timeout: float = 300.0, **kwargs) -> list:
        """Every rank's result; the first rank to fail raises here at once
        (the others may wait in a collective for it: the world is then
        broken)."""
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        results = [None] * self.size
        waiting = set(range(self.size))
        deadline = time.monotonic() + timeout
        while waiting:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(waiting)} gave no result in {timeout} s")
            for rank in sorted(waiting):
                if self._conns[rank].poll(0.05):
                    status, value = self._conns[rank].recv()
                    if status == "error":
                        raise RuntimeError(f"rank {rank}:\n{value}")
                    results[rank] = value
                    waiting.discard(rank)
        return results

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
        self._dir.cleanup()
