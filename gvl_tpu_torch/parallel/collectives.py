"""The collectives that GSPMD inserted for the JAX package, written out.

Every function takes the group it runs over (a mesh's ``data_group`` or
``model_group``); a group of None (no world) makes it the identity.  For a
gloo group, CUDA tensors go through the host: copied there, reduced or
moved, copied back.  That is decided by ``dist.get_backend(group)``, once
per call, never by catching an error.  The reducing and gathering ops are
differentiable, as Megatron's regions are:

- :func:`all_reduce_sum`: sum forward, identity backward (a row-parallel
  layer's output);
- :func:`copy_to_group`: identity forward, sum backward (the input of a
  column-parallel layer, whose gradient is partial on each rank);
- :func:`all_gather_cat`: concatenation forward, this rank's slice
  backward (a sharded dimension made whole; the gradient downstream is
  the same on every rank).

:data:`stats` counts the calls and the host seconds spent in them; after
``set_timing(True)`` each call waits for the card before and after, so
that its seconds are the collective's alone (a measurement setting: it
stops the host from running ahead of the card).
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

stats = {"calls": 0, "seconds": 0.0}
_timing = {"sync": False}


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0)


def set_timing(sync: bool) -> None:
    """Whether each call waits for the card around itself (see above)."""
    _timing["sync"] = bool(sync)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def staged(tensor: torch.Tensor, group) -> bool:
    """Whether this call stages ``tensor`` through the host: a CUDA tensor
    on a gloo group."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


class _Timed:
    def __init__(self, tensor: Optional[torch.Tensor] = None):
        self.cuda = _timing["sync"] and tensor is not None and tensor.is_cuda

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - self.start


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    with _Timed(t):
        if staged(t, group):
            host = t.detach().cpu()
            dist.all_reduce(host, group=group)
            return host.to(t.device)
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    with _Timed(t):
        src = t.detach().contiguous()
        if staged(t, group):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(group_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size, ctx.rank = dim, t.shape[dim], group_rank(group)
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group, on every rank of it."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient is summed over the group."""
    if group is None or not t.requires_grad:
        return t
    return _CopyToGroup.apply(t, group)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    return _AllGatherCat.apply(t, dim % t.dim(), group)


def ring_shift(t: torch.Tensor, group, ranks: list[int]) -> torch.Tensor:
    """JAX's ``ppermute`` over a ring: send ``t`` to the next rank of the
    group (``ranks``, the group's global ranks in order) and return what
    the previous one sent (``dist.batch_isend_irecv``)."""
    n = len(ranks)
    if group is None or n == 1:
        return t
    me = group_rank(group)
    with _Timed(t):
        src = t.detach().contiguous()
        if staged(t, group):
            src = src.cpu()
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(me + 1) % n], group),
               dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)


def broadcast_objects(objects: Any, group=None, src: int = 0) -> Any:
    """``objects`` (any picklable value) as rank ``src`` holds it, on every
    rank of the group (the world when ``group`` is None); the identity
    without a world.  Pickled into a byte tensor on the host."""
    if not dist.is_initialized():
        return objects
    with _Timed():
        if dist.get_rank() == src:
            payload = torch.frombuffer(bytearray(pickle.dumps(objects)), dtype=torch.uint8)
            size = torch.tensor([payload.numel()], dtype=torch.int64)
        else:
            size = torch.zeros(1, dtype=torch.int64)
        backend = dist.get_backend(group)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
        size = size.to(device)
        dist.broadcast(size, src, group=group)
        if dist.get_rank() != src:
            payload = torch.empty(int(size.item()), dtype=torch.uint8)
        payload = payload.to(device)
        dist.broadcast(payload, src, group=group)
        return pickle.loads(payload.cpu().numpy().tobytes())


def gloo_cuda_support(group=None) -> dict[str, str]:
    """Which gloo collectives take CUDA tensors directly in this PyTorch:
    each is tried once on a CUDA tensor and reports "yes" or the first line
    of its error.  (The collectives above stage CUDA tensors through the
    host for every gloo group whatever this says.)"""
    t = torch.ones(4, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(group_size(group))], t, group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), 0, group=group),
    }
    out = {}
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            out[name] = "yes"
        except Exception as exc:  # noqa: BLE001 — the probe reports, not hides
            out[name] = f"no ({str(exc).splitlines()[0][:80]})"
    return out


def split_batch(batch, mesh):
    """This data replica's block of ``batch`` (a numpy array or tensor; its
    first axis padded with copies of zero rows to a multiple of the data
    size, as JAX's backends pad before sharding over ``data``) and the
    real count.  Without a mesh: the whole batch."""
    from gvl_tpu_torch.parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    n = len(batch)
    if mesh is None:
        return batch, n
    d = mesh.shape["data"]
    pad = (-n) % d
    if pad:
        if torch.is_tensor(batch):
            batch = torch.cat([batch, torch.zeros_like(batch[:1]).repeat_interleave(pad, 0)])
        else:
            import numpy as np

            batch = np.concatenate([batch, np.zeros_like(batch[:1]).repeat(pad, 0)])
    per = (n + pad) // d
    return batch[mesh.data_index * per:(mesh.data_index + 1) * per], n


def gather_batch(t: torch.Tensor, mesh, n: Optional[int] = None) -> torch.Tensor:
    """Every data replica's block of a batched result, whole and cut to the
    ``n`` real rows, on every rank (the inverse of :func:`split_batch`)."""
    from gvl_tpu_torch.parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    if mesh is None:
        return t[:n]
    if t.dtype == torch.bool:     # gloo reduces no bools: move them as bytes
        return all_gather_cat(t.to(torch.uint8), 0, mesh.data_group)[:n].bool()
    return all_gather_cat(t, 0, mesh.data_group)[:n]
