"""Ring attention: exact attention over sequence-sharded inputs (the port's
copy of :mod:`gvl_tpu.ops.ring_attention`).

Sequence parallelism for contexts that exceed one card: each rank of the
mesh's ``data`` group holds its slice of the sequence of q, k and v
(``[B, H, S / n, D]``, rank ``i`` the ``i``-th slice); each ring step
computes blockwise attention against the K/V chunk it holds while
:func:`~gvl_tpu_torch.parallel.collectives.ring_shift` hands K/V on to the
next rank, and the per-chunk results merge with the online-softmax
log-sum-exp rule, so memory per rank is O(S/n).

The products are plain PyTorch: the JAX body is ``einsum`` and holds no
kernel.  :class:`RingAttention` is differentiable (JAX differentiates
through its ring): the backward runs the ring again from the saved
log-sum-exp, and each K/V chunk's gradient travels with the chunk, so that
after ``n`` shifts it is back on the rank that owns it.
"""

from __future__ import annotations

from typing import Optional

import torch

from gvl_tpu_torch.parallel.collectives import group_rank, ring_shift
from gvl_tpu_torch.parallel.mesh import as_mesh

NEG_INF = -1e30


def _scores(q, k, q_offset: int, kv_offset: int, causal: bool, sm_scale: float):
    """f32 scores ``q k^T * scale`` with positions after a row's own set to
    ``NEG_INF`` when ``causal``."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        scores = scores.masked_fill(~(k_pos <= q_pos), NEG_INF)
    return scores


def _chunk_attention(q, k, v, q_offset: int, kv_offset: int, causal: bool,
                     sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Local block attention; returns (out normalised over this chunk, lse),
    both f32.  Fully masked rows contribute nothing (lse ``NEG_INF``)."""
    scores = _scores(q, k, q_offset, kv_offset, causal, sm_scale)
    row_max = scores.amax(dim=-1)                                   # [B, H, Sq]
    safe_max = torch.where(row_max <= NEG_INF / 2, torch.zeros_like(row_max), row_max)
    p = torch.exp(scores - safe_max[..., None])
    p = torch.where(scores <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)                                               # [B, H, Sq]
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    out = out / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, safe_max + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, NEG_INF))
    return out, lse


def _forward(q, k, v, group, ranks, causal, sm_scale):
    """The ring: (out f32, lse) of this rank's query rows."""
    n = len(ranks)
    me = group_rank(group)
    seq_local = q.shape[2]
    out_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        kv_index = (me - s) % n
        out_i, lse_i = _chunk_attention(q, k_cur, v_cur, me * seq_local,
                                        kv_index * seq_local, causal, sm_scale)
        new_lse = torch.logaddexp(lse_acc, lse_i)
        # renormalize both accumulators onto the merged lse
        out_acc = (out_acc * torch.exp(lse_acc - new_lse)[..., None]
                   + out_i * torch.exp(lse_i - new_lse)[..., None])
        lse_acc = new_lse
        if s < n - 1:      # keep rotating K/V around the ring
            k_cur, v_cur = ring_shift(k_cur, group, ranks), ring_shift(v_cur, group, ranks)
    return out_acc, lse_acc


class RingAttention(torch.autograd.Function):
    """Ring attention with the ring run again in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, group, ranks, causal, sm_scale):
        out, lse = _forward(q, k, v, group, ranks, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.ranks, ctx.causal, ctx.sm_scale = group, ranks, causal, sm_scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, causal, scale = ctx.group, ctx.ranks, ctx.causal, ctx.sm_scale
        n, me, seq_local = len(ranks), group_rank(group), q.shape[2]
        do = grad_out.float()
        delta = (do * out).sum(dim=-1)                                  # [B, H, Sq]
        # fully masked rows (lse NEG_INF) take no weight
        lse_safe = torch.where(lse <= NEG_INF / 2, torch.full_like(lse, float("inf")), lse)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for s in range(n):
            kv_index = (me - s) % n
            scores = _scores(q, k_cur, me * seq_local, kv_index * seq_local, causal, scale)
            p = torch.exp(scores - lse_safe[..., None])                 # softmax weights
            dv_cur = dv_cur + torch.einsum("bhqk,bhqd->bhkd", p, do)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, v_cur.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_cur.float())
            dk_cur = dk_cur + torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
            # the gradients travel with their chunk: n shifts bring them home
            dk_cur, dv_cur = ring_shift(dk_cur, group, ranks), ring_shift(dv_cur, group, ranks)
            if s < n - 1:
                k_cur, v_cur = ring_shift(k_cur, group, ranks), ring_shift(v_cur, group, ranks)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "data",
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention with q/k/v sequence-sharded over ``axis_name``.

    Args:
        q/k/v: ``[B, H, S / n, D]``, this rank's slice of the sequence (rank
            ``i`` of the axis's group holds slice ``i``).
    Returns:
        ``[B, H, S / n, D]``, this rank's rows of the attention output.
    """
    mesh = as_mesh(mesh)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if axis_name == "data":
        group, ranks = mesh.data_group, mesh.data_ranks
    else:
        group, ranks = mesh.model_group, mesh.model_ranks
    return RingAttention.apply(q, k, v, group, list(ranks), causal, scale)
