"""Fused W8A8 encoder kernels: Hopper kernels and their plain PyTorch
versions.

Counterpart of :mod:`gvl_tpu.ops.quant_matmul`, the kernels of the fused
W8A8 SigLIP tower.  Each wrapper launches its kernel on CUDA tensors and
runs its plain version on CPU tensors:

- :func:`w8a8_matmul` (``csrc/w8a8_matmul.cu``) replaces
  ``w8a8_matmul_pallas``: int8 ``x [M, K]`` times int8 ``w``, then a fused
  epilogue.  The weight is ``[N, K]`` (K contiguous), the transpose of the
  JAX package's ``[K, N]``; the port's fuse step lays it out so.
- :func:`ln_quant` (``csrc/ln_quant.cu``) replaces ``ln_quant_pallas``:
  LayerNorm in f32, then a static int8 quantize.
- :func:`quant_static` (same source, own entry point) replaces
  ``quant_static_pallas``.
- :func:`attention_fused_qkv` (``csrc/encoder_attention.cu``) replaces
  ``attention_fused_qkv_pallas``: attention straight out of the packed
  ``[B·Sp, 3·H·dh_pad]`` projection, heads padded to 128, softmax in exp2
  form, optional int8 requantize and ``int8_scores``.
- :func:`attention_packed_multihead` (same source and entry point) replaces
  ``attention_packed_multihead_pallas``: the same on unpadded heads.
- :func:`attention_qkv_packed` (same) replaces
  ``attention_qkv_packed_pallas``: unpadded heads, softmax with ``exp``.

The plain versions follow the Pallas bodies operation by operation (f32
arithmetic in the same order, ``torch.round`` rounds half to even as
``jnp.round``).  Integer products are exact: int32 on the CPU, float64 on
CUDA (integer matmul is not available there; the sums stay far below 2**53).
"""

from __future__ import annotations

from typing import Optional

import torch

from gvl_tpu_torch.ops import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
EPILOGUES = {"none": 0, "residual": 1, "gelu_quant": 2, "quant": 3}
MAX_HEAD_DIM = 128   # the attention kernel's compute width
INT8_SCORES_MAX_SEQ = 1024   # int8 P V sums stay exact in f32 up to here


def gelu_exp2(y: torch.Tensor) -> torch.Tensor:
    """tanh GELU as ``y * sigmoid(2 t)``, one exp2 and one division
    (``gvl_tpu.ops.quant_matmul._gelu_exp2``)."""
    u = y * y
    arg = (-2.302118131) * y * (1.0 + 0.044715 * u)
    return y / (1.0 + torch.exp2(arg))


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product ``a @ b`` of int8-valued tensors, as int32."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def true_div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as XLA divides, where either side may be a
    Python number: torch computes ``number / tensor`` (and on CUDA ``tensor
    / number``) through a reciprocal, which can be a bit off."""
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def _clip_round(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


# --------------------------------------------------------------------------
# w8a8 matmul
# --------------------------------------------------------------------------

def w8a8_matmul_reference(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    epilogue: str = "none",
    out_scale_inv: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``x_q [M, K] int8 @ w_q [N, K]^T int8`` with the epilogue, plain.

    ``scale`` [N] f32 is the combined dequant scale (activation x weight);
    ``bias`` [N] f32.  Epilogues: ``none`` (out_dtype), ``residual``
    (+ ``residual`` [M, N], out_dtype), ``gelu_quant`` (GELU, then
    ``clip(round(y * out_scale_inv), 127)``, int8), ``quant``
    (``clip(round(y), 127)``, int8).
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    y = int_matmul(x_q, w_q.T).to(torch.float32) * scale[None, :]
    if bias is not None:
        y = y + bias[None, :]
    if epilogue == "gelu_quant":
        return _clip_round(gelu_exp2(y) * out_scale_inv)
    if epilogue == "quant":
        return _clip_round(y)
    if epilogue == "residual":
        return (y + residual.float()).to(out_dtype)
    return y.to(out_dtype)


W8A8_BLOCK_N = (256, 144, 128)   # the kernel's tile widths (wgmma N), widest first


def w8a8_block_n(n: int) -> int:
    """The W8A8 kernel's tile width for ``n`` output columns: the widest
    of :data:`W8A8_BLOCK_N` that divides ``n`` (no ragged last tile: qkv
    6144 and fc1 4352 take 256, the o-projection and fc2 at 1152 take 144),
    else 128."""
    return next((bn for bn in W8A8_BLOCK_N if n % bn == 0), 128)


def _check_w8a8(x_q, w_q, scale, bias, residual, out_dtype) -> tuple[int, int, int]:
    """Raise unless the kernel takes these operands; returns (M, N, K)."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if (x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.shape[1] != k
            or k % 16 or n % 16 or scale.dtype != torch.float32 or scale.shape != (n,)
            or (bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)))
            or out_dtype not in _build.DTYPE_CODES):
        raise ValueError(
            f"w8a8_matmul: needs int8 x [M, K] and w [N, K] with K and N multiples of "
            f"16, f32 scale/bias [N] and an f32 or bf16 output; got x {x_q.dtype} "
            f"{tuple(x_q.shape)}, w {w_q.dtype} {tuple(w_q.shape)}, out {out_dtype}")
    if residual is not None and (residual.shape != (m, n) or residual.dtype != out_dtype):
        raise ValueError(f"w8a8_matmul: residual must be {out_dtype} [{m}, {n}]")
    if any(t is not None and t.data_ptr() % 16 for t in (x_q, w_q, scale, bias, residual)):
        raise ValueError("w8a8_matmul: x, w, scale, bias and residual must be 16-byte aligned")
    return m, n, k


def w8a8_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    epilogue: str = "none",
    out_scale_inv: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The W8A8 product: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors.  Arguments as :func:`w8a8_matmul_reference`.

    The kernel takes 16-byte aligned int8 operands with K and N multiples
    of 16, f32 scale and bias, an f32 or bf16 output (and residual of that
    type); anything else raises.  Its tile width is
    :func:`w8a8_block_n` of N.  Each launch adds one to
    ``w8a8_matmul.launches``.
    """
    if epilogue == "gelu_quant" and out_scale_inv is None:
        raise ValueError("gelu_quant needs out_scale_inv")
    if epilogue == "residual" and residual is None:
        raise ValueError("the residual epilogue needs residual")
    if x_q.device.type == "cpu":
        return w8a8_matmul_reference(x_q, w_q, scale, bias, epilogue=epilogue,
                                     out_scale_inv=out_scale_inv,
                                     residual=residual, out_dtype=out_dtype)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    operands = [x_q, w_q, scale] + [t for t in (bias, residual) if t is not None]
    index = _build.require_cuda("w8a8_matmul", *operands)
    m, n, k = _check_w8a8(x_q, w_q, scale, bias, residual, out_dtype)
    int8_out = epilogue in ("gelu_quant", "quant")
    out = torch.empty(m, n, dtype=torch.int8 if int8_out else out_dtype,
                      device=x_q.device)
    err = _build.entry("gvl_w8a8_matmul")(
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        m, n, k, EPILOGUES[epilogue],
        0.0 if out_scale_inv is None else float(out_scale_inv),
        _build.DTYPE_CODES[out_dtype], w8a8_block_n(n), _build.stream_handle(index))
    _build.check(err, "w8a8_matmul")
    _build.count_launch(w8a8_matmul)
    return out


w8a8_matmul.launches = 0


# --------------------------------------------------------------------------
# LayerNorm + quantize, quantize
# --------------------------------------------------------------------------

def ln_quant_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       inv_scale: float, *, eps: float = 1e-6) -> torch.Tensor:
    """f32 LayerNorm over the last axis, x gamma + beta, then
    ``clip(round(y * inv_scale), 127)`` as int8."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma[None, :] + beta[None, :]
    return _clip_round(y * inv_scale)


def ln_quant(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             inv_scale: float, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm + quantize: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors.  The kernel takes f32 or bf16 ``x [M, D]`` with
    D a multiple of 8 and f32 gamma, beta, all 16-byte aligned; each launch
    adds one to ``ln_quant.launches``."""
    if x.device.type == "cpu":
        return ln_quant_reference(x, gamma, beta, inv_scale, eps=eps)
    index = _build.require_cuda("ln_quant", x, gamma, beta)
    rows, d = x.shape
    if (x.dtype not in _build.DTYPE_CODES or d % 8 or gamma.shape != (d,)
            or beta.shape != (d,) or gamma.dtype != torch.float32
            or beta.dtype != torch.float32):
        raise ValueError(f"ln_quant: needs f32/bf16 x [M, D] with D % 8 == 0 and "
                         f"f32 gamma, beta [D]; got {x.dtype} {tuple(x.shape)}")
    if any(t.data_ptr() % 16 for t in (x, gamma, beta)):
        raise ValueError("ln_quant: x, gamma and beta must be 16-byte aligned")
    out = torch.empty(rows, d, dtype=torch.int8, device=x.device)
    err = _build.entry("gvl_ln_quant")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), rows,
        d, float(eps), float(inv_scale), _build.DTYPE_CODES[x.dtype],
        _build.stream_handle(index))
    _build.check(err, "ln_quant")
    _build.count_launch(ln_quant)
    return out


ln_quant.launches = 0


def quant_static_reference(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """``clip(round(x * inv_scale), 127)`` as int8."""
    return _clip_round(x.float() * inv_scale)


def quant_static(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """Static quantize: the Hopper kernel on CUDA tensors (f32 or bf16, a
    multiple of 8 elements), the plain version on CPU tensors.  Each launch
    adds one to ``quant_static.launches``."""
    if x.device.type == "cpu":
        return quant_static_reference(x, inv_scale)
    index = _build.require_cuda("quant_static", x)
    if x.dtype not in _build.DTYPE_CODES or x.numel() % 8:
        raise ValueError(f"quant_static: needs f32/bf16 with a multiple of 8 "
                         f"elements, got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("quant_static: x must be 16-byte aligned")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = _build.entry("gvl_quant_static")(
        x.data_ptr(), out.data_ptr(), x.numel(), float(inv_scale),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(index))
    _build.check(err, "quant_static")
    _build.count_launch(quant_static)
    return out


quant_static.launches = 0


# --------------------------------------------------------------------------
# attention out of the packed QKV projection
# --------------------------------------------------------------------------

def _split_heads(qkv: torch.Tensor, batch: int, seq_pad: int, num_heads: int,
                 head_dim: int):
    """q, k, v ``[B, H, Sp, dh]`` views of ``qkv [B·Sp, 3·H·dh]``."""
    if qkv.shape != (batch * seq_pad, 3 * num_heads * head_dim):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} inconsistent with "
                         f"B={batch} Sp={seq_pad} H={num_heads} dh={head_dim}")
    parts = qkv.view(batch, seq_pad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """``[B, H, Sp, dh]`` → ``[B·Sp, H·dh]``."""
    b, h, sp, dh = out.shape
    return out.permute(0, 2, 1, 3).reshape(b * sp, h * dh)


def _mask(s: torch.Tensor, kv_len: int) -> torch.Tensor:
    if kv_len != s.shape[-1]:
        s = s.clone()
        s[..., kv_len:] = NEG_INF
    return s


def _quant_block(x: torch.Tensor):
    """Per-block symmetric int8 over the last two axes, as the TPU body's
    ``quant_block``: (int8-valued f32, amax / 127)."""
    amax = torch.clamp(x.abs().amax(dim=(-2, -1), keepdim=True), min=1e-8)
    inv = true_div(127.0, amax)
    return torch.clamp(torch.round(x * inv), -127, 127), true_div(amax, 127.0)


def _q_block(seq_pad: int, block_q: int) -> int:
    """The q block of the int8_scores quantize: ``min(block_q, Sp)``, halved
    until it divides Sp (the TPU kernel's grid step)."""
    bq = min(block_q, seq_pad)
    while seq_pad % bq:
        bq //= 2
    return bq


def _attention_plain(q, k, v, *, kv_len: int, scale: float, exp2: bool,
                     int8_scores: bool = False, block_q: int = 1024):
    """Single-block softmax attention over ``[B, H, Sp, dh]`` slabs as the
    TPU bodies compute it; returns the f32 output before any requantize."""
    seq_pad = q.shape[2]
    if int8_scores:
        bq = _q_block(seq_pad, block_q)
        b, h, _, dh = q.shape
        q8, sq = _quant_block(q.float().reshape(b, h, seq_pad // bq, bq, dh))
        k8, sk = _quant_block(k.float())
        s = int_matmul(q8, k8.transpose(-1, -2)[:, :, None]).to(torch.float32)
        s = (s * (sq * sk[:, :, None] * scale)).reshape(b, h, seq_pad, seq_pad)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = _mask(s, kv_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m) if exp2 else torch.exp(s - m)
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if int8_scores:
        p8 = torch.round(p * 127.0)
        v8, sv = _quant_block(v.float())
        out = int_matmul(p8, v8).to(torch.float32) * true_div(sv, 127.0)
    else:
        out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out / denom


def _finish(out: torch.Tensor, out_scale_inv: Optional[float],
            dtype: torch.dtype) -> torch.Tensor:
    out = _merge_heads(out)
    if out_scale_inv is not None:
        return _clip_round(out * out_scale_inv)
    return out.to(dtype)


def attention_fused_qkv_reference(qkv, *, batch, seq_pad, kv_len, num_heads,
                                  dh_pad, sm_scale, int8_scores: bool = False,
                                  block_q: int = 1024, out_scale_inv=None):
    """Plain version of the padded-head kernel (``_padded_attn_kernel``):
    ``qkv [B·Sp, 3·H·dh_pad]`` → ``[B·Sp, H·dh_pad]`` (int8 with
    ``out_scale_inv``).  With ``int8_scores`` q is quantized per q block of
    ``block_q`` rows (halved until it divides Sp), k and v per whole slab,
    p as ``round(p * 127)``, as the TPU body does."""
    q, k, v = _split_heads(qkv, batch, seq_pad, num_heads, dh_pad)
    out = _attention_plain(q, k, v, kv_len=kv_len, scale=sm_scale * LOG2E,
                           exp2=True, int8_scores=int8_scores, block_q=block_q)
    return _finish(out, out_scale_inv, qkv.dtype)


def attention_packed_multihead_reference(qkv, *, batch, seq_pad, kv_len,
                                         num_heads, head_dim, sm_scale,
                                         out_scale_inv=None):
    """Plain version of ``_packed_mh_attn_kernel``: unpadded heads, exp2."""
    q, k, v = _split_heads(qkv, batch, seq_pad, num_heads, head_dim)
    out = _attention_plain(q, k, v, kv_len=kv_len, scale=sm_scale * LOG2E, exp2=True)
    return _finish(out, out_scale_inv, qkv.dtype)


def attention_qkv_packed_reference(qkv, *, batch, seq_pad, kv_len, num_heads,
                                   head_dim, sm_scale):
    """Plain version of ``_packed_attn_kernel``: unpadded heads, exp, the
    output in qkv's type."""
    q, k, v = _split_heads(qkv, batch, seq_pad, num_heads, head_dim)
    out = _attention_plain(q, k, v, kv_len=kv_len, scale=sm_scale, exp2=False)
    return _finish(out, None, qkv.dtype)


def _encoder_attention(name: str, qkv, *, batch, seq_pad, kv_len, num_heads,
                       head_dim, scale, exp2, out_scale_inv, int8_scores=False,
                       block_q=1024):
    """Launch ``csrc/encoder_attention.cu`` (shared by B9, B10 and B12)."""
    index = _build.require_cuda(name, qkv)
    _split_heads(qkv, batch, seq_pad, num_heads, head_dim)   # raises on a bad shape
    if (qkv.dtype not in _build.DTYPE_CODES or head_dim > MAX_HEAD_DIM
            or head_dim % 8 or not 1 <= kv_len <= seq_pad or qkv.data_ptr() % 16):
        raise ValueError(f"{name}: needs f32/bf16 qkv (16-byte aligned), head_dim "
                         f"a multiple of 8 up to {MAX_HEAD_DIM} and 1 <= kv_len <= "
                         f"Sp; got {qkv.dtype}, head_dim {head_dim}, kv_len {kv_len}")
    bq = _q_block(seq_pad, block_q)
    if int8_scores and seq_pad > INT8_SCORES_MAX_SEQ:
        raise ValueError(f"{name}: int8_scores takes Sp <= {INT8_SCORES_MAX_SEQ}")
    quant_out = out_scale_inv is not None
    out = torch.empty(batch * seq_pad, num_heads * head_dim,
                      dtype=torch.int8 if quant_out else qkv.dtype, device=qkv.device)
    amax = (torch.empty(batch, num_heads, seq_pad // bq + 2, dtype=torch.float32,
                        device=qkv.device) if int8_scores else None)
    err = _build.entry("gvl_encoder_attention")(
        qkv.data_ptr(), out.data_ptr(), None if amax is None else amax.data_ptr(),
        batch, num_heads, seq_pad, int(kv_len), head_dim, float(scale), int(exp2),
        int(quant_out), float(out_scale_inv) if quant_out else 0.0,
        int(int8_scores), bq, _build.DTYPE_CODES[qkv.dtype],
        _build.stream_handle(index))
    _build.check(err, name)
    return out


def attention_fused_qkv(qkv, *, batch, seq_pad, kv_len, num_heads, dh_pad,
                        sm_scale, int8_scores: bool = False, block_q: int = 1024,
                        out_scale_inv=None):
    """Attention out of the head-padded projection: the Hopper kernel on
    CUDA tensors, the plain version on CPU tensors.  Each launch adds one to
    ``attention_fused_qkv.launches``."""
    kw = dict(batch=batch, seq_pad=seq_pad, kv_len=kv_len, num_heads=num_heads,
              sm_scale=sm_scale, out_scale_inv=out_scale_inv)
    if qkv.device.type == "cpu":
        return attention_fused_qkv_reference(qkv, dh_pad=dh_pad, int8_scores=int8_scores,
                                             block_q=block_q, **kw)
    out = _encoder_attention("attention_fused_qkv", qkv, batch=batch, seq_pad=seq_pad,
                             kv_len=kv_len, num_heads=num_heads, head_dim=dh_pad,
                             scale=sm_scale * LOG2E, exp2=True,
                             out_scale_inv=out_scale_inv, int8_scores=int8_scores,
                             block_q=block_q)
    _build.count_launch(attention_fused_qkv)
    return out


attention_fused_qkv.launches = 0


def attention_packed_multihead(qkv, *, batch, seq_pad, kv_len, num_heads,
                               head_dim, sm_scale, out_scale_inv=None):
    """Attention out of the unpadded projection (exp2, optional requantize):
    the Hopper kernel on CUDA tensors, the plain version on CPU tensors.
    Each launch adds one to ``attention_packed_multihead.launches``."""
    kw = dict(batch=batch, seq_pad=seq_pad, kv_len=kv_len, num_heads=num_heads,
              head_dim=head_dim, sm_scale=sm_scale, out_scale_inv=out_scale_inv)
    if qkv.device.type == "cpu":
        return attention_packed_multihead_reference(qkv, **kw)
    out = _encoder_attention("attention_packed_multihead", qkv, batch=batch,
                             seq_pad=seq_pad, kv_len=kv_len, num_heads=num_heads,
                             head_dim=head_dim, scale=sm_scale * LOG2E, exp2=True,
                             out_scale_inv=out_scale_inv)
    _build.count_launch(attention_packed_multihead)
    return out


attention_packed_multihead.launches = 0


def attention_qkv_packed(qkv, *, batch, seq_pad, kv_len, num_heads, head_dim,
                         sm_scale):
    """Attention out of the unpadded projection (exp, output in qkv's type):
    the Hopper kernel on CUDA tensors, the plain version on CPU tensors.
    Each launch adds one to ``attention_qkv_packed.launches``."""
    if qkv.device.type == "cpu":
        return attention_qkv_packed_reference(
            qkv, batch=batch, seq_pad=seq_pad, kv_len=kv_len, num_heads=num_heads,
            head_dim=head_dim, sm_scale=sm_scale)
    out = _encoder_attention("attention_qkv_packed", qkv, batch=batch, seq_pad=seq_pad,
                             kv_len=kv_len, num_heads=num_heads, head_dim=head_dim,
                             scale=sm_scale, exp2=False, out_scale_inv=None)
    _build.count_launch(attention_qkv_packed)
    return out


attention_qkv_packed.launches = 0
