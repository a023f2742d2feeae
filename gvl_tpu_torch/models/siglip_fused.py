"""Fused W8A8 serving path of the SigLIP vision tower (counterpart of
:mod:`gvl_tpu.models.siglip_fused`).

The encoder runs on the kernels of :mod:`gvl_tpu_torch.ops.quant_matmul`
over a ``[B·Sp, D]`` residual stream (each image's rows padded to a
multiple of :data:`SEQ_PAD`)::

    ln_quant → w8a8_matmul (fused QKV, bf16 out)
      → attention out of the packed projection, requantized to int8
      → w8a8_matmul (o-projection, + residual)
      → ln_quant → w8a8_matmul (fc1, GELU, requantize) → w8a8_matmul (fc2, + residual)

so the ``[M, intermediate]`` activation exists only as int8.  Activation
scales are the static per-layer calibration of
:func:`gvl_tpu_torch.models.siglip.calibrate_siglip_int8`.

The fused layout (:func:`fuse_siglip_int8`, or :func:`gvl_tpu_torch.models.
convert.fused_from_jax` from a JAX fused tree) is a plain dict: the int8
matrices ``[N, K]`` (K contiguous, the transpose of the JAX layout), f32
scale and bias vectors, the inverse quantize scales as Python floats, and
under ``"bf16"`` the patch embed, position embedding, post-norm and the MAP
head's state dict.  The JAX package's per-op TPU tile table (``BLOCKS``)
has no counterpart here; :data:`ATTN_BLOCK_Q` stays, since it sets the q
blocks over which ``int8_attention`` quantizes q.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gvl_tpu_torch.models.siglip import (
    SigLIPVisionConfig,
    calibrate_siglip_int8,
    map_head,
    patchify,
    quantize_siglip_int8,
    resize_pos_embed,
)
from gvl_tpu_torch.ops import quant_matmul as qm

SEQ_PAD = 32   # per-image row multiple of the residual stream (S 729 → 736)
DH_PAD = 128   # per-head columns of the padded QKV/attention layout
ATTN_BLOCK_Q = 1024   # q rows per int8_scores quantize block (clamped to Sp)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _inv(scale) -> float:
    """``1 / scale`` in f32, as the JAX fuse step divides."""
    return float(np.float32(1.0) / np.float32(float(scale)))


def _pad_head_cols(kernel_q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_heads: int):
    """``[D, H·dh]`` weight (and ``[H·dh]`` vectors) → ``[D, H·DH_PAD]``:
    zero columns in each head's pad make the projection emit the padded
    layout."""
    d, hd = kernel_q.shape
    dh = hd // num_heads
    pad = DH_PAD - dh

    def pad_vec(v):
        return F.pad(v.reshape(num_heads, dh), (0, pad)).reshape(-1)

    w = F.pad(kernel_q.reshape(d, num_heads, dh), (0, pad)).reshape(d, -1)
    return w, pad_vec(scale), pad_vec(bias)


def fuse_siglip_int8(state: dict[str, torch.Tensor], config: SigLIPVisionConfig,
                     packed_attention: bool = False) -> dict:
    """Calibrated static-activation W8A8 tower weights (every encoder dense
    with ``kernel_q`` / ``scale`` / ``bias`` / ``act_scale``) → the fused
    layout: q/k/v concatenated, heads padded to :data:`DH_PAD` (or kept
    packed with ``packed_attention``), the MLP width padded to a multiple
    of 128, dequant scales combined (activation x weight), quantize scales
    inverted."""
    d, di = config.hidden_size, config.intermediate_size
    pad = _round_up(di, 128) - di
    n_heads = config.num_heads
    dh = d // n_heads
    f32 = lambda t: t.float()   # noqa: E731

    layers = []
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        dense = lambda name: {k: state[f"{pre}{name}.{k}"]   # noqa: E731
                              for k in ("kernel_q", "scale", "bias", "act_scale")}
        q, k, v = (dense(f"attention.{n}") for n in ("q_proj", "k_proj", "v_proj"))
        o, fc1, fc2 = dense("attention.o_proj"), dense("mlp.fc1"), dense("mlp.fc2")
        act_in = float(q["act_scale"])
        if packed_attention:
            parts = [(p["kernel_q"], f32(p["scale"]), f32(p["bias"])) for p in (q, k, v)]
            w_o = o["kernel_q"]
        else:
            parts = [_pad_head_cols(p["kernel_q"], f32(p["scale"]), f32(p["bias"]),
                                    n_heads) for p in (q, k, v)]
            # the o-projection reads the padded layout through zero rows
            w_o = F.pad(o["kernel_q"].reshape(n_heads, dh, d),
                        (0, 0, 0, DH_PAD - dh)).reshape(n_heads * DH_PAD, d)
        layers.append({
            "ln1_g": f32(state[pre + "ln1.weight"]),
            "ln1_b": f32(state[pre + "ln1.bias"]),
            "ln1_inv": _inv(act_in),
            "w_qkv": torch.cat([p[0] for p in parts], dim=1).T.contiguous(),
            "s_qkv": act_in * torch.cat([p[1] for p in parts]),
            "b_qkv": torch.cat([p[2] for p in parts]),
            "attn_inv": _inv(o["act_scale"]),
            "w_o": w_o.T.contiguous(),
            "s_o": float(o["act_scale"]) * f32(o["scale"]),
            "b_o": f32(o["bias"]),
            "ln2_g": f32(state[pre + "ln2.weight"]),
            "ln2_b": f32(state[pre + "ln2.bias"]),
            "ln2_inv": _inv(fc1["act_scale"]),
            "w1": F.pad(fc1["kernel_q"], (0, pad)).T.contiguous(),
            "s1": F.pad(float(fc1["act_scale"]) * f32(fc1["scale"]), (0, pad)),
            "b1": F.pad(f32(fc1["bias"]), (0, pad)),
            "gelu_inv": _inv(fc2["act_scale"]),
            "w2": F.pad(fc2["kernel_q"], (0, 0, 0, pad)).T.contiguous(),
            "s2": float(fc2["act_scale"]) * f32(fc2["scale"]),
            "b2": f32(fc2["bias"]),
        })

    bf16 = lambda t: t.to(torch.bfloat16)   # noqa: E731
    bf = {
        "patch_kernel": bf16(state["patch_embed.proj.weight"]).T.contiguous(),
        "patch_bias": bf16(state["patch_embed.proj.bias"]),
        "pos_embed": bf16(state["pos_embed"]),
        "post_norm_g": f32(state["post_norm.weight"]),
        "post_norm_b": f32(state["post_norm.bias"]),
        "head": {k[len("head."):]: v for k, v in state.items() if k.startswith("head.")},
    }
    return {"bf16": bf, "layers": layers}


# the four ops of a layer: the kernel wrappers, or their plain versions
# (the plain path, which runs on any device)
KERNEL_OPS = (qm.ln_quant, qm.w8a8_matmul, qm.attention_fused_qkv,
              qm.attention_packed_multihead)
PLAIN_OPS = (qm.ln_quant_reference, qm.w8a8_matmul_reference,
             qm.attention_fused_qkv_reference, qm.attention_packed_multihead_reference)


def _fused_layer(h: torch.Tensor, lp: dict, config: SigLIPVisionConfig, batch: int,
                 seq_pad: int, seq: int, int8_attention: bool = False,
                 packed: bool = False, ops: tuple = KERNEL_OPS) -> torch.Tensor:
    """One encoder layer over the ``[B·Sp, D]`` residual stream."""
    ln_quant, w8a8_matmul, attention_fused_qkv, attention_packed_multihead = ops
    d, n_heads = config.hidden_size, config.num_heads
    eps = config.layer_norm_eps
    sm_scale = 1.0 / float(np.sqrt(d // n_heads))

    xq = ln_quant(h, lp["ln1_g"], lp["ln1_b"], lp["ln1_inv"], eps=eps)
    qkv = w8a8_matmul(xq, lp["w_qkv"], lp["s_qkv"], lp["b_qkv"])
    # the o-projection's activation quantize rides the attention epilogue
    if packed:
        aq = attention_packed_multihead(
            qkv, batch=batch, seq_pad=seq_pad, kv_len=seq, num_heads=n_heads,
            head_dim=d // n_heads, sm_scale=sm_scale, out_scale_inv=lp["attn_inv"])
    else:
        aq = attention_fused_qkv(
            qkv, batch=batch, seq_pad=seq_pad, kv_len=seq, num_heads=n_heads,
            dh_pad=DH_PAD, sm_scale=sm_scale, int8_scores=int8_attention,
            block_q=ATTN_BLOCK_Q, out_scale_inv=lp["attn_inv"])
    h = w8a8_matmul(aq, lp["w_o"], lp["s_o"], lp["b_o"], epilogue="residual",
                    residual=h)
    yq = ln_quant(h, lp["ln2_g"], lp["ln2_b"], lp["ln2_inv"], eps=eps)
    hq = w8a8_matmul(yq, lp["w1"], lp["s1"], lp["b1"], epilogue="gelu_quant",
                     out_scale_inv=lp["gelu_inv"])
    return w8a8_matmul(hq, lp["w2"], lp["s2"], lp["b2"], epilogue="residual",
                       residual=h)


def siglip_fused_apply(fused: dict, pixels: torch.Tensor, config: SigLIPVisionConfig,
                       *, pool: bool = True, int8_attention: bool = False,
                       kernels: bool = True) -> dict[str, torch.Tensor]:
    """Forward pass with the tower's output contract (``last_hidden_state``
    bf16 ``[B, S, D]``, ``pooled`` from the MAP head when ``pool``).
    Pixels ``[B, H, W, 3]``; an off-size canvas resizes the position grid
    in f32.  ``int8_attention`` takes the padded-head attention's
    ``int8_scores`` mode (q, k, p and v in int8); the packed layout ignores
    it, as the JAX package does.  ``kernels=False`` runs the plain versions
    of the fused ops on whatever device the tree is on (the plain path the
    kernels are held to)."""
    cfg = config
    bf = fused["bf16"]
    b = pixels.shape[0]
    nh, nw = pixels.shape[1] // cfg.patch_size, pixels.shape[2] // cfg.patch_size
    x = patchify(pixels.to(torch.bfloat16), cfg.patch_size)
    x = torch.matmul(x, bf["patch_kernel"]) + bf["patch_bias"]
    pos = bf["pos_embed"]
    if x.shape[1] != pos.shape[0]:
        pos = resize_pos_embed(pos, cfg.patches_per_side, nh, nw).to(pos.dtype)
    x = x + pos[None]

    seq, d = x.shape[1], cfg.hidden_size
    seq_pad = _round_up(seq, SEQ_PAD)
    h = F.pad(x, (0, 0, 0, seq_pad - seq)).reshape(b * seq_pad, d)
    # the o-projection's row count tells the layouts apart; at a head_dim
    # of 128 they coincide and the padded kernel serves both
    packed = fused["layers"][0]["w_o"].shape[1] != cfg.num_heads * DH_PAD
    for lp in fused["layers"]:
        h = _fused_layer(h, lp, cfg, b, seq_pad, seq, int8_attention=int8_attention,
                         packed=packed, ops=KERNEL_OPS if kernels else PLAIN_OPS)
    xf = h.reshape(b, seq_pad, d)[:, :seq].float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    x = (xc * torch.rsqrt(var + cfg.layer_norm_eps) * bf["post_norm_g"]
         + bf["post_norm_b"]).to(torch.bfloat16)
    out = {"last_hidden_state": x}
    if pool:
        out["pooled"] = map_head(bf["head"], x, cfg.num_heads, cfg.layer_norm_eps)
    return out


def prepare_fused_siglip(state: dict[str, torch.Tensor], config: SigLIPVisionConfig,
                         sample_pixels: torch.Tensor,
                         packed_attention: bool = False) -> dict:
    """Tower weights → the calibrated fused layout in one call: quantize,
    run the dynamic tower for the activation amax, bake, fuse."""
    qstate = quantize_siglip_int8(state)
    sstate = calibrate_siglip_int8(config, qstate, sample_pixels)
    return fuse_siglip_int8(sstate, config, packed_attention=packed_attention)

