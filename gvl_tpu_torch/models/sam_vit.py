"""Segment-Anything (SAM ViT): the released promptable-mask model
(counterpart of :mod:`gvl_tpu.models.sam_vit`).

A ViT image encoder with decomposed relative-position attention over
14 x 14 windows and at the global layers, and a convolutional neck; a
prompt encoder of random-Fourier positions for points and boxes; the
two-way mask decoder (token-to-image and image-to-token attention), its
transposed-convolution upscaler, hypernetwork mask heads and IoU head.
Both attentions are plain PyTorch, as the JAX model computes them in plain
``jnp`` (no Pallas kernel).  Images and embeddings are channels-last
``[B, H, W, C]`` as in the JAX package; weights keep HF ``SamModel``'s
layouts (:func:`convert_hf_sam`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import load_module


@dataclass(frozen=True)
class SamViTConfig:
    """Geometry (defaults: facebook/sam-vit-base)."""

    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    output_channels: int = 256
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)
    layer_norm_eps: float = 1e-6
    # prompt encoder / mask decoder
    prompt_hidden: int = 256
    num_pos_feats: int = 128
    decoder_heads: int = 8
    decoder_layers: int = 2
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_hidden: int = 256
    iou_head_depth: int = 3

    @property
    def embed_side(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_hf(cls, hf_config) -> "SamViTConfig":
        """From a HF ``SamConfig`` (its mask decoder's ``layer_norm_eps`` is
        not read: :data:`DECODER_LN_EPS`)."""
        v, p, m = (hf_config.vision_config, hf_config.prompt_encoder_config,
                   hf_config.mask_decoder_config)
        return cls(
            image_size=v.image_size, patch_size=v.patch_size,
            hidden_size=v.hidden_size, num_layers=v.num_hidden_layers,
            num_heads=v.num_attention_heads, mlp_dim=v.mlp_dim,
            output_channels=v.output_channels, window_size=v.window_size,
            global_attn_indexes=tuple(v.global_attn_indexes),
            layer_norm_eps=v.layer_norm_eps, prompt_hidden=p.hidden_size,
            num_pos_feats=v.num_pos_feats, decoder_heads=m.num_attention_heads,
            decoder_layers=m.num_hidden_layers, decoder_mlp_dim=m.mlp_dim,
            attention_downsample_rate=m.attention_downsample_rate,
            num_multimask_outputs=m.num_multimask_outputs,
            iou_head_hidden=m.iou_head_hidden_dim, iou_head_depth=m.iou_head_depth)


# the two-way blocks' LayerNorms: the JAX model's 1e-5, where HF's
# SamMaskDecoderConfig (and the sam-vit-* checkpoints) have 1e-6 (ROADMAP C16)
DECODER_LN_EPS = 1e-5


def _norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, norm.eps)


# --------------------------------------------------------------------------
# vision encoder
# --------------------------------------------------------------------------

def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative-position table ``[2·max - 1, C]`` (resized linearly when
    its length is not that) gathered to ``[q_size, k_size, C]``."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.T[None], size=max_rel_dist, mode="linear",
                                align_corners=False)[0].T
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


class SamVisionAttention(nn.Module):
    """Self-attention over ``[B, H, W, D]`` (a window or the whole grid) with
    decomposed relative-position terms; plain PyTorch."""

    def __init__(self, dim: int, num_heads: int, side: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        head = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, head))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        heads, hd = self.num_heads, d // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * w, hd)
        scores = (q * hd ** -0.5) @ k.transpose(-2, -1)
        rq = q.reshape(b * heads, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, _get_rel_pos(h, h, self.rel_pos_h))
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, _get_rel_pos(w, w, self.rel_pos_w))
        scores = scores + (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(
            scores.shape)
        probs = torch.softmax(scores.float(), -1).to(q.dtype)
        out = (probs @ v).reshape(b, heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, d)
        return self.proj(out)


def _window_partition(x: torch.Tensor, window: int):
    b, h, w, c = x.shape
    pad_h, pad_w = (window - h % window) % window, (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = h + pad_h, w + pad_w
    x = x.reshape(b, ph // window, window, pw // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (ph, pw)


def _window_unpartition(x: torch.Tensor, window: int, padded, original) -> torch.Tensor:
    (ph, pw), (h, w) = padded, original
    b = x.shape[0] // (ph * pw // window // window)
    x = x.reshape(b, ph // window, pw // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, -1)[:, :h, :w]


class SamVisionLayer(nn.Module):
    """Pre-norm ViT block; windowed attention unless ``window`` is 0."""

    def __init__(self, config: SamViTConfig, window: int):
        super().__init__()
        d = config.hidden_size
        self.window = window
        self.norm1 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.attn = SamVisionAttention(d, config.num_heads, window or config.embed_side)
        self.norm2 = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.lin1 = nn.Linear(d, config.mlp_dim)
        self.lin2 = nn.Linear(config.mlp_dim, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _norm(x, self.norm1)
        if self.window:
            hh, ww = h.shape[1], h.shape[2]
            h, padded = _window_partition(h, self.window)
        h = self.attn(h)
        if self.window:
            h = _window_unpartition(h, self.window, padded, (hh, ww))
        x = x + h
        return x + self.lin2(F.gelu(self.lin1(_norm(x, self.norm2))))


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A channels-last ``[B, H, W, C]`` tensor through ``conv``."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamVisionEncoder(nn.Module):
    """Pixels ``[B, S, S, 3]`` (normalised) → image embeddings
    ``[B, S/16, S/16, output_channels]``."""

    def __init__(self, config: SamViTConfig):
        super().__init__()
        d, side = config.hidden_size, config.embed_side
        self.patch_embed = nn.Conv2d(3, d, config.patch_size, stride=config.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, side, side, d))
        self.layers = nn.ModuleList(
            SamVisionLayer(config, 0 if i in config.global_attn_indexes else config.window_size)
            for i in range(config.num_layers))
        c = config.output_channels
        self.neck_conv1 = nn.Conv2d(d, c, 1, bias=False)
        self.neck_ln1 = nn.LayerNorm(c, eps=1e-6)
        self.neck_conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.neck_ln2 = nn.LayerNorm(c, eps=1e-6)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = _conv(self.patch_embed, pixels) + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        x = _norm(_conv(self.neck_conv1, x), self.neck_ln1)
        return _norm(_conv(self.neck_conv2, x), self.neck_ln2)


# --------------------------------------------------------------------------
# prompts
# --------------------------------------------------------------------------

class SamPromptEncoder(nn.Module):
    """Random-Fourier positions (``shared_pe`` ``[2, num_pos_feats]``) and the
    learned point, box-corner, not-a-point and no-mask embeddings."""

    def __init__(self, config: SamViTConfig):
        super().__init__()
        self.config = config
        c = config.prompt_hidden
        self.shared_pe = nn.Parameter(torch.zeros(2, config.num_pos_feats))
        self.point_embed = nn.Parameter(torch.zeros(4, c))
        self.not_a_point = nn.Parameter(torch.zeros(c))
        self.no_mask = nn.Parameter(torch.zeros(c))

    def fourier(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]² ``[..., 2]`` → ``[..., 2 num_pos_feats]``."""
        proj = (2.0 * math.pi) * ((2.0 * coords - 1.0) @ self.shared_pe)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def image_wide_pe(self) -> torch.Tensor:
        """``[1, S', S', prompt_hidden]`` dense positional map."""
        size = self.config.embed_side
        grid = (np.arange(size, dtype=np.float32) + 0.5) / size
        yx = np.stack(np.meshgrid(grid, grid, indexing="ij"), -1)
        coords = torch.from_numpy(yx[..., ::-1].copy()).to(self.shared_pe.device)
        return self.fourier(coords)[None]

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                     pad: bool = True) -> torch.Tensor:
        """points ``[B, P, N, 2]`` pixel xy, labels ``[B, P, N]`` (1 foreground,
        0 background, -1 pad) → ``[B, P, N (+1), prompt_hidden]``."""
        points = (points + 0.5) / self.config.image_size
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :, :1])], dim=2)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :, :1])], dim=2)
        pe = self.fourier(points)
        labels = labels[..., None]
        pe = torch.where(labels == -1, self.not_a_point, pe)
        pe = torch.where(labels == 0, pe + self.point_embed[0], pe)
        return torch.where(labels == 1, pe + self.point_embed[1], pe)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes ``[B, P, 4]`` pixel xyxy → ``[B, P, 2, prompt_hidden]``."""
        b, p, _ = boxes.shape
        pe = self.fourier(((boxes + 0.5) / self.config.image_size).reshape(b, p, 2, 2))
        return pe + self.point_embed[2:4]


# --------------------------------------------------------------------------
# mask decoder
# --------------------------------------------------------------------------

class SamAttention(nn.Module):
    """q/k/v ``[B, P, N, C]`` → ``[B, P, Nq, C]`` over ``C / downsample``
    internal channels; plain PyTorch."""

    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q, self.k, self.v = nn.Linear(dim, inner), nn.Linear(dim, inner), nn.Linear(dim, inner)
        self.out = nn.Linear(inner, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, pb = q.shape[:2]
        query, key, value = self.q(q), self.k(k), self.v(v)
        inner = query.shape[-1]
        hd = inner // self.num_heads

        def split(t):
            return t.reshape(b * pb, t.shape[2], self.num_heads, hd).transpose(1, 2)

        query, key, value = split(query), split(key), split(value)
        scores = (query * hd ** -0.5) @ key.transpose(-2, -1)
        probs = torch.softmax(scores.float(), -1).to(query.dtype)
        out = (probs @ value).transpose(1, 2)
        return self.out(out.reshape(b, pb, out.shape[1], inner))


class SamTwoWayBlock(nn.Module):
    def __init__(self, config: SamViTConfig, skip_first_pe: bool):
        super().__init__()
        c, heads, rate = config.prompt_hidden, config.decoder_heads, \
            config.attention_downsample_rate
        self.skip_first_pe = skip_first_pe
        self.self_attn = SamAttention(c, heads)
        self.cross_t2i = SamAttention(c, heads, rate)
        self.cross_i2t = SamAttention(c, heads, rate)
        self.norm1, self.norm2, self.norm3, self.norm4 = (
            nn.LayerNorm(c, eps=DECODER_LN_EPS) for _ in range(4))
        self.lin1 = nn.Linear(c, config.decoder_mlp_dim)
        self.lin2 = nn.Linear(config.decoder_mlp_dim, c)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = _norm(queries, self.norm1)
        q, k = queries + query_pe, keys + key_pe
        queries = _norm(queries + self.cross_t2i(q, k, keys), self.norm2)
        queries = _norm(queries + self.lin2(F.relu(self.lin1(queries))), self.norm3)
        q, k = queries + query_pe, keys + key_pe
        keys = _norm(keys + self.cross_i2t(k, q, queries), self.norm4)
        return queries, keys


class SamFeedForward(nn.Module):
    """ReLU MLP: proj_in, ``depth - 2`` hidden layers, proj_out."""

    def __init__(self, dim: int, hidden: int, out: int, depth: int):
        super().__init__()
        self.proj_in = nn.Linear(dim, hidden)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(depth - 2))
        self.proj_out = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.proj_in(x))
        for layer in self.layers:
            h = F.relu(layer(h))
        return self.proj_out(h)


def _conv_transpose(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """torch's ConvTranspose2d (kernel = stride = 2) on channels-last ``x``:
    with no overlap, ``out[2i+a, 2j+b, o] = Σ_c x[i, j, c] w[c, o, a, b]``."""
    b, h, w, _ = x.shape
    y = torch.einsum("nhwc,coab->nhawbo", x, weight)
    return y.reshape(b, h * 2, w * 2, weight.shape[1]) + bias


class SamMaskDecoder(nn.Module):
    def __init__(self, config: SamViTConfig):
        super().__init__()
        c = config.prompt_hidden
        self.config = config
        self.num_mask_tokens = config.num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, c))
        self.mask_tokens = nn.Parameter(torch.zeros(self.num_mask_tokens, c))
        self.layers = nn.ModuleList(SamTwoWayBlock(config, i == 0)
                                    for i in range(config.decoder_layers))
        self.final_attn = SamAttention(c, config.decoder_heads, config.attention_downsample_rate)
        self.final_norm = nn.LayerNorm(c, eps=1e-5)
        self.upscale1_weight = nn.Parameter(torch.zeros(c, c // 4, 2, 2))
        self.upscale1_bias = nn.Parameter(torch.zeros(c // 4))
        self.upscale_ln = nn.LayerNorm(c // 4, eps=1e-6)
        self.upscale2_weight = nn.Parameter(torch.zeros(c // 4, c // 8, 2, 2))
        self.upscale2_bias = nn.Parameter(torch.zeros(c // 8))
        self.hypers = nn.ModuleList(SamFeedForward(c, c, c // 8, 3)
                                    for _ in range(self.num_mask_tokens))
        self.iou_head = SamFeedForward(c, config.iou_head_hidden, self.num_mask_tokens,
                                       config.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output=True):
        """image_embeddings ``[B, S', S', C]``; sparse ``[B, P, N, C]``; dense
        ``[B, S', S', C]`` → (masks ``[B, P, M, 4S', 4S']``, iou ``[B, P, M]``)."""
        b, hh, ww, c = image_embeddings.shape
        pb = sparse.shape[1]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens])
        tokens = torch.cat([out_tokens.expand(b, pb, *out_tokens.shape), sparse], dim=2)
        keys = (image_embeddings + dense).reshape(b, 1, hh * ww, c).expand(b, pb, hh * ww, c)
        pe = image_pe.reshape(1, 1, hh * ww, c).expand(b, pb, hh * ww, c)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pe)
        queries = _norm(queries + self.final_attn(queries + tokens, keys + pe, keys),
                        self.final_norm)
        iou_out = queries[:, :, 0]
        mask_out = queries[:, :, 1:1 + self.num_mask_tokens]

        up = _conv_transpose(self.upscale1_weight, self.upscale1_bias,
                             keys.reshape(b * pb, hh, ww, c))
        up = F.gelu(_norm(up, self.upscale_ln))
        up = F.gelu(_conv_transpose(self.upscale2_weight, self.upscale2_bias, up))
        uh, uw, uc = up.shape[1:]
        hyper = torch.stack([head(mask_out[:, :, i]) for i, head in enumerate(self.hypers)],
                            dim=2)
        masks = torch.einsum("bpmc,bpnc->bpmn", hyper, up.reshape(b, pb, uh * uw, uc))
        masks = masks.reshape(b, pb, self.num_mask_tokens, uh, uw)
        iou = self.iou_head(iou_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou[:, :, sl]


class SamViT(nn.Module):
    """The whole model: ``vision``, ``prompt``, ``decoder``."""

    def __init__(self, config: SamViTConfig):
        super().__init__()
        self.config = config
        self.vision = SamVisionEncoder(config)
        self.prompt = SamPromptEncoder(config)
        self.decoder = SamMaskDecoder(config)

    def forward(self, pixels, input_points=None, input_labels=None, input_boxes=None,
                multimask_output: bool = True):
        return sam_predict(self, pixels, input_points, input_labels, input_boxes,
                           multimask_output)


@torch.inference_mode()
def sam_predict(model: SamViT, pixels: torch.Tensor,
                input_points: Optional[torch.Tensor] = None,
                input_labels: Optional[torch.Tensor] = None,
                input_boxes: Optional[torch.Tensor] = None,
                multimask_output: bool = True):
    """Full forward, HF ``SamModel`` semantics: normalised pixels ``[B, S, S,
    3]`` and point (``[B, P, N, 2]`` with labels ``[B, P, N]``) and/or box
    (``[B, P, 4]``) prompts → (low-resolution mask logits ``[B, P, M, 4S',
    4S']``, IoU scores ``[B, P, M]``)."""
    image = model.vision(pixels)
    prompt = model.prompt
    sparse = None
    if input_points is not None:
        sparse = prompt.embed_points(input_points, input_labels.long(),
                                     pad=input_boxes is None)
    if input_boxes is not None:
        box = prompt.embed_boxes(input_boxes)
        sparse = box if sparse is None else torch.cat([sparse, box], dim=2)
    if sparse is None:
        sparse = pixels.new_zeros(pixels.shape[0], 1, 0, model.config.prompt_hidden)
    dense = prompt.no_mask.reshape(1, 1, 1, -1).expand(image.shape)
    return model.decoder(image, prompt.image_wide_pe(), sparse, dense, multimask_output)


# --------------------------------------------------------------------------
# HF conversion
# --------------------------------------------------------------------------

def convert_hf_sam(state_dict: dict, config: SamViTConfig) -> dict[str, torch.Tensor]:
    """A HF ``SamModel`` state dict as the port's :class:`SamViT` state dict
    (JAX's ``convert_hf_sam``); HF's layouts are kept.  The prompt
    encoder's mask embedding (dense mask prompts) is not used, as in JAX."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}

    def copy(ours: str, theirs: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            out[f"{ours}.{leaf}"] = sd[f"{theirs}.{leaf}"]

    vis = "vision_encoder"
    copy("vision.patch_embed", f"{vis}.patch_embed.projection")
    out["vision.pos_embed"] = sd[f"{vis}.pos_embed"]
    for i in range(config.num_layers):
        ours, theirs = f"vision.layers.{i}", f"{vis}.layers.{i}"
        copy(f"{ours}.norm1", f"{theirs}.layer_norm1")
        copy(f"{ours}.norm2", f"{theirs}.layer_norm2")
        copy(f"{ours}.attn.qkv", f"{theirs}.attn.qkv")
        copy(f"{ours}.attn.proj", f"{theirs}.attn.proj")
        copy(f"{ours}.attn", f"{theirs}.attn", ("rel_pos_h", "rel_pos_w"))
        copy(f"{ours}.lin1", f"{theirs}.mlp.lin1")
        copy(f"{ours}.lin2", f"{theirs}.mlp.lin2")
    copy("vision.neck_conv1", f"{vis}.neck.conv1", ("weight",))
    copy("vision.neck_ln1", f"{vis}.neck.layer_norm1")
    copy("vision.neck_conv2", f"{vis}.neck.conv2", ("weight",))
    copy("vision.neck_ln2", f"{vis}.neck.layer_norm2")

    out["prompt.shared_pe"] = sd["shared_image_embedding.positional_embedding"]
    out["prompt.point_embed"] = torch.cat(
        [sd[f"prompt_encoder.point_embed.{i}.weight"] for i in range(4)])
    out["prompt.not_a_point"] = sd["prompt_encoder.not_a_point_embed.weight"][0]
    out["prompt.no_mask"] = sd["prompt_encoder.no_mask_embed.weight"][0]

    dec, tr = "mask_decoder", "mask_decoder.transformer"

    def attention(ours: str, theirs: str) -> None:
        for a, b in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            copy(f"{ours}.{a}", f"{theirs}.{b}")

    out["decoder.iou_token"] = sd[f"{dec}.iou_token.weight"]
    out["decoder.mask_tokens"] = sd[f"{dec}.mask_tokens.weight"]
    for i in range(config.decoder_layers):
        ours, theirs = f"decoder.layers.{i}", f"{tr}.layers.{i}"
        attention(f"{ours}.self_attn", f"{theirs}.self_attn")
        attention(f"{ours}.cross_t2i", f"{theirs}.cross_attn_token_to_image")
        attention(f"{ours}.cross_i2t", f"{theirs}.cross_attn_image_to_token")
        for j in range(1, 5):
            copy(f"{ours}.norm{j}", f"{theirs}.layer_norm{j}")
        copy(f"{ours}.lin1", f"{theirs}.mlp.lin1")
        copy(f"{ours}.lin2", f"{theirs}.mlp.lin2")
    attention("decoder.final_attn", f"{tr}.final_attn_token_to_image")
    copy("decoder.final_norm", f"{tr}.layer_norm_final_attn")
    for j in (1, 2):
        out[f"decoder.upscale{j}_weight"] = sd[f"{dec}.upscale_conv{j}.weight"]
        out[f"decoder.upscale{j}_bias"] = sd[f"{dec}.upscale_conv{j}.bias"]
    copy("decoder.upscale_ln", f"{dec}.upscale_layer_norm")

    def feed_forward(ours: str, theirs: str, depth: int) -> None:
        copy(f"{ours}.proj_in", f"{theirs}.proj_in")
        copy(f"{ours}.proj_out", f"{theirs}.proj_out")
        for j in range(depth - 2):
            copy(f"{ours}.layers.{j}", f"{theirs}.layers.{j}")

    for i in range(config.num_multimask_outputs + 1):
        feed_forward(f"decoder.hypers.{i}", f"{dec}.output_hypernetworks_mlps.{i}", 3)
    feed_forward("decoder.iou_head", f"{dec}.iou_prediction_head", config.iou_head_depth)
    return out


def load_hf_sam(path) -> tuple[SamViTConfig, dict[str, torch.Tensor]]:
    """A local HF SAM checkpoint directory as ``(config, state_dict)`` on the
    CPU: the config through ``transformers.SamConfig`` (imported here only),
    the tensors from ``model.safetensors`` (``safetensors`` when present) or
    ``pytorch_model.bin``."""
    from transformers import SamConfig as HFSamConfig

    from gvl_tpu_torch.models.minilm import read_hf_state

    config = SamViTConfig.from_hf(HFSamConfig.from_pretrained(path))
    return config, convert_hf_sam(read_hf_state(path), config)


def load_sam_vit(config: SamViTConfig, state: dict[str, torch.Tensor],
                 device: str | torch.device = "cuda") -> SamViT:
    """The port's state dict as a :class:`SamViT` on ``device``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = SamViT(config)
    return load_module(model, state, device)
