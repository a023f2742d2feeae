"""Qwen3-VL in PyTorch: vision tower, DeepStack and the mRoPE text decoder.

Counterpart of :mod:`gvl_tpu.models.qwen3vl` (the reference's flagship
model, Qwen3-VL-8B-Instruct):

- vision tower: pre-patchified pixels -> dense patch embedding, bilinearly
  interpolated learned positions, 2-D rotary attention blocks, a 2x2
  spatial-merge projector and DeepStack mergers tapping intermediate
  blocks.  Each block's attention goes through
  :func:`gvl_tpu_torch.nn.layers.attend` (the flash kernel on CUDA tensors,
  head 72 padded to 80 by its wrapper), so ``use_flash_kernel``,
  :func:`~gvl_tpu_torch.nn.layers.set_flash_kernel` and
  :func:`~gvl_tpu_torch.nn.layers.plain_attention` steer it as they steer
  every encoder;
- text decoder: the port's :class:`~gvl_tpu_torch.models.qwen3.Qwen3Model`
  with interleaved mRoPE tables in the prefill and DeepStack features added
  after its first layers at the visual positions;
- image tokens in the prompt are replaced by the merged visual embeddings.

The host math (position interpolation, the vision rotary table, the patch
layout and the T/H/W position ids) is the JAX package's numpy, copied.

Settled divergences (ROADMAP C9, C11): the tower attends over all ``T.H.W``
patches at once, as JAX's does (HF's attends within each temporal frame;
the served backend sends one frame, where the two agree); and
:meth:`Qwen3VL.generate` takes ``cache_dtype``, bf16 by default, since the
decode kernel reads bf16 caches only (JAX's VL ``generate`` makes an f32
cache; the CPU tests pass ``torch.float32`` to match it token for token).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import (
    KVCache,
    Qwen3Config,
    Qwen3Model,
    call_generator,
    convert_hf_qwen3,
    hf_text_config,
    init_params,
    sample_logits,
)
from gvl_tpu_torch.nn.layers import LayerNorm, attend, gelu_tanh, init_state
from gvl_tpu_torch.ops.rope import apply_rope


@dataclass(frozen=True)
class Qwen3VLVisionConfig:
    """Defaults: Qwen3-VL-8B's vision tower."""

    hidden_size: int = 1152
    depth: int = 27
    num_heads: int = 16
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    intermediate_size: int = 4304
    out_hidden_size: int = 4096
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: tuple[int, ...] = (8, 16, 24)
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid_per_side(self) -> int:
        return int(self.num_position_embeddings ** 0.5)

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @classmethod
    def tiny(cls) -> "Qwen3VLVisionConfig":
        return cls(hidden_size=32, depth=2, num_heads=2, intermediate_size=64,
                   out_hidden_size=48, num_position_embeddings=16,
                   deepstack_visual_indexes=(0, 1))


# ---------------------------------------------------------------- host math

def interpolated_pos_indices(
    config: Qwen3VLVisionConfig, grid_thw: tuple[int, int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear (idx[4, HW], weight[4, HW]) over the learned position grid,
    permuted into spatial-merge-block token order and tiled over T (the
    interpolation in float64, as ``np.linspace`` gives it, the weights f32)."""
    t, h, w = grid_thw
    side = config.grid_per_side
    h_idx = np.linspace(0, side - 1, h)
    w_idx = np.linspace(0, side - 1, w)
    h_floor = h_idx.astype(np.int64)
    w_floor = w_idx.astype(np.int64)
    h_ceil = np.clip(h_floor + 1, None, side - 1)
    w_ceil = np.clip(w_floor + 1, None, side - 1)
    dh = (h_idx - h_floor)[:, None]
    dw = (w_idx - w_floor)[None, :]

    idx = np.stack([
        (h_floor[:, None] * side + w_floor[None, :]).ravel(),
        (h_floor[:, None] * side + w_ceil[None, :]).ravel(),
        (h_ceil[:, None] * side + w_floor[None, :]).ravel(),
        (h_ceil[:, None] * side + w_ceil[None, :]).ravel(),
    ])
    weight = np.stack([
        ((1 - dh) * (1 - dw)).ravel(),
        ((1 - dh) * dw).ravel(),
        (dh * (1 - dw)).ravel(),
        (dh * dw).ravel(),
    ])
    # raster -> merge-block order, tiled over t
    m = config.spatial_merge_size
    order = np.arange(h * w).reshape(h // m, m, w // m, m)
    order = order.transpose(0, 2, 1, 3).ravel()
    idx = idx[:, order]
    weight = weight[:, order]
    idx = np.tile(idx, (1, t))
    weight = np.tile(weight, (1, t))
    return idx, weight.astype(np.float32)


def vision_rope_table(
    config: Qwen3VLVisionConfig, grid_thw: tuple[int, int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """2-D rotary (cos, sin) [seq, head_dim] in merge-block token order."""
    t, h, w = grid_thw
    m = config.spatial_merge_size
    half = config.head_dim // 2  # rotary dim; split across (row, col)
    inv = 1.0 / (10000.0 ** (np.arange(0, half, 2) / half))

    rows = np.arange(h)[:, None].repeat(w, 1)
    cols = np.arange(w)[None, :].repeat(h, 0)
    order = np.arange(h * w).reshape(h // m, m, w // m, m)
    order = order.transpose(0, 2, 1, 3).ravel()
    rows = rows.ravel()[order]
    cols = cols.ravel()[order]

    freqs = np.concatenate(
        [rows[:, None] * inv[None, :], cols[:, None] * inv[None, :]], axis=1
    )  # [HW, half]
    emb = np.concatenate([freqs, freqs], axis=1)  # [HW, head_dim]
    emb = np.tile(emb, (t, 1))
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def patchify_frames(
    frames: np.ndarray, config: Qwen3VLVisionConfig
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """[T, H, W, 3] uint8/float -> (patches [seq, C*tp*ps*ps] f32, grid_thw),
    in the Qwen-VL processor's layout: tokens in spatial-merge-block order,
    each patch vector flattening (C, tp, ps, ps).  An odd T repeats the last
    frame."""
    ps, tp, m = (config.patch_size, config.temporal_patch_size,
                 config.spatial_merge_size)
    t, h, w, c = frames.shape
    if t % tp:
        frames = np.concatenate(
            [frames, frames[-1:].repeat(tp - t % tp, 0)], axis=0)
        t = frames.shape[0]
    gt, gh, gw = t // tp, h // ps, w // ps
    x = frames.astype(np.float32)
    x = x.reshape(gt, tp, gh // m, m, ps, gw // m, m, ps, c)
    # -> [gt, gh/m, gw/m, m(h), m(w), C, tp, ps(h), ps(w)]
    x = x.transpose(0, 2, 5, 3, 6, 8, 1, 4, 7)
    patches = x.reshape(gt * gh * gw, c * tp * ps * ps)
    return patches, (gt, gh, gw)


def vl_position_ids(
    input_ids: np.ndarray,       # [B, S]
    grid_thw: tuple[int, int, int],
    image_token_id: int,
    spatial_merge_size: int = 2,
) -> np.ndarray:
    """[3, B, S] (t, h, w) position triples, one image span per row.

    Text tokens advance all three axes together; the image span holds T
    constant while H/W sweep the merged grid; text after the image resumes
    from max(position) + 1 (the Qwen-VL ``get_rope_index`` rule).
    """
    batch, seq = input_ids.shape
    t, h, w = grid_thw
    mh, mw = h // spatial_merge_size, w // spatial_merge_size
    out = np.zeros((3, batch, seq), np.int64)
    for b in range(batch):
        ids = input_ids[b]
        image_positions = np.where(ids == image_token_id)[0]
        cursor = 0   # next text position value
        pos = 0      # index into the sequence
        while pos < seq:
            if len(image_positions) and pos == image_positions[0]:
                n_vis = t * mh * mw
                t_idx = np.repeat(np.arange(t), mh * mw)
                h_idx = np.tile(np.repeat(np.arange(mh), mw), t)
                w_idx = np.tile(np.arange(mw), t * mh)
                span = slice(pos, pos + n_vis)
                out[0, b, span] = cursor + t_idx
                out[1, b, span] = cursor + h_idx
                out[2, b, span] = cursor + w_idx
                cursor = cursor + int(max(t, mh, mw))
                pos += n_vis
                image_positions = image_positions[n_vis:]
            else:
                out[:, b, pos] = cursor
                cursor += 1
                pos += 1
    return out


def mrope_cos_sin(
    position_ids: torch.Tensor,   # [3, B, S] (t, h, w)
    head_dim: int,
    rope_theta: float,
    mrope_section: tuple[int, int, int] = (24, 20, 20),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved mRoPE tables [B, S, head_dim] in f32 (HF's
    ``apply_interleaved_mrope``): lane j of the half takes its angle from
    the H axis when j % 3 == 1 and j < 3 * section[1], from W when
    j % 3 == 2 and j < 3 * section[2], else from T."""
    half = head_dim // 2
    dev = position_ids.device
    exponent = torch.arange(0, half, dtype=torch.float32, device=dev) * 2 / head_dim
    inv = 1.0 / torch.pow(torch.tensor(rope_theta, dtype=torch.float32, device=dev),
                          exponent)
    freqs = position_ids[..., None].to(torch.float32) * inv   # [3, B, S, half]
    lanes = np.zeros(half, dtype=np.int64)  # 0=T, 1=H, 2=W
    for dim, offset in ((1, 1), (2, 2)):
        lanes[offset:mrope_section[dim] * 3:3] = dim
    lanes = torch.as_tensor(lanes, device=dev)
    out = torch.where(lanes == 1, freqs[1], freqs[0])
    out = torch.where(lanes == 2, freqs[2], out)
    emb = torch.cat([out, out], dim=-1)
    return torch.cos(emb), torch.sin(emb)


# ------------------------------------------------------------- vision tower

class _VisionBlock(nn.Module):
    """Pre-norm block: 2-D rotary attention (fused qkv) and a tanh-GELU MLP."""

    use_flash_kernel = True

    def __init__(self, cfg: Qwen3VLVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        seq, d = x.shape
        qkv = self.qkv(self.norm1(x)).view(seq, 3, self.num_heads, -1)

        def heads(t):       # [seq, H, Dh] -> [1, H, seq, Dh]
            return t.transpose(0, 1)[None].contiguous()

        q = apply_rope(qkv[:, 0], cos[:, None], sin[:, None])
        k = apply_rope(qkv[:, 1], cos[:, None], sin[:, None])
        out = attend(self, heads(q), heads(k), heads(qkv[:, 2]))
        x = x + self.proj(out[0].transpose(0, 1).reshape(seq, d))
        return x + self.fc2(gelu_tanh(self.fc1(self.norm2(x))))


class _PatchMerger(nn.Module):
    """2x2 spatial merge: LayerNorm (before or after the merge), then an
    exact-GELU MLP to the decoder's width."""

    def __init__(self, cfg: Qwen3VLVisionConfig, postshuffle_norm: bool = False):
        super().__init__()
        self.merged = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.postshuffle_norm = postshuffle_norm
        self.norm = LayerNorm(self.merged if postshuffle_norm else cfg.hidden_size,
                              cfg.layer_norm_eps)
        self.fc1 = nn.Linear(self.merged, self.merged)
        self.fc2 = nn.Linear(self.merged, cfg.out_hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.postshuffle_norm:
            x = self.norm(x.reshape(-1, self.merged))
        else:
            x = self.norm(x).reshape(-1, self.merged)
        return self.fc2(F.gelu(self.fc1(x)))


class Qwen3VLVisionTower(nn.Module):
    """Pre-patchified pixels + a static grid -> (merged embeddings
    ``[seq / merge^2, out]``, one DeepStack feature of that shape per tap)."""

    def __init__(self, config: Qwen3VLVisionConfig):
        super().__init__()
        cfg = self.config = config
        self.patch_proj = nn.Linear(cfg.patch_dim, cfg.hidden_size)
        self.pos_embed = nn.Parameter(torch.empty(cfg.num_position_embeddings,
                                                  cfg.hidden_size))
        self.blocks = nn.ModuleList(_VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = _PatchMerger(cfg)
        self.deepstack = nn.ModuleList(_PatchMerger(cfg, postshuffle_norm=True)
                                       for _ in cfg.deepstack_visual_indexes)
        self._tables: dict = {}

    def _grid_tables(self, grid_thw: tuple[int, int, int], device: torch.device) -> tuple:
        """The host tables of a grid (position taps and weights, rotary cos
        and sin) on ``device``, made once per grid and device."""
        key = (tuple(grid_thw), device)
        if key not in self._tables:
            tables = (*interpolated_pos_indices(self.config, grid_thw),
                      *vision_rope_table(self.config, grid_thw))
            self._tables[key] = tuple(torch.as_tensor(t, device=device) for t in tables)
        return self._tables[key]

    def forward(self, patches: torch.Tensor, grid_thw: tuple[int, int, int]
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        cfg = self.config
        x = self.patch_proj(patches.to(self.patch_proj.weight.dtype))
        idx, weight, cos, sin = self._grid_tables(grid_thw, patches.device)
        pos = (self.pos_embed[idx].float() * weight[..., None]).sum(0)
        x = x + pos.to(x.dtype)
        deepstack = []
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin)
            if i in cfg.deepstack_visual_indexes:
                merger = self.deepstack[cfg.deepstack_visual_indexes.index(i)]
                deepstack.append(merger(x))
        return self.merger(x), deepstack


# ---------------------------------------------------------------- VL model

def _split(state_dict: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


class Qwen3VL:
    """Vision tower + mRoPE text decoder with DeepStack injection, on ``device``.

    >>> vl = Qwen3VL(vision_cfg, text_cfg, state_dict, device="cuda")
    >>> logits = vl.forward(input_ids, patches, grid_thw)

    ``state_dict`` holds the tower's tensors under ``vision.`` and the
    decoder's under ``text.`` (:func:`convert_hf_qwen3vl`,
    ``models.convert.qwen3vl_params_from_jax``, :func:`init_vl_params`).
    The decoder must be unrolled (``scan_layers`` off): DeepStack and mRoPE
    take the unrolled stack.
    """

    def __init__(
        self,
        vision_config: Qwen3VLVisionConfig,
        text_config: Qwen3Config,
        state_dict: dict[str, torch.Tensor],
        image_token_id: int = 151655,
        mrope_section: tuple[int, int, int] = (24, 20, 20),
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        """``mesh``: the text decoder tensor-parallel over its ``model``
        group (the vision tower stays whole on every rank)."""
        if text_config.scan_layers:
            raise ValueError("Qwen3VL needs an unrolled text decoder (scan_layers=False)")
        self.vision_config = vision_config
        self.text_config = text_config
        self.image_token_id = image_token_id
        self.mrope_section = mrope_section
        self.device = resolve_device(device)
        self.mesh = mesh
        with torch.device("meta"):
            vision = Qwen3VLVisionTower(vision_config)
            text = Qwen3Model(text_config, mesh)
        text_state = _split(state_dict, "text.")
        if mesh is not None:
            from gvl_tpu_torch.parallel.sharding import shard_state

            text_state = shard_state(text_state, mesh, text_config)
        vision.load_state_dict(_split(state_dict, "vision."), assign=True)
        text.load_state_dict(text_state, assign=True)
        self.vision = vision.to(self.device).eval()
        self.text = text.to(self.device).eval()
        self.last_decode_steps = 0

    @torch.inference_mode()
    def encode_vision(self, patches, grid_thw) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """(merged embeddings, DeepStack features) of pre-patchified pixels."""
        patches = torch.as_tensor(np.asarray(patches, np.float32), device=self.device)
        return self.vision(patches, tuple(int(x) for x in grid_thw))

    def _embeds(self, ids: torch.Tensor, patches, grid_thw):
        """Token embeddings with the visual rows spliced in at the image
        tokens (each row's image span holds the whole image), and the
        DeepStack features as dense ``[L_ds, B, S, D]`` (zero elsewhere)."""
        embeds = self.text.embed_only(ids)
        if patches is None:
            return embeds, None
        visual, deepstack = self.encode_vision(patches, grid_thw)
        batch, seq = ids.shape
        flat_mask = (ids == self.image_token_id).reshape(-1, 1)
        take = (torch.cumsum(flat_mask[:, 0].long(), 0) - 1).clamp(0, visual.shape[0] - 1)
        flat = embeds.reshape(batch * seq, -1)
        embeds = torch.where(flat_mask, visual[take].to(flat.dtype), flat)
        dense = torch.stack([torch.where(flat_mask, ds[take].to(flat.dtype),
                                         torch.zeros_like(flat))
                             for ds in deepstack])
        return embeds.reshape(batch, seq, -1), dense.reshape(len(deepstack), batch, seq, -1)

    def _mrope(self, position_ids: np.ndarray):
        return mrope_cos_sin(torch.as_tensor(position_ids, device=self.device),
                             self.text_config.head_dim, self.text_config.rope_theta,
                             self.mrope_section)

    @torch.inference_mode()
    def forward(
        self,
        input_ids: np.ndarray,          # [B, S] with image tokens inline
        patches: Optional[np.ndarray] = None,
        grid_thw: Optional[tuple[int, int, int]] = None,
        position_ids: Optional[np.ndarray] = None,  # [3, B, S] override
    ) -> torch.Tensor:
        """Teacher-forced logits [B, S, vocab] with the visual splice."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64), device=self.device)
        embeds, deepstack = self._embeds(ids, patches, grid_thw)
        if position_ids is None:
            position_ids = vl_position_ids(
                np.asarray(input_ids), grid_thw or (1, 2, 2), self.image_token_id,
                self.vision_config.spatial_merge_size)
        logits, _ = self.text(inputs_embeds=embeds, rope_cos_sin=self._mrope(position_ids),
                              deepstack_embeds=deepstack)
        return logits

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,            # [1, S]
        patches: Optional[np.ndarray] = None,
        grid_thw: Optional[tuple[int, int, int]] = None,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_p: float = 0.8,
        top_k: int = 20,
        eos_token_id: int = 151645,
        generator: Optional[torch.Generator] = None,
        cache_dtype: torch.dtype = torch.bfloat16,
    ) -> list[int]:
        """Greedy or sampled generation after a visual prefill.

        The prefill writes the prompt's K and V into a ``cache_dtype`` cache
        with the full mRoPE tables; decode step ``i`` continues with 1-D
        rotary angles at ``max(position_ids) + 1 + i`` (where the T/H/W
        triples coincide) while the cache offset advances one row a step.
        On CUDA the cache must be bf16 when the decoder runs its decode
        kernel (``ValueError`` otherwise: no cast is made).  The tokens are
        JAX's for the same weights and an f32 cache; no step runs after the
        last token is produced (``last_decode_steps`` counts the steps).
        Without ``generator`` a sampled stream draws from a new one seeded 0.
        """
        generator = call_generator(generator, self.device)
        ids = np.asarray(input_ids, np.int64)
        if ids.shape[0] != 1:
            raise ValueError("Qwen3VL.generate takes one sequence (batch 1)")
        cfg = self.text_config
        if (self.device.type == "cuda" and cfg.use_decode_kernel
                and cache_dtype != torch.bfloat16):
            raise ValueError(f"Qwen3VL.generate: the decode kernel reads bf16 caches, "
                             f"got cache_dtype={cache_dtype}")
        grid = grid_thw or (1, 2, 2)
        position_ids = vl_position_ids(ids, grid, self.image_token_id,
                                       self.vision_config.spatial_merge_size)
        next_pos = int(position_ids.max()) + 1
        if ids.shape[1] + max_new_tokens > cfg.max_cache_length:
            raise ValueError(f"prompt of {ids.shape[1]} tokens + {max_new_tokens} new "
                             f"exceeds max_cache_length={cfg.max_cache_length}")

        dev = self.device
        tokens = torch.as_tensor(ids, device=dev)
        embeds, deepstack = self._embeds(tokens, patches, grid)
        cache = KVCache.zeros(cfg, 1, dtype=cache_dtype, device=dev, mesh=self.mesh)
        logits, cache = self.text(inputs_embeds=embeds, rope_cos_sin=self._mrope(position_ids),
                                  deepstack_embeds=deepstack, cache=cache)
        token = sample_logits(logits[:, -1], generator, temperature, top_p, top_k)
        out: list[int] = []
        self.last_decode_steps = 0
        for i in range(max_new_tokens):
            tok = int(token[0])
            if tok == eos_token_id:
                break
            out.append(tok)
            if i == max_new_tokens - 1:
                break
            positions = torch.full((1,), next_pos + i, dtype=torch.long, device=dev)
            logits, cache = self.text(token[:, None].long(), positions=positions, cache=cache)
            token = sample_logits(logits[:, -1], generator, temperature, top_p, top_k)
            self.last_decode_steps += 1
        return out


def init_vl_params(vision_config: Qwen3VLVisionConfig, text_config: Qwen3Config,
                   generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Seeded random weights for :class:`Qwen3VL` on ``device``: the decoder
    as :func:`~gvl_tpu_torch.models.qwen3.init_params` draws it, the tower
    with the JAX package's initialisers (:func:`~gvl_tpu_torch.nn.layers.
    init_state`), both in ``dtype``; the tower first, from one generator."""
    with torch.device("meta"):
        tower = Qwen3VLVisionTower(vision_config)
    state = {f"vision.{k}": v.to(dtype)
             for k, v in init_state(tower, generator, device).items()}
    state.update({f"text.{k}": v for k, v in
                  init_params(text_config, generator, dtype, device).items()})
    return state


# --------------------------------------------------------------- converter

def convert_hf_qwen3vl_vision(state_dict: dict[str, torch.Tensor],
                              config: Qwen3VLVisionConfig) -> dict[str, torch.Tensor]:
    """HF ``Qwen3VLVisionModel`` weights as the port's tower state dict."""
    sd = {k: v.detach() for k, v in state_dict.items()}
    conv = sd["patch_embed.proj.weight"]  # [D, C, tp, ps, ps]
    out = {"patch_proj.weight": conv.reshape(conv.shape[0], -1),
           "patch_proj.bias": sd["patch_embed.proj.bias"],
           "pos_embed": sd["pos_embed.weight"]}

    def copy(ours: str, theirs: str) -> None:
        for part in ("weight", "bias"):
            out[f"{ours}.{part}"] = sd[f"{theirs}.{part}"]

    for i in range(config.depth):
        for ours, theirs in (("norm1", "norm1"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("norm2", "norm2"), ("fc1", "mlp.linear_fc1"),
                             ("fc2", "mlp.linear_fc2")):
            copy(f"blocks.{i}.{ours}", f"blocks.{i}.{theirs}")

    def merger(ours: str, theirs: str) -> None:
        for a, b in (("norm", "norm"), ("fc1", "linear_fc1"), ("fc2", "linear_fc2")):
            copy(f"{ours}.{a}", f"{theirs}.{b}")

    merger("merger", "merger")
    for j in range(len(config.deepstack_visual_indexes)):
        merger(f"deepstack.{j}", f"deepstack_merger_list.{j}")
    return out


def convert_hf_qwen3vl(model) -> tuple[Qwen3VLVisionConfig, Qwen3Config, dict]:
    """A HF ``Qwen3VLForConditionalGeneration`` split into (vision config,
    text config, the port's state dict with ``vision.`` and ``text.``
    prefixes)."""
    hf_vision = model.config.vision_config
    vision_config = Qwen3VLVisionConfig(
        hidden_size=hf_vision.hidden_size,
        depth=hf_vision.depth,
        num_heads=hf_vision.num_heads,
        patch_size=hf_vision.patch_size,
        temporal_patch_size=hf_vision.temporal_patch_size,
        spatial_merge_size=hf_vision.spatial_merge_size,
        intermediate_size=hf_vision.intermediate_size,
        out_hidden_size=hf_vision.out_hidden_size,
        num_position_embeddings=hf_vision.num_position_embeddings,
        deepstack_visual_indexes=tuple(hf_vision.deepstack_visual_indexes),
    )
    text_config = hf_text_config(model.config.text_config)
    sd = model.state_dict()
    vision_sd = {k.removeprefix("model.visual."): v
                 for k, v in sd.items() if k.startswith("model.visual.")}
    text_sd = {k.replace("model.language_model.", "model."): v
               for k, v in sd.items() if k.startswith("model.language_model.")}
    if "lm_head.weight" in sd:
        text_sd["lm_head.weight"] = sd["lm_head.weight"]
    state = {f"vision.{k}": v for k, v in
             convert_hf_qwen3vl_vision(vision_sd, vision_config).items()}
    state.update({f"text.{k}": v for k, v in convert_hf_qwen3(text_sd, text_config).items()})
    return vision_config, text_config, state
