"""Hierarchical token compression (HiCo) for long videos (counterpart of
:mod:`gvl_tpu.temporal.hico`).

Two cross-attention pools with learned queries (FRAME tokens → CLIP tokens,
CLIP tokens → VIDEO tokens) and a rolling compressed-token cache.  Every
clip of a video compresses in one batched call; the pools run on
``device``, their attention (8 heads of 176 at the default 1408 width)
through the flash kernel, which pads the head to 192.

As in the JAX package, :class:`TemporalCompressionModule` reads
``outputs/hico_params.npz`` when that resolves (against the working
directory first, then the repository) and holds the compressor's geometry,
and otherwise logs a warning and runs on a random initialisation
(ROADMAP C8).  ``strict=True`` (the arms' rung,
:func:`gvl_tpu_torch.pipeline.run_hico`) raises instead where a file
resolves but cannot be used; without a file it keeps the random
initialisation.  The port's random draw is its own (a ``torch.Generator``
seeded with 0); only loaded weights give JAX's results.  The trained file
holds the FRAME → CLIP pool only, so the VIDEO level raises on it, as it
fails in JAX.
"""

from __future__ import annotations

import hashlib
import logging
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import LayerNorm, attend

logger = logging.getLogger(__name__)

POOLS = ("frame_to_clip", "clip_to_video")


class CompressionLevel(Enum):
    FRAME = "frame"
    CLIP = "clip"
    VIDEO = "video"


@dataclass
class TemporalToken:
    """One compressed temporal token with its time span."""

    embedding: np.ndarray
    start_time: float
    end_time: float
    compression_level: CompressionLevel
    source_frame_count: int
    metadata: dict = field(default_factory=dict)

    def __repr__(self) -> str:
        return (
            f"TemporalToken(level={self.compression_level.value}, "
            f"time=[{self.start_time:.2f}s-{self.end_time:.2f}s], "
            f"frames={self.source_frame_count})"
        )


@dataclass
class HiCoConfig:
    model_name: str = "gvl/hico-tpu"
    hidden_dim: int = 1408
    clip_duration_sec: float = 4.0
    frames_per_clip: int = 16
    clip_overlap_sec: float = 0.5
    frame_to_clip_ratio: int = 4
    clip_to_video_ratio: int = 8
    max_context_tokens: int = 256
    cache_compressed_tokens: bool = True
    max_cached_clips: int = 100
    num_heads: int = 8
    max_positions: int = 1024


class _CrossAttnPool(nn.Module):
    """Learned queries cross-attend the token set; LN(residual + attn)."""

    use_flash_kernel = True

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.q_proj, self.k_proj = nn.Linear(hidden_dim, hidden_dim), nn.Linear(hidden_dim, hidden_dim)
        self.v_proj, self.o_proj = nn.Linear(hidden_dim, hidden_dim), nn.Linear(hidden_dim, hidden_dim)
        self.norm = LayerNorm(hidden_dim, 1e-6)

    def forward(self, tokens: torch.Tensor, num_queries: int) -> torch.Tensor:
        batch, _, d = tokens.shape
        query = self.query.expand(batch, num_queries, d).to(tokens.dtype)

        def split(t):
            return t.view(t.shape[0], t.shape[1], self.num_heads, -1).transpose(1, 2).contiguous()

        attn = attend(self, split(self.q_proj(query)), split(self.k_proj(tokens)),
                      split(self.v_proj(tokens)))
        out = self.o_proj(attn.transpose(1, 2).reshape(batch, num_queries, d))
        return self.norm(out + query)


class HierarchicalCompressor(nn.Module):
    """Frame→clip and clip→video compression with temporal positions;
    ``pools`` names the pools it holds (a checkpoint may hold one)."""

    def __init__(self, config: HiCoConfig, pools: tuple[str, ...] = POOLS):
        super().__init__()
        self.config = config
        self.temporal_pe = nn.Parameter(torch.zeros(config.max_positions, config.hidden_dim))
        for name in pools:
            setattr(self, name, _CrossAttnPool(config.hidden_dim, config.num_heads))

    def _pool(self, name: str) -> _CrossAttnPool:
        if not hasattr(self, name):
            raise KeyError(f"HiCo compressor holds no {name!r} parameters")
        return getattr(self, name)

    def compress_frames_to_clip(self, frame_tokens: torch.Tensor,
                                num_output_tokens: int = 1) -> torch.Tensor:
        """[B, T, D] frame tokens → [B, num_output_tokens, D]."""
        seq = frame_tokens.shape[1]
        tokens = frame_tokens + self.temporal_pe[None, :seq].to(frame_tokens.dtype)
        return self._pool("frame_to_clip")(tokens, num_output_tokens)

    def compress_clips_to_video(self, clip_tokens: torch.Tensor,
                                num_output_tokens: int = 1) -> torch.Tensor:
        """[B, n_clips, D] → [B, num_output_tokens, D]."""
        return self._pool("clip_to_video")(clip_tokens, num_output_tokens)

    def forward(self, frame_tokens: torch.Tensor) -> torch.Tensor:
        return self.compress_clips_to_video(self.compress_frames_to_clip(frame_tokens))


def init_hico_state(config: HiCoConfig, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random f32 weights with the JAX module's initialisers, drawn from
    ``generator``: ``N(0, 0.02²)`` positions, ``N(0, 1)`` queries,
    ``N(0, 1/fan_in)`` matrices, zero biases, unit norms."""
    device = resolve_device(device)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in HierarchicalCompressor(config).state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        w = torch.empty(shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if name == "temporal_pe":
            w.normal_(0.0, 0.02, generator=generator)
        elif leaf == "query":
            w.normal_(0.0, 1.0, generator=generator)
        elif leaf == "bias":
            w.zero_()
        elif name.endswith("norm.weight"):
            w.fill_(1.0)
        else:
            w.normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=generator)
        state[name] = w
    return state


class HashFrameEncoder:
    """Deterministic fake frame encoder (hash-seeded [T, D] features)."""

    def __init__(self, dim: int):
        self.dim = dim

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        out = np.zeros((len(frames), self.dim), np.float32)
        for i, frame in enumerate(frames):
            digest = hashlib.blake2b(np.ascontiguousarray(frame).tobytes(),
                                     digest_size=8).digest()
            rng = np.random.default_rng(int.from_bytes(digest, "little"))
            out[i] = rng.standard_normal(self.dim).astype(np.float32)
        return out / np.linalg.norm(out, axis=-1, keepdims=True)


class TemporalCompressionModule:
    """Segment → encode → compress with a rolling token cache.

    >>> mod = TemporalCompressionModule(device="cpu")
    >>> tokens = mod.segment_and_compress(frames, fps=2.0)
    >>> context = mod.get_rolling_context(current_time=120.0)
    """

    def __init__(self, config: Optional[HiCoConfig] = None,
                 frame_encoder: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 checkpoint: Optional[str] = "outputs/hico_params.npz",
                 device: str | torch.device = "cuda", strict: bool = False):
        from gvl_tpu_torch.models.convert import hico_params_from_jax
        from gvl_tpu_torch.nn.layers import load_module

        self.device = resolve_device(device)
        self.config = config or HiCoConfig()
        self.frame_encoder = frame_encoder or HashFrameEncoder(self.config.hidden_dim)
        state = None
        if checkpoint:   # trained queries when the artifact exists
            resolved = _resolve_checkpoint(checkpoint)
            if resolved:
                try:
                    loaded = load_hico_npz(resolved)
                    pe = loaded["params"]["temporal_pe"]
                    want = (self.config.max_positions, self.config.hidden_dim)
                    if tuple(pe.shape) != want:
                        raise ValueError(f"geometry mismatch: checkpoint temporal_pe "
                                         f"{tuple(pe.shape)} != config {want}")
                    state = hico_params_from_jax(loaded)
                    with torch.device("meta"):
                        shapes = {k: tuple(v.shape) for k, v in HierarchicalCompressor(
                            self.config).state_dict().items()}
                    wrong = {k: tuple(v.shape) for k, v in state.items()
                             if shapes.get(k, tuple(v.shape)) != tuple(v.shape)}
                    if wrong or not set(state) <= set(shapes):
                        raise ValueError(f"tensors not of the module's shapes: {wrong or sorted(set(state) - set(shapes))}")
                    logger.info("loaded HiCo compressor from %s", resolved)
                except Exception as exc:
                    if strict:
                        raise ValueError(
                            f"HiCo checkpoint {resolved} cannot be used ({exc}); the JAX "
                            "package would compress with a random initialisation here "
                            "(ROADMAP C8)") from exc
                    state = None
                    logger.warning("HiCo checkpoint %s unusable (%s); random init",
                                   resolved, exc)
        if state is None:   # ROADMAP C8: a silent random initialisation, as in JAX
            state = init_hico_state(self.config, generator or torch.Generator(
                self.device).manual_seed(0), self.device)
        pools = tuple(p for p in POOLS if f"{p}.query" in state)
        with torch.device("meta"):
            compressor = HierarchicalCompressor(self.config, pools)
        self.compressor = load_module(compressor, state, self.device)
        self._token_cache: list[TemporalToken] = []

    # --------------------------------------------------------- segmentation

    def segment_video(self, frames: np.ndarray, fps: float
                      ) -> list[tuple[np.ndarray, float, float]]:
        """Overlapping clips of ``clip_duration_sec`` (tiny tails dropped)."""
        cfg = self.config
        total = len(frames)
        clip_n = max(1, int(cfg.clip_duration_sec * fps))
        stride = max(1, clip_n - int(cfg.clip_overlap_sec * fps))
        clips = []
        start = 0
        while start < total:
            end = min(start + clip_n, total)
            clips.append((frames[start:end], start / fps, end / fps))
            start += stride
            if total - start < clip_n // 2:
                break
        return clips

    def _sample_clip_frames(self, clip: np.ndarray) -> np.ndarray:
        """Uniformly sample/pad to frames_per_clip."""
        target = self.config.frames_per_clip
        if len(clip) >= target:
            idx = np.linspace(0, len(clip) - 1, target).astype(int)
            return clip[idx]
        pad = np.repeat(clip[-1:], target - len(clip), axis=0)
        return np.concatenate([clip, pad], axis=0)

    # ---------------------------------------------------------- compression

    @torch.inference_mode()
    def segment_and_compress(self, frames: np.ndarray, fps: float,
                             target_level: CompressionLevel = CompressionLevel.CLIP
                             ) -> list[TemporalToken]:
        """The long-video entry point: every clip is encoded, then all are
        compressed in one batched call ([n_clips, frames_per_clip, D] →
        [n_clips, 1, D]), the clip batch padded to a power of two."""
        clips = self.segment_video(frames, fps)
        if not clips:
            return []
        features = np.stack([self.frame_encoder(self._sample_clip_frames(clip))
                             for clip, _, _ in clips])  # [n_clips, T, D]

        tokens: list[TemporalToken] = []
        if target_level is CompressionLevel.FRAME:
            for feats, (clip, t0, t1) in zip(features, clips):
                span = (t1 - t0) / len(feats)
                for i, emb in enumerate(feats):
                    tokens.append(TemporalToken(
                        embedding=np.asarray(emb), start_time=t0 + i * span,
                        end_time=t0 + (i + 1) * span,
                        compression_level=CompressionLevel.FRAME, source_frame_count=1))
            return tokens

        n_clips = features.shape[0]
        bucket = 1 << (n_clips - 1).bit_length()
        if bucket != n_clips:
            features = np.concatenate(
                [features, np.zeros((bucket - n_clips, *features.shape[1:]), features.dtype)],
                axis=0)
        x = torch.from_numpy(features).to(self.device)
        clip_embs = self.compressor.compress_frames_to_clip(x)[:n_clips, 0]  # [n_clips, D]

        if target_level is CompressionLevel.CLIP:
            for emb, (clip, t0, t1) in zip(clip_embs.cpu().numpy(), clips):
                tokens.append(TemporalToken(
                    embedding=emb, start_time=t0, end_time=t1,
                    compression_level=CompressionLevel.CLIP, source_frame_count=len(clip)))
        else:  # VIDEO
            num_out = max(1, len(clips) // self.config.clip_to_video_ratio)
            video = self.compressor.compress_clips_to_video(clip_embs[None], num_out)
            video = video.cpu().numpy()
            t0, t1 = clips[0][1], clips[-1][2]
            n_frames = sum(len(c) for c, _, _ in clips)
            for i in range(num_out):
                tokens.append(TemporalToken(
                    embedding=video[0, i], start_time=t0, end_time=t1,
                    compression_level=CompressionLevel.VIDEO, source_frame_count=n_frames))

        if self.config.cache_compressed_tokens:
            self._token_cache.extend(tokens)
            del self._token_cache[: -self.config.max_cached_clips]
        return tokens

    # ---------------------------------------------------------- rolling ctx

    def get_rolling_context(self, current_time: float,
                            window_sec: Optional[float] = None) -> list[TemporalToken]:
        """Cached tokens inside the window, newest-capped at max tokens."""
        window = window_sec if window_sec is not None else 300.0
        cutoff = current_time - window
        selected = [t for t in self._token_cache if t.end_time >= cutoff]
        return selected[-self.config.max_context_tokens:]

    def clear_cache(self) -> None:
        self._token_cache.clear()


def create_hico_module(clip_duration: float = 4.0, frames_per_clip: int = 16,
                       frame_encoder: Optional[Callable] = None,
                       device: str | torch.device = "cuda") -> TemporalCompressionModule:
    return TemporalCompressionModule(
        HiCoConfig(clip_duration_sec=clip_duration, frames_per_clip=frames_per_clip),
        frame_encoder=frame_encoder, device=device)


# --------------------------------------------------------------------------
# Checkpoint IO (flat-npz layout, as the other artifacts)
# --------------------------------------------------------------------------

def _resolve_checkpoint(path) -> Optional[str]:
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    return resolve_repo_path(path)


def save_hico_npz(variables: dict, path) -> None:
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    save_flat_npz(variables, path)


def load_hico_npz(path) -> dict:
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    return load_flat_npz(path)
