"""Whisper-class encoder-decoder ASR model (counterpart of
:mod:`gvl_tpu.models.whisper`: the model, its greedy decoders and the HF
``WhisperModel`` converter).

Encoder: two 1-D convolutions (stride 1, then 2; padding 1 each side),
exact (erf) GELU, fixed sinusoidal positions, pre-norm layers.  Decoder:
learned positions, causal self-attention, cross-attention over the
encoder states, an output head tied to the token embeddings.  The
encoder's self-attention, the teacher-forced decoder's attention and the
cached decode's cross-attention (one query row per step) go through the
flash kernel; the cached decode's self-attention over its cache is plain
PyTorch, as it is XLA (not the Pallas kernel) in the JAX model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.nn.layers import LayerNorm, attend


@dataclass(frozen=True)
class WhisperConfig:
    """Defaults: openai/whisper-base."""

    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    layer_norm_eps: float = 1e-5
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    eos_token_id: int = 50257

    @classmethod
    def base(cls) -> "WhisperConfig":
        return cls()

    @classmethod
    def tiny_random(cls) -> "WhisperConfig":
        return cls(d_model=32, encoder_layers=1, decoder_layers=1,
                   num_heads=2, ffn_dim=64, num_mel_bins=16,
                   max_source_positions=100, max_target_positions=60,
                   vocab_size=51000)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position embedding (f32)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class WhisperAttention(nn.Module):
    """Whisper attention: q/v/o projections with bias, k without."""

    use_flash_kernel = True

    def __init__(self, d_model: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.o_proj = nn.Linear(d_model, d_model)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        batch, seq = t.shape[:2]
        return t.view(batch, seq, self.num_heads, -1).transpose(1, 2).contiguous()

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        batch, _, seq, _ = out.shape
        return self.o_proj(out.transpose(1, 2).reshape(batch, seq, -1))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        source = x if kv is None else kv
        return self._merge(attend(self, self._split(self.q_proj(x)),
                                  self._split(self.k_proj(source)),
                                  self._split(self.v_proj(source)),
                                  causal=self.causal, kv_len=kv_len))

    def project_kv(self, source: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Split K/V of ``source``, computed once (the cross-attention cache)."""
        return self._split(self.k_proj(source)), self._split(self.v_proj(source))

    def attend_precomputed(self, x: torch.Tensor, k4: torch.Tensor,
                           v4: torch.Tensor) -> torch.Tensor:
        return self._merge(attend(self, self._split(self.q_proj(x)), k4, v4))

    def decode_step(self, x1: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                    pos: int) -> torch.Tensor:
        """One token's causal self-attention against ``[B, H, T, dh]`` caches,
        which get the token's K and V at ``pos`` (written in place)."""
        q = self._split(self.q_proj(x1))
        cache_k[:, :, pos] = self._split(self.k_proj(x1))[:, :, 0].to(cache_k.dtype)
        cache_v[:, :, pos] = self._split(self.v_proj(x1))[:, :, 0].to(cache_v.dtype)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), cache_k.float()) \
            / float(np.sqrt(q.shape[-1]))
        live = torch.arange(cache_k.shape[2], device=x1.device) <= pos
        scores = scores.masked_fill(~live, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
        return self._merge(torch.einsum("bhqk,bhkd->bhqd", probs, cache_v))


class _FeedForward(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.ff_norm = LayerNorm(config.d_model, config.layer_norm_eps)
        self.fc1 = nn.Linear(config.d_model, config.ffn_dim)
        self.fc2 = nn.Linear(config.ffn_dim, config.d_model)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.gelu(self.fc1(self.ff_norm(x))))


class EncoderLayer(_FeedForward):
    def __init__(self, config: WhisperConfig):
        super().__init__(config)
        self.attn_norm = LayerNorm(config.d_model, config.layer_norm_eps)
        self.self_attn = WhisperAttention(config.d_model, config.num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feed_forward(x + self.self_attn(self.attn_norm(x)))


class WhisperEncoder(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        d = config.d_model
        self.conv1 = nn.Conv1d(config.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.positions = sinusoids(config.max_source_positions, d)   # numpy: no weight
        self.layers = nn.ModuleList(EncoderLayer(config)
                                    for _ in range(config.encoder_layers))
        self.final_norm = LayerNorm(d, config.layer_norm_eps)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, T, n_mels]`` → states ``[B, T/2, d]``."""
        x = F.gelu(self.conv1(mel.transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        pos = torch.from_numpy(self.positions[: x.shape[1]]).to(x.device, x.dtype)
        x = x + pos[None]
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class DecoderLayer(_FeedForward):
    def __init__(self, config: WhisperConfig):
        super().__init__(config)
        eps = config.layer_norm_eps
        self.self_norm = LayerNorm(config.d_model, eps)
        self.self_attn = WhisperAttention(config.d_model, config.num_heads, causal=True)
        self.cross_norm = LayerNorm(config.d_model, eps)
        self.cross_attn = WhisperAttention(config.d_model, config.num_heads)

    def forward(self, x: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_norm(x))
        x = x + self.cross_attn(self.cross_norm(x), encoder_states)
        return self.feed_forward(x)

    def decode_step(self, x1, cross_k, cross_v, cache_k, cache_v, pos: int) -> torch.Tensor:
        x1 = x1 + self.self_attn.decode_step(self.self_norm(x1), cache_k, cache_v, pos)
        x1 = x1 + self.cross_attn.attend_precomputed(self.cross_norm(x1), cross_k, cross_v)
        return self.feed_forward(x1)


class WhisperDecoder(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.embed_tokens = nn.Parameter(torch.zeros(config.vocab_size, config.d_model))
        self.embed_positions = nn.Parameter(
            torch.zeros(config.max_target_positions, config.d_model))
        self.layers = nn.ModuleList(DecoderLayer(config)
                                    for _ in range(config.decoder_layers))
        self.final_norm = LayerNorm(config.d_model, config.layer_norm_eps)

    def forward(self, tokens: torch.Tensor, encoder_states: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
        """Teacher-forced logits ``[B, S, vocab]`` (head tied to the embeddings)."""
        x = self.embed_tokens[tokens.long()]
        x = x + self.embed_positions[position_offset: position_offset + tokens.shape[1]][None]
        for layer in self.layers:
            x = layer(x, encoder_states)
        return self.final_norm(x) @ self.embed_tokens.T

    def precompute_cross(self, encoder_states: torch.Tensor) -> list:
        """Per-layer cross-attention K/V, computed once per utterance."""
        return [layer.cross_attn.project_kv(encoder_states) for layer in self.layers]

    def decode_step(self, token: torch.Tensor, cross_kv: list, self_caches: list,
                    pos: int) -> torch.Tensor:
        """One token ``[B]`` through every layer with cached self and cross
        attention (``self_caches``: per layer ``(k, v)``, ``[B, H, T, dh]``,
        written in place); logits ``[B, vocab]``."""
        x = self.embed_tokens[token.long()][:, None] + self.embed_positions[pos][None, None]
        for layer, (ck, cv), (sk, sv) in zip(self.layers, cross_kv, self_caches):
            x = layer.decode_step(x, ck, cv, sk, sv, pos)
        return (self.final_norm(x) @ self.embed_tokens.T)[:, 0]


class WhisperModel(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.config = config
        self.encoder = WhisperEncoder(config)
        self.decoder = WhisperDecoder(config)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def decode(self, tokens: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, encoder_states)

    def precompute_cross(self, encoder_states: torch.Tensor) -> list:
        return self.decoder.precompute_cross(encoder_states)

    def decode_step(self, token: torch.Tensor, cross_kv: list, self_caches: list,
                    pos: int) -> torch.Tensor:
        return self.decoder.decode_step(token, cross_kv, self_caches, pos)


def load_whisper(config: WhisperConfig, params: dict,
                 device: str | torch.device = "cuda") -> WhisperModel:
    """The JAX package's parameter tree (or the port's state dict) as a
    :class:`WhisperModel` on ``device``."""
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.models.convert import whisper_params_from_jax
    from gvl_tpu_torch.nn.layers import load_module

    device = resolve_device(device)
    with torch.device("meta"):
        model = WhisperModel(config)
    state = params if "decoder.embed_tokens" in params else \
        whisper_params_from_jax(params, config)
    return load_module(model, state, device)


@torch.inference_mode()
def greedy_decode(model: WhisperModel, mel: torch.Tensor, prompt_tokens: torch.Tensor,
                  max_new_tokens: int = 128) -> torch.Tensor:
    """Greedy decoding by full recompute: each step runs the teacher-forced
    decoder over a ``[B, prompt + max_new]`` buffer filled with EOS and
    takes the next token from the last real position; finished rows keep
    emitting EOS (``gvl_tpu.models.whisper.greedy_decode``)."""
    cfg = model.config
    batch, prompt_len = prompt_tokens.shape
    total = prompt_len + max_new_tokens
    tokens = torch.full((batch, total), cfg.eos_token_id, dtype=torch.int64, device=mel.device)
    tokens[:, :prompt_len] = prompt_tokens
    states = model.encoder(mel)
    done = torch.zeros(batch, dtype=torch.bool, device=mel.device)
    for i in range(prompt_len, total):
        logits = model.decoder(tokens, states)
        nxt = torch.where(done, cfg.eos_token_id, logits[:, i - 1].argmax(-1))
        tokens[:, i] = nxt
        done |= nxt == cfg.eos_token_id
        if bool(done.all()):
            break
    return tokens


@torch.inference_mode()
def greedy_decode_cached(model: WhisperModel, mel: torch.Tensor,
                         prompt_tokens: torch.Tensor,
                         max_new_tokens: int = 128) -> torch.Tensor:
    """Incremental greedy decoding: cross K/V computed once, per-layer
    self-attention caches, one token per step
    (``gvl_tpu.models.whisper.greedy_decode_cached``); the same tokens as
    :func:`greedy_decode` in exact arithmetic."""
    cfg = model.config
    batch, prompt_len = prompt_tokens.shape
    total = prompt_len + max_new_tokens
    d_head = cfg.d_model // cfg.num_heads
    states = model.encoder(mel)
    cross_kv = model.decoder.precompute_cross(states)
    caches = [tuple(torch.zeros(batch, cfg.num_heads, total, d_head, dtype=states.dtype,
                                device=mel.device) for _ in range(2))
              for _ in range(cfg.decoder_layers)]
    out = torch.full((batch, total), cfg.eos_token_id, dtype=torch.int64, device=mel.device)
    out[:, :prompt_len] = prompt_tokens
    done = torch.zeros(batch, dtype=torch.bool, device=mel.device)
    for i in range(total - 1):       # the prompt through the caches, then generate
        logits = model.decoder.decode_step(out[:, i], cross_kv, caches, i)
        if i + 1 < prompt_len:
            continue
        nxt = torch.where(done, cfg.eos_token_id, logits.argmax(-1))
        out[:, i + 1] = nxt
        done |= nxt == cfg.eos_token_id
        if bool(done.all()):
            break
    return out


# --------------------------------------------------------------------------
# HF conversion
# --------------------------------------------------------------------------

_ATTN = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj", "o_proj": "out_proj"}


def convert_hf_whisper(state_dict: dict, config: WhisperConfig) -> dict[str, torch.Tensor]:
    """A HF ``WhisperModel`` state dict (or ``WhisperForConditionalGeneration``'s,
    prefixed ``model.``) as the port's :class:`WhisperModel` state dict
    (JAX's ``convert_hf_whisper``); torch's layouts are kept as they are."""
    sd = {k.removeprefix("model."): torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}

    def copy(ours: str, theirs: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            out[f"{ours}.{leaf}"] = sd[f"{theirs}.{leaf}"]

    def attention(ours: str, theirs: str) -> None:
        for a, b in _ATTN.items():
            copy(f"{ours}.{a}", f"{theirs}.{b}", ("weight",) if a == "k_proj" else
                 ("weight", "bias"))

    copy("encoder.conv1", "encoder.conv1")
    copy("encoder.conv2", "encoder.conv2")
    copy("encoder.final_norm", "encoder.layer_norm")
    for i in range(config.encoder_layers):
        ours, theirs = f"encoder.layers.{i}", f"encoder.layers.{i}"
        copy(f"{ours}.attn_norm", f"{theirs}.self_attn_layer_norm")
        attention(f"{ours}.self_attn", f"{theirs}.self_attn")
        for name, hf_name in (("ff_norm", "final_layer_norm"), ("fc1", "fc1"), ("fc2", "fc2")):
            copy(f"{ours}.{name}", f"{theirs}.{hf_name}")
    out["decoder.embed_tokens"] = sd["decoder.embed_tokens.weight"]
    out["decoder.embed_positions"] = sd["decoder.embed_positions.weight"]
    copy("decoder.final_norm", "decoder.layer_norm")
    for i in range(config.decoder_layers):
        ours, theirs = f"decoder.layers.{i}", f"decoder.layers.{i}"
        copy(f"{ours}.self_norm", f"{theirs}.self_attn_layer_norm")
        attention(f"{ours}.self_attn", f"{theirs}.self_attn")
        copy(f"{ours}.cross_norm", f"{theirs}.encoder_attn_layer_norm")
        attention(f"{ours}.cross_attn", f"{theirs}.encoder_attn")
        for name, hf_name in (("ff_norm", "final_layer_norm"), ("fc1", "fc1"), ("fc2", "fc2")):
            copy(f"{ours}.{name}", f"{theirs}.{hf_name}")
    return out


def hf_whisper_config(hf) -> WhisperConfig:
    """The port's config for a HF ``WhisperConfig``."""
    return WhisperConfig(
        d_model=hf.d_model, encoder_layers=hf.encoder_layers,
        decoder_layers=hf.decoder_layers, num_heads=hf.encoder_attention_heads,
        ffn_dim=hf.encoder_ffn_dim, num_mel_bins=hf.num_mel_bins,
        max_source_positions=hf.max_source_positions,
        max_target_positions=hf.max_target_positions, vocab_size=hf.vocab_size,
        decoder_start_token_id=hf.decoder_start_token_id, eos_token_id=hf.eos_token_id)


def load_hf_whisper(model_name_or_path, config: Optional[WhisperConfig] = None
                    ) -> tuple[WhisperConfig, dict[str, torch.Tensor]]:
    """A HF ``WhisperModel`` checkpoint (a local directory) as
    ``(config, state_dict)`` on the CPU; ``transformers`` is imported here
    only."""
    from transformers import WhisperModel as HFWhisper

    model = HFWhisper.from_pretrained(model_name_or_path)
    config = config or hf_whisper_config(model.config)
    return config, convert_hf_whisper(model.state_dict(), config)
