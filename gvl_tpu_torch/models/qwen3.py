"""Qwen3-class decoder and its serving engine, in PyTorch.

Counterpart of :mod:`gvl_tpu.models.qwen3` for the unrolled, full-precision
model: GQA attention with per-head q/k RMSNorm and RoPE, SwiGLU MLP, a
per-layer KV cache, and :class:`Qwen3Engine` (bucketed prefill, then one
token per step).  Attention goes through the port's kernels on CUDA
tensors (``ops.attention.flash_attention`` for prefill,
``ops.decode_attention.decode_attention`` for each decode step,
``ops.cache_update.cache_append`` for the cache write when head_dim is a
multiple of 128) and through their plain versions on CPU tensors.
The config's ``use_*_kernel`` flags send a CUDA model down the plain
versions instead, which is how the kernel path is checked on the card.

Not ported yet: ``scan_layers``, int8 weights, LoRA, chunked speculative
verification, DeepStack/mrope inputs and tensor-parallel meshes; a config
that asks for one of them raises.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import RMSNorm
from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
from gvl_tpu_torch.ops.cache_update import cache_append
from gvl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from gvl_tpu_torch.ops.rope import rope_angles, rotate_half


@dataclass(frozen=True)
class Qwen3Config:
    """Defaults sized for Qwen3-VL-8B's text decoder; the fields are those
    of ``gvl_tpu.models.qwen3.Qwen3Config`` plus ``use_flash_kernel``."""

    hidden_size: int = 4096
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 12288
    vocab_size: int = 151936
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    max_cache_length: int = 8192
    scan_layers: bool = False
    remat: bool = False
    use_decode_kernel: bool = True
    use_cache_append_kernel: bool = True
    use_flash_kernel: bool = True
    chunk_verify: bool = False
    quant_int8: bool = False
    lora_rank: int = 0
    lora_alpha: float = 64.0
    lora_targets: tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj",
    )

    @classmethod
    def tiny(cls, **kw) -> "Qwen3Config":
        base = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    head_dim=16, intermediate_size=128, vocab_size=512,
                    max_cache_length=128)
        base.update(kw)
        return cls(**base)

    def plain(self) -> "Qwen3Config":
        """This config with every kernel switched to its plain version."""
        return replace(self, use_flash_kernel=False, use_decode_kernel=False,
                       use_cache_append_kernel=False)


def _check_supported(cfg: Qwen3Config) -> None:
    unsupported = [name for name in ("scan_layers", "quant_int8", "chunk_verify")
                   if getattr(cfg, name)]
    if cfg.lora_rank:
        unsupported.append("lora_rank")
    if unsupported:
        raise NotImplementedError(
            f"Qwen3Config options not ported yet: {', '.join(unsupported)}")


class KVCache:
    """Per-layer static-shape cache, updated in place; ``length`` is the
    live prefix size (a Python int, so no step waits on the device)."""

    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor],
                 length: int = 0):
        self.k, self.v, self.length = k, v, length

    @classmethod
    def zeros(cls, config: Qwen3Config, batch: int,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (batch, config.num_kv_heads, config.max_cache_length,
                 config.head_dim)
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.num_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.num_layers)])


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.config = cfg
        hidden, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(hidden, cfg.num_heads * d, bias=False)
        self.k_proj = nn.Linear(hidden, cfg.num_kv_heads * d, bias=False)
        self.v_proj = nn.Linear(hidden, cfg.num_kv_heads * d, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * d, hidden, bias=False)
        self.q_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.k_norm = RMSNorm(d, cfg.rms_norm_eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                layer: int, cache: Optional[KVCache]) -> torch.Tensor:
        cfg = self.config
        batch, seq, _ = x.shape
        n_q, n_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_norm(self.q_proj(x).view(batch, seq, n_q, d))
        k = self.k_norm(self.k_proj(x).view(batch, seq, n_kv, d))
        v = self.v_proj(x).view(batch, seq, n_kv, d)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q = (q * cos + rotate_half(q) * sin).to(q.dtype).contiguous()
        k = (k * cos + rotate_half(k) * sin).to(k.dtype).contiguous()
        v = v.contiguous()
        attend = flash_attention if cfg.use_flash_kernel else attention_reference

        if cache is None:
            # teacher-forced path: causal over the sequence
            out = attend(q, k, v, causal=True)
        else:
            start = cache.length
            if start + seq > cfg.max_cache_length:
                raise ValueError(
                    f"KV cache full: {start} + {seq} tokens exceed "
                    f"max_cache_length={cfg.max_cache_length}")
            ck, cv = cache.k[layer], cache.v[layer]
            if seq == 1 and cfg.use_cache_append_kernel and d % 128 == 0:
                # one row per slot, written in place by the kernel
                pos = torch.full((batch,), start, dtype=torch.int32,
                                 device=x.device)
                ck = cache_append(ck, k[:, :, 0].to(ck.dtype).contiguous(), pos)
                cv = cache_append(cv, v[:, :, 0].to(cv.dtype).contiguous(), pos)
                cache.k[layer], cache.v[layer] = ck, cv
            else:
                # plain slice write (dynamic_update_slice in the JAX model)
                ck[:, :, start:start + seq] = k.to(ck.dtype)
                cv[:, :, start:start + seq] = v.to(cv.dtype)
            if seq > 1:
                # prefill into an empty cache: causal over the prompt only
                out = attend(q, k, v, causal=True)
            else:
                lengths = torch.full((batch,), start + 1, dtype=torch.int32,
                                     device=x.device)
                decode = (decode_attention if cfg.use_decode_kernel
                          else decode_attention_reference)
                out = decode(q[:, :, 0], ck, cv, lengths)[:, :, None, :]

        out = out.transpose(1, 2).reshape(batch, seq, n_q * d)
        return self.o_proj(out)


class Qwen3Mlp(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3Layer(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen3Attention(cfg)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Qwen3Mlp(cfg)

    def forward(self, x, cos, sin, layer: int, cache: Optional[KVCache]):
        x = x + self.self_attn(self.input_norm(x), cos, sin, layer, cache)
        return x + self.mlp(self.post_attn_norm(x))


class Qwen3Model(nn.Module):
    """Unrolled decoder stack with an optional KV cache.

    ``forward`` returns ``(logits, cache)``; with a cache, the new tokens'
    K/V are written into it in place and ``cache.length`` advances by the
    sequence length.
    """

    def __init__(self, config: Qwen3Config):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(Qwen3Layer(config)
                                    for _ in range(config.num_layers))
        self.final_norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.lm_head = (None if config.tie_word_embeddings else
                        nn.Linear(config.hidden_size, config.vocab_size, bias=False))

    def forward(
        self,
        tokens: Optional[torch.Tensor] = None,          # [B, S] int
        *,
        inputs_embeds: Optional[torch.Tensor] = None,   # [B, S, D]
        positions: Optional[torch.Tensor] = None,       # [S]
        cache: Optional[KVCache] = None,
    ) -> tuple[torch.Tensor, Optional[KVCache]]:
        cfg = self.config
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens(tokens)
        seq = x.shape[1]
        if positions is None:
            positions = torch.arange(seq, device=x.device)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, i, cache)
        x = self.final_norm(x)
        if cfg.tie_word_embeddings:
            logits = x @ self.embed_tokens.weight.T
        else:
            logits = self.lm_head(x)
        if cache is not None:
            cache.length += seq
        return logits, cache


def init_params(config: Qwen3Config, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random weights as a state dict: N(0, 0.02) matrices (as HF
    initialises Qwen3), unit norms, drawn from ``generator`` on ``device``."""
    device = resolve_device(device)
    with torch.device("meta"):
        shapes = {name: p.shape for name, p in Qwen3Model(config).state_dict().items()}
    params = {}
    for name, shape in shapes.items():
        if name.endswith("norm.weight"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.empty(shape, dtype=dtype, device=device)
            params[name] = w.normal_(0.0, 0.02, generator=generator)
    return params


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.7, top_p: float = 0.8,
                  top_k: int = 20) -> torch.Tensor:
    """Temperature + top-k + nucleus sampling; argmax when temperature=0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p (always keep the best)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class Qwen3Engine:
    """Prefill + streaming decode around :class:`Qwen3Model`, as
    ``gvl_tpu.models.qwen3.Qwen3Engine``.

    >>> engine = Qwen3Engine(config, state_dict, device="cuda")
    >>> for token in engine.stream(prompt_ids, max_new_tokens=64):
    ...     ...

    ``dtype`` is the KV cache's (and an embedding prefix's) type; the
    weights keep theirs.
    """

    PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(self, config: Qwen3Config, state_dict: dict[str, torch.Tensor],
                 eos_token_id: int = 151645, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = Qwen3Model(config)
        model.load_state_dict(state_dict, assign=True)
        self.model = model.to(self.device).eval()

    def _bucket(self, n: int) -> int:
        for b in self.PROMPT_BUCKETS:
            if n <= b:
                return min(b, self.config.max_cache_length)
        return self.config.max_cache_length

    @torch.inference_mode()
    def stream(
        self,
        prompt_ids,
        max_new_tokens: int = 512,
        temperature: float = 0.7,
        top_p: float = 0.8,
        top_k: int = 20,
        generator: Optional[torch.Generator] = None,
        inputs_embeds_prefix: Optional[np.ndarray] = None,
    ) -> Iterator[int]:
        """Yield generated token ids one at a time (greedy if T=0)."""
        dev = self.device
        ids = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=dev)[None]
        n_prefix = 0 if inputs_embeds_prefix is None else len(inputs_embeds_prefix)
        true_len = ids.shape[1] + n_prefix
        if true_len > self.config.max_cache_length:
            raise ValueError(
                f"prompt length {true_len} ({ids.shape[1]} tokens + {n_prefix}"
                f" embed-prefix rows) exceeds max_cache_length="
                f"{self.config.max_cache_length}; truncate the context or "
                "raise Qwen3Config.max_cache_length")
        # right-pad the token prompt so (prefix + tokens) hits a static bucket
        pad = self._bucket(true_len) - true_len
        if pad:
            ids = F.pad(ids, (0, pad))

        cache = KVCache.zeros(self.config, 1, dtype=self.dtype, device=dev)
        x = self.model.embed_tokens(ids)
        if inputs_embeds_prefix is not None:
            prefix = torch.as_tensor(np.asarray(inputs_embeds_prefix), device=dev)
            x = torch.cat([prefix.to(self.dtype).to(x.dtype)[None], x], dim=1)
        positions = torch.arange(x.shape[1], device=dev)
        logits, cache = self.model(inputs_embeds=x, positions=positions, cache=cache)
        # right-padded prompt: the real last token is at true_len - 1
        cache.length = true_len
        token = sample_logits(logits[:, true_len - 1], generator, temperature,
                              top_p, top_k)

        for _ in range(max_new_tokens):
            tok = int(token[0])
            if tok == self.eos_token_id:
                return
            yield tok
            positions = torch.arange(cache.length, cache.length + 1, device=dev)
            logits, cache = self.model(token[:, None].long(), positions=positions,
                                       cache=cache)
            token = sample_logits(logits[:, -1], generator, temperature, top_p,
                                  top_k)

    def generate(self, prompt_ids, **kw) -> list[int]:
        return list(self.stream(prompt_ids, **kw))
