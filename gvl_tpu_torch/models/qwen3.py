"""Qwen3-class decoder and its serving engine, in PyTorch.

Counterpart of :mod:`gvl_tpu.models.qwen3` for the full-precision model:
GQA attention with per-head q/k RMSNorm and RoPE, SwiGLU MLP, a KV cache
with per-slot lengths, and :class:`Qwen3Engine` (bucketed prefill, then one
token per step).  Attention goes through the port's kernels on CUDA tensors
and through their plain versions on CPU tensors:

- ``ops.attention.flash_attention``: prefill into an empty cache and the
  teacher-forced forward, through ``ops.attention.dot_product_attention``
  (differentiable: training backpropagates through the kernel's forward);
- ``ops.decode_attention.chunk_attention``: every chunk of a
  ``chunk_verify`` model (speculative verify, session delta ingest, batch
  admission), whatever its length;
- ``ops.decode_attention.decode_attention``: each decode step, and
  ``decode_attention_stacked`` for a ``scan_layers`` model's stacked cache;
- ``ops.cache_update.cache_append_kv`` / ``cache_append_stacked_kv``: the
  decode step's K and V rows, one launch per layer, whenever the kernel
  takes the row (a multiple of 16 bytes, of the cache's type or f32 into
  bf16).  The JAX model takes its append kernel only at head_dim % 128 == 0,
  the TPU's lane width; the writes are exact, so the cache holds the same
  bits either way, and the QA model (head_dim 64) writes through the kernel.

``scan_layers`` keeps the JAX layout: every layer weight stacked over a
leading layer axis (``layers.self_attn.q_proj.weight`` is ``[L, out, in]``)
and one ``[L, B, Hkv, S_max, D]`` cache per side; each layer reads its
weights and cache as views.  The config's ``use_*_kernel`` flags send a
CUDA model down the plain versions instead, which is how the kernel path is
checked on the card.

``quant_int8`` stores every projection and the LM head weight-only int8
(``weight_q`` ``[out, in]`` with a per-output-channel f32 ``scale``; the
product is ``(x @ q^T) * scale`` in x's type, the JAX ``Int8Dense``'s
algebra, a plain product as in JAX, which computes it outside any Pallas
kernel).  ``lora_rank > 0`` adds ``lora_a`` ``[in, r]`` and ``lora_b``
``[r, out]`` (JAX's orientation) to each target, ``+ ((x @ a) @ b) *
alpha / r`` (``LoRADense``).  :func:`merge_lora`, :func:`quantize_int8`
and :func:`load_adapter_and_merge` are the JAX package's serving
utilities on the port's state dicts.

``Qwen3Model.forward`` takes Qwen3-VL's inputs too: ``rope_cos_sin``
(interleaved mRoPE tables that replace the 1-D rotary angles) and
``deepstack_embeds`` (visual features added after the first layers); both
need the unrolled stack, and a ``scan_layers`` model raises on them (the
JAX model ignores them there, ROADMAP C10).  :func:`convert_hf_qwen3` and
:func:`load_hf_qwen3` read HF ``Qwen3ForCausalLM`` checkpoints
(``transformers`` is imported inside the loader only).

``mesh=`` (a :class:`~gvl_tpu_torch.parallel.mesh.Mesh` or ``MeshManager``)
builds this rank's shards of a tensor-parallel model, Megatron style, with
the collectives of :mod:`gvl_tpu_torch.parallel.collectives` over the
mesh's ``model`` group (the JAX model's variables sharded by ``LLM_RULES``,
where GSPMD inserts them): q/k/v/gate/up are column-parallel (``lora_b``
and the int8 ``scale`` follow the output), o/down row-parallel with one
``all_reduce_sum`` each (``lora_a`` cut on the input), the embedding cut on
the hidden size and the LM head on the vocabulary, each followed by
``all_gather_cat``; norms are whole.  Attention shards by whole KV groups
when ``num_kv_heads`` divides over ``model`` and is otherwise whole on
every rank with its cache (JAX's ``_cache_sharding`` rule); the MLP shards
when ``intermediate_size`` divides.  The kernels run per rank at the local
head counts.  :func:`load_model` cuts a full state dict with
:func:`~gvl_tpu_torch.parallel.sharding.shard_state`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import RMSNorm
from gvl_tpu_torch.ops.attention import dot_product_attention
from gvl_tpu_torch.ops.cache_update import (
    appends_in_kernel,
    cache_append_kv,
    cache_append_stacked_kv,
)
from gvl_tpu_torch.ops.decode_attention import (
    chunk_attention,
    chunk_attention_reference,
    decode_attention,
    decode_attention_reference,
    decode_attention_stacked,
    decode_attention_stacked_reference,
)
from gvl_tpu_torch.ops.rope import rope_angles, rotate_half
from gvl_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
    copy_to_group,
)
from gvl_tpu_torch.parallel.mesh import as_mesh


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

    @classmethod
    def qwen3_vl_8b(cls, **kw) -> "Qwen3Config":
        """Qwen3-VL-8B's text decoder (the defaults)."""
        return cls(**kw)

    def plain(self) -> "Qwen3Config":
        """This config with every kernel switched to its plain version."""
        return replace(self, use_flash_kernel=False, use_decode_kernel=False,
                       use_cache_append_kernel=False)


@dataclass(frozen=True)
class TensorParallel:
    """What a rank of a ``model`` group holds of the decoder: ``group``
    (None: the whole model, no collectives), its ``size`` and this rank's
    ``index`` in it, and which parts are cut (:func:`tensor_parallel`)."""

    group: object = None
    size: int = 1
    index: int = 0
    attention: bool = False
    mlp: bool = False
    embed: bool = False
    head: bool = False

    def part(self, n: int, cut: bool) -> int:
        return n // self.size if cut else n


def tp_cuts(config: "Qwen3Config", model_size: int) -> dict[str, bool]:
    """Which parts of the decoder are cut over ``model_size`` ranks (the
    layout ``LLM_RULES`` gives, with whole KV groups per rank): attention
    only when ``num_kv_heads`` divides, the MLP when ``intermediate_size``
    does, the embedding when ``hidden_size`` does, the LM head when
    ``vocab_size`` does."""
    m = model_size
    return dict(attention=config.num_kv_heads % m == 0,
                mlp=config.intermediate_size % m == 0,
                embed=config.hidden_size % m == 0,
                head=not config.tie_word_embeddings and config.vocab_size % m == 0)


def tensor_parallel(config: "Qwen3Config", mesh) -> TensorParallel:
    """This rank's share of ``config``'s decoder on ``mesh`` (:func:`tp_cuts`)."""
    mesh = as_mesh(mesh)
    if mesh is None or mesh.model_group is None:
        return TensorParallel()
    m = mesh.shape["model"]
    return TensorParallel(mesh.model_group, m, mesh.model_index, **tp_cuts(config, m))


class KVCache:
    """Static-shape KV cache, written in place.

    ``k`` and ``v`` hold one ``[B, Hkv, S_max, D]`` tensor per layer, or,
    for a ``scan_layers`` model, one ``[L, B, Hkv, S_max, D]`` tensor each.
    ``lengths`` is each slot's live prefix size, kept on the host as ints so
    that no step waits on the device; the model copies it to the device
    once per forward.  ``length`` reads and sets all slots at once.
    """

    def __init__(self, k, v, lengths: int | Sequence[int] = 0):
        self.k, self.v = k, v
        batch = k.shape[1] if self.stacked else k[0].shape[0]
        self.lengths = ([int(lengths)] * batch if isinstance(lengths, int)
                        else [int(n) for n in lengths])

    @property
    def stacked(self) -> bool:
        return isinstance(self.k, torch.Tensor)

    @property
    def max_length(self) -> int:
        return self.k[0].shape[-2]

    @property
    def length(self) -> int:
        """The live length shared by every slot."""
        if len(set(self.lengths)) != 1:
            raise ValueError(f"slots hold different lengths {self.lengths}")
        return self.lengths[0]

    @length.setter
    def length(self, value: int) -> None:
        self.lengths = [int(value)] * len(self.lengths)

    def lengths_tensor(self, device: torch.device) -> torch.Tensor:
        """``lengths`` as an int32 tensor on ``device`` (a host-to-device
        copy that does not wait for the device)."""
        host = torch.tensor(self.lengths, dtype=torch.int32)
        return host if device.type == "cpu" else host.to(device, non_blocking=True)

    def slot(self, index: int) -> "KVCache":
        """Slot ``index`` as a batch-1 cache whose tensors are views of this
        one's: what is written into it lands in this cache."""
        pick = slice(index, index + 1)
        if self.stacked:
            return KVCache(self.k[:, pick], self.v[:, pick], [self.lengths[index]])
        return KVCache([t[pick] for t in self.k], [t[pick] for t in self.v],
                       [self.lengths[index]])

    @classmethod
    def zeros(cls, config: Qwen3Config, batch: int,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device = "cuda", mesh=None) -> "KVCache":
        """``mesh``: this rank's KV heads of a tensor-parallel model."""
        device = resolve_device(device)
        tp = tensor_parallel(config, mesh)
        shape = (batch, tp.part(config.num_kv_heads, tp.attention),
                 config.max_cache_length, config.head_dim)
        if config.scan_layers:
            stacked = (config.num_layers, *shape)
            return cls(torch.zeros(stacked, dtype=dtype, device=device),
                       torch.zeros(stacked, dtype=dtype, device=device))
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.num_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.num_layers)])


class Linear(nn.Module):
    """Bias-free projection ``x @ W^T`` (``nn.Linear``'s ``weight`` layout);
    with ``stack=(L,)`` every tensor has a leading layer axis and ``index``
    picks the layer.

    ``quant``: the JAX ``Int8Dense``, weight-only int8 ``weight_q``
    ``[out, in]`` and a per-output-channel ``scale``, ``(x @ q^T) * scale``
    in x's type (the int8 weight is cast to x's type on each call).
    ``rank > 0``: the JAX ``LoRADense`` delta ``((x @ lora_a) @ lora_b) *
    alpha / rank``, ``lora_a`` ``[in, rank]`` and ``lora_b`` ``[rank, out]``.
    """

    def __init__(self, n_in: int, n_out: int, stack: tuple = (), quant: bool = False,
                 rank: int = 0, alpha: float = 64.0):
        super().__init__()
        self.quant, self.rank = quant, rank
        if quant:
            self.register_buffer("weight_q", torch.empty(*stack, n_out, n_in, dtype=torch.int8))
            self.register_buffer("scale", torch.empty(*stack, n_out))
        else:
            self.weight = nn.Parameter(torch.empty(*stack, n_out, n_in))
        if rank:
            self.lora_a = nn.Parameter(torch.empty(*stack, n_in, rank))
            self.lora_b = nn.Parameter(torch.empty(*stack, rank, n_out))
            self.lora_scale = alpha / rank

    def forward(self, x: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        def pick(t: torch.Tensor) -> torch.Tensor:
            return t if index is None else t[index]

        if self.quant:
            out = F.linear(x, pick(self.weight_q).to(x.dtype)) * pick(self.scale).to(x.dtype)
        else:
            out = F.linear(x, pick(self.weight))
        if self.rank:
            out = out + (x @ pick(self.lora_a).to(x.dtype)) @ pick(self.lora_b).to(x.dtype) \
                * self.lora_scale
        return out


def _projection(cfg: "Qwen3Config", name: str, n_in: int, n_out: int,
                stack: tuple) -> Linear:
    """A decoder projection with the config's int8 and LoRA options (LoRA
    only on ``cfg.lora_targets``), as the JAX model's ``_dense``."""
    rank = cfg.lora_rank if name in cfg.lora_targets else 0
    return Linear(n_in, n_out, stack, quant=cfg.quant_int8, rank=rank, alpha=cfg.lora_alpha)


def _write_back(result: torch.Tensor, cache: torch.Tensor) -> None:
    """Keep a cache write in place: the kernels write where the cache lies,
    the plain versions (CPU) return a new tensor, copied back here."""
    if result is not cache:
        cache.copy_(result)


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, stack: tuple = (),
                 tp: TensorParallel = TensorParallel()):
        super().__init__()
        self.config = cfg
        hidden, d = cfg.hidden_size, cfg.head_dim
        # this rank's heads: whole KV groups, or every head when not cut
        self.n_q = tp.part(cfg.num_heads, tp.attention)
        self.n_kv = tp.part(cfg.num_kv_heads, tp.attention)
        self.group = tp.group if tp.attention else None
        self.q_proj = _projection(cfg, "q_proj", hidden, self.n_q * d, stack)
        self.k_proj = _projection(cfg, "k_proj", hidden, self.n_kv * d, stack)
        self.v_proj = _projection(cfg, "v_proj", hidden, self.n_kv * d, stack)
        self.o_proj = _projection(cfg, "o_proj", self.n_q * d, hidden, stack)
        self.q_norm = RMSNorm(d, cfg.rms_norm_eps, stack)
        self.k_norm = RMSNorm(d, cfg.rms_norm_eps, stack)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                layer: int, cache: Optional[KVCache],
                cache_len: Optional[torch.Tensor], index: Optional[int] = None,
                stacked_decode: bool = False) -> torch.Tensor:
        """``cache_len``: the slots' live lengths before this call, [B]
        int32 on x's device; ``index``: the weights' layer when they are
        stacked; ``stacked_decode``: one token per slot written into and
        read from the stacked cache by the stacked kernels."""
        cfg = self.config
        batch, seq, _ = x.shape
        n_q, n_kv, d = self.n_q, self.n_kv, cfg.head_dim
        x = copy_to_group(x, self.group)
        q = self.q_norm(self.q_proj(x, index).view(batch, seq, n_q, d), index)
        k = self.k_norm(self.k_proj(x, index).view(batch, seq, n_kv, d), index)
        v = self.v_proj(x, index).view(batch, seq, n_kv, d)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q = (q * cos + rotate_half(q) * sin).to(q.dtype).contiguous()
        k = (k * cos + rotate_half(k) * sin).to(k.dtype).contiguous()
        v = v.contiguous()

        if cache is None:
            # teacher-forced path: causal over the sequence, differentiable
            out = dot_product_attention(q, k, v, causal=True,
                                        kernel=cfg.use_flash_kernel)
        elif stacked_decode:
            # scan-layers decode: this layer's K and V rows go into the
            # stacked caches in place (one launch) and are read back by the
            # layer-indexed kernel
            k_all, v_all = cache.k, cache.v
            k_row, v_row = k[:, :, 0], v[:, :, 0]
            if not appends_in_kernel(k_all, k_row):
                k_row, v_row = k_row.to(k_all.dtype), v_row.to(v_all.dtype)
            k_out, v_out = cache_append_stacked_kv(k_all, v_all, k_row, v_row,
                                                   cache_len, layer)
            _write_back(k_out, k_all)
            _write_back(v_out, v_all)
            decode = (decode_attention_stacked if cfg.use_decode_kernel
                      else decode_attention_stacked_reference)
            out = decode(q[:, :, 0], k_all, v_all, cache_len + 1, layer)[:, :, None, :]
        else:
            ck, cv = cache.k[layer], cache.v[layer]
            if seq == 1 and cfg.use_cache_append_kernel and appends_in_kernel(ck, k):
                # one row per slot into K and V, written in place (and cast
                # to the cache's type) by one launch
                k_out, v_out = cache_append_kv(ck, cv, k[:, :, 0], v[:, :, 0], cache_len)
                _write_back(k_out, ck)
                _write_back(v_out, cv)
            elif seq == 1:
                # per-slot scatter of one row
                slot = torch.arange(batch, device=x.device)
                pos = cache_len.long()
                ck[slot, :, pos, :] = k[:, :, 0].to(ck.dtype)
                cv[slot, :, pos, :] = v[:, :, 0].to(cv.dtype)
            else:
                # the chunk at each slot's offset (dynamic_update_slice in
                # the JAX model; the model has checked that it fits)
                starts = cache.lengths
                if len(set(starts)) == 1:
                    ck[:, :, starts[0]:starts[0] + seq] = k.to(ck.dtype)
                    cv[:, :, starts[0]:starts[0] + seq] = v.to(cv.dtype)
                else:
                    for b, start in enumerate(starts):
                        ck[b, :, start:start + seq] = k[b].to(ck.dtype)
                        cv[b, :, start:start + seq] = v[b].to(cv.dtype)
            if seq > 1 and cfg.chunk_verify:
                # the chunk sits at offset cache_len: each row attends over
                # the cached prefix plus its causal part of the chunk
                chunk = (chunk_attention if cfg.use_decode_kernel
                         else chunk_attention_reference)
                out = chunk(q, ck, cv, cache_len)
            elif seq > 1:
                # prefill into an empty cache: causal over the prompt only
                out = dot_product_attention(q, k, v, causal=True,
                                            kernel=cfg.use_flash_kernel)
            else:
                decode = (decode_attention if cfg.use_decode_kernel
                          else decode_attention_reference)
                out = decode(q[:, :, 0], ck, cv, cache_len + 1)[:, :, None, :]

        out = out.transpose(1, 2).reshape(batch, seq, n_q * d)
        return all_reduce_sum(self.o_proj(out, index), self.group)


class Qwen3Mlp(nn.Module):
    def __init__(self, cfg: Qwen3Config, stack: tuple = (),
                 tp: TensorParallel = TensorParallel()):
        super().__init__()
        hidden, inter = cfg.hidden_size, tp.part(cfg.intermediate_size, tp.mlp)
        self.group = tp.group if tp.mlp else None
        self.gate_proj = _projection(cfg, "gate_proj", hidden, inter, stack)
        self.up_proj = _projection(cfg, "up_proj", hidden, inter, stack)
        self.down_proj = _projection(cfg, "down_proj", inter, hidden, stack)

    def forward(self, x: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        x = copy_to_group(x, self.group)
        gate = F.silu(self.gate_proj(x, index)) * self.up_proj(x, index)
        return all_reduce_sum(self.down_proj(gate, index), self.group)


class Qwen3Layer(nn.Module):
    """One decoder layer, or (``stack=(L,)``) all L layers' weights stacked
    for a ``scan_layers`` model, which runs it once per layer index."""

    def __init__(self, cfg: Qwen3Config, stack: tuple = (),
                 tp: TensorParallel = TensorParallel()):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, stack)
        self.self_attn = Qwen3Attention(cfg, stack, tp)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, stack)
        self.mlp = Qwen3Mlp(cfg, stack, tp)

    def forward(self, x, cos, sin, layer: int, cache: Optional[KVCache],
                cache_len: Optional[torch.Tensor], index: Optional[int] = None,
                stacked_decode: bool = False):
        x = x + self.self_attn(self.input_norm(x, index), cos, sin, layer, cache,
                               cache_len, index, stacked_decode)
        return x + self.mlp(self.post_attn_norm(x, index), index)


class Embedding(nn.Embedding):
    """Token embedding; with ``group``, this rank's slice of the hidden
    size, gathered whole after the lookup."""

    def __init__(self, vocab: int, hidden: int, group=None):
        super().__init__(vocab, hidden)
        self.group = group

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(super().forward(tokens), -1, self.group)


class Qwen3Model(nn.Module):
    """Decoder stack with an optional KV cache.

    ``forward`` returns ``(logits, cache)``; with a cache, the new tokens'
    K/V are written into it in place at each slot's offset and every slot's
    length advances by the sequence length.  A write past
    ``max_cache_length`` raises (the JAX model's writes clamp instead).
    ``mesh``: this rank's shards of a tensor-parallel model (the module
    docstring); every rank of the ``model`` group runs each call, and each
    returns the whole logits.
    """

    def __init__(self, config: Qwen3Config, mesh=None):
        super().__init__()
        self.config = config
        self.tp = tp = tensor_parallel(config, mesh)
        self.embed_tokens = Embedding(config.vocab_size,
                                      tp.part(config.hidden_size, tp.embed),
                                      tp.group if tp.embed else None)
        if config.scan_layers:
            self.layers = Qwen3Layer(config, stack=(config.num_layers,), tp=tp)
        else:
            self.layers = nn.ModuleList(Qwen3Layer(config, tp=tp)
                                        for _ in range(config.num_layers))
        self.final_norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, tp.part(config.vocab_size, tp.head),
                               quant=config.quant_int8))

    def forward(
        self,
        tokens: Optional[torch.Tensor] = None,          # [B, S] int
        *,
        inputs_embeds: Optional[torch.Tensor] = None,   # [B, S, D]
        positions: Optional[torch.Tensor] = None,       # [S] or [B, S]
        cache: Optional[KVCache] = None,
        rope_cos_sin: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # [B, S, D]
        deepstack_embeds: Optional[torch.Tensor] = None,  # [L_ds, B, S, D]
        param_dtype: Optional[torch.dtype] = None,
    ) -> tuple[torch.Tensor, Optional[KVCache]]:
        """``rope_cos_sin`` replaces the angles of ``positions`` (Qwen3-VL's
        mRoPE); ``deepstack_embeds[i]`` is added to the hidden states after
        layer ``i``.  Both need the unrolled stack.  ``param_dtype`` casts
        every weight to that type for this call, as the JAX trainer casts
        its parameter tree inside the loss (no autocast): each module's
        weights are cast where it runs, inside a rematerialised layer too,
        and gradients reach the weights through the casts in their type."""
        cfg = self.config

        def weights(module):
            if param_dtype is None:
                return module
            return lambda *args: torch.func.functional_call(
                module, {n: p.to(param_dtype) for n, p in module.named_parameters()}, args)

        x = inputs_embeds if inputs_embeds is not None else weights(self.embed_tokens)(tokens)
        seq = x.shape[1]
        if cfg.scan_layers and (rope_cos_sin is not None or deepstack_embeds is not None):
            raise ValueError(
                "rope_cos_sin and deepstack_embeds need the unrolled stack; this "
                "model has scan_layers=True (ROADMAP C10)")
        if rope_cos_sin is not None:
            cos, sin = rope_cos_sin
            cos, sin = cos[:, None], sin[:, None]          # [B, 1, S, D]
        else:
            if positions is None:
                positions = torch.arange(seq, device=x.device)
            cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            if positions.dim() == 2:        # per-slot positions: [B, 1, S, D]
                cos, sin = cos[:, None], sin[:, None]
        cache_len = None
        if cache is not None:
            full = [n for n in cache.lengths if n + seq > cache.max_length]
            if full:
                raise ValueError(
                    f"KV cache full: {full[0]} + {seq} tokens exceed "
                    f"max_cache_length={cache.max_length}")
            cache_len = cache.lengths_tensor(x.device)
        stacked_decode = (cfg.scan_layers and cache is not None and seq == 1
                          and cfg.use_cache_append_kernel
                          and cfg.head_dim % 128 == 0)
        # remat: each layer's activations are dropped after its forward and
        # recomputed in the backward (the JAX model's nn.remat)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i in range(cfg.num_layers):
            layer = weights(self.layers if cfg.scan_layers else self.layers[i])
            args = ((x, cos, sin, i, cache, cache_len, i, stacked_decode) if cfg.scan_layers
                    else (x, cos, sin, i, cache, cache_len))
            if remat:
                x = checkpoint(layer, *args, use_reentrant=False)
            else:
                x = layer(*args)
            if deepstack_embeds is not None and i < deepstack_embeds.shape[0]:
                x = x + deepstack_embeds[i].to(x.dtype)
        x = weights(self.final_norm)(x)
        tp = self.tp
        if cfg.tie_word_embeddings:
            embed = self.embed_tokens.weight
            embed = embed if param_dtype is None else embed.to(param_dtype)
            if tp.embed:
                # this rank's hidden slice against its embedding columns
                part = embed.shape[1]
                x = copy_to_group(x, tp.group).narrow(-1, tp.index * part, part)
                logits = all_reduce_sum(x @ embed.T, tp.group)
            else:
                logits = x @ embed.T
        elif tp.head:
            logits = all_gather_cat(weights(self.lm_head)(copy_to_group(x, tp.group)),
                                    -1, tp.group)
        else:
            logits = weights(self.lm_head)(x)
        if cache is not None:
            cache.lengths = [n + seq for n in cache.lengths]
        return logits, cache

    def embed_only(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings (for splicing ``inputs_embeds`` on the host side)."""
        return self.embed_tokens(tokens)


def load_model(config: Qwen3Config, state_dict: dict[str, torch.Tensor],
               device: str | torch.device = "cuda", mesh=None) -> Qwen3Model:
    """A :class:`Qwen3Model` in eval mode on ``device`` whose parameters are
    the state dict's tensors (shared, not copied, when already there).
    ``mesh``: this rank's shards, cut from a full state dict by
    :func:`~gvl_tpu_torch.parallel.sharding.shard_state` (tensors already
    cut are taken as they are)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = Qwen3Model(config, mesh)
    if as_mesh(mesh) is not None:
        from gvl_tpu_torch.parallel.sharding import shard_state

        state_dict = shard_state(state_dict, mesh, config)
    model.load_state_dict(state_dict, assign=True)
    return model.to(device).eval()


def stack_layers(state_dict: dict[str, torch.Tensor],
                 config: Qwen3Config) -> dict[str, torch.Tensor]:
    """An unrolled model's state dict in the ``scan_layers`` layout: each
    ``layers.{i}.<name>`` stacked into ``layers.<name>`` ([L, ...])."""
    out = {k: v for k, v in state_dict.items() if not k.startswith("layers.")}
    names = [k[len("layers.0."):] for k in state_dict if k.startswith("layers.0.")]
    for name in names:
        out[f"layers.{name}"] = torch.stack(
            [state_dict[f"layers.{i}.{name}"] for i in range(config.num_layers)])
    return out


def init_params(config: Qwen3Config, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random weights as a state dict: N(0, 0.02) matrices (as HF
    initialises Qwen3), unit norms, drawn from ``generator`` on ``device``;
    an int8 config's ``weight_q`` uniform in [-127, 127] with scales of
    1/127 (the JAX ``Int8Dense`` initialisers), LoRA's ``lora_b`` zero."""
    device = resolve_device(device)
    with torch.device("meta"):
        shapes = {name: p.shape for name, p in Qwen3Model(config).state_dict().items()}
    params = {}
    for name, shape in shapes.items():
        if name.endswith("norm.weight"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("weight_q"):
            params[name] = torch.randint(-127, 128, shape, generator=generator,
                                         device=device).to(torch.int8)
        elif name.endswith(".scale"):
            params[name] = torch.full(shape, 1.0 / 127.0, device=device)
        elif name.endswith("lora_b"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            w = torch.empty(shape, dtype=dtype, device=device)
            params[name] = w.normal_(0.0, 0.02, generator=generator)
    return params


def init_jax_params(config: Qwen3Config, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """f32 weights for training from scratch, drawn from ``generator`` with
    the JAX model's initialisers: a projection or the LM head (``[out,
    in]``) from Flax's ``lecun_normal``, a normal truncated at two of its
    standard deviations, scaled so that the weight's variance is 1 /
    fan-in; the embedding N(0, 1 / hidden) (``nn.Embed``'s default, fan-in
    the hidden width); LoRA's ``lora_a`` N(0, 0.02^2) and ``lora_b`` zero;
    unit norms.  The numbers differ from ``model.init``'s, their law does
    not."""
    device = resolve_device(device)
    with torch.device("meta"):
        shapes = {name: p.shape for name, p in Qwen3Model(config).state_dict().items()}
    params = {}
    for name, shape in shapes.items():
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if name.endswith("norm.weight"):
            w.fill_(1.0)
        elif name.endswith("lora_b"):
            w.zero_()
        elif name.endswith("lora_a"):
            w.normal_(0.0, 0.02, generator=generator)
        elif name == "embed_tokens.weight":
            w.normal_(0.0, 1.0 / np.sqrt(shape[-1]), generator=generator)
        else:
            # the unit normal truncated to [-2, 2] has std 0.8796...
            std = 1.0 / np.sqrt(shape[-1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        params[name] = w
    return params


def call_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """``generator``, or a new one seeded 0 on ``device``: a call given no
    generator draws as JAX's engines do given no key (``PRNGKey(0)`` for
    that call), so that its samples depend on nothing run before it
    (ROADMAP C14)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


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
    weights keep theirs.  ``mesh``: serve tensor-parallel (every rank of
    the ``model`` group makes the same calls; the cache holds this rank's
    KV heads).
    """

    PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(self, config: Qwen3Config, state_dict: dict[str, torch.Tensor],
                 eos_token_id: int = 151645, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", mesh=None):
        self.config = config
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = load_model(config, state_dict, self.device, mesh)

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
        """Yield generated token ids one at a time (greedy if T=0).

        The stream ends early, without raising, once the cache is full: the
        last token yielded is the one whose logits came from the last cache
        row.  (The JAX engine goes on decoding with its write start clamped
        onto the last row, over a corrupted cache.)  Without ``generator``
        a sampled stream draws from a new generator seeded 0
        (:func:`call_generator`)."""
        dev = self.device
        generator = call_generator(generator, dev)
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

        cache = KVCache.zeros(self.config, 1, dtype=self.dtype, device=dev, mesh=self.mesh)
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
            if cache.length >= self.config.max_cache_length:
                return
            positions = torch.arange(cache.length, cache.length + 1, device=dev)
            logits, cache = self.model(token[:, None].long(), positions=positions,
                                       cache=cache)
            token = sample_logits(logits[:, -1], generator, temperature, top_p,
                                  top_k)

    def generate(self, prompt_ids, **kw) -> list[int]:
        return list(self.stream(prompt_ids, **kw))


# --------------------------------------------------------------------------
# LoRA and int8 serving utilities (on the port's state dicts)
# --------------------------------------------------------------------------

def merge_lora(state_dict: dict[str, torch.Tensor],
               config: Qwen3Config) -> dict[str, torch.Tensor]:
    """Every ``lora_a``/``lora_b`` pair folded into its base weight
    (``W + ((a @ b) * alpha / rank)^T``, JAX's ``merge_lora`` in the port's
    ``[out, in]`` layout); the pairs are dropped, the result serves a
    rank-0 config."""
    scale = config.lora_alpha / max(config.lora_rank, 1)
    out = {}
    for name, value in state_dict.items():
        if name.endswith((".lora_a", ".lora_b")):
            continue
        prefix = name[: -len(".weight")] if name.endswith(".weight") else None
        if prefix is not None and f"{prefix}.lora_a" in state_dict:
            a, b = state_dict[f"{prefix}.lora_a"], state_dict[f"{prefix}.lora_b"]
            value = value + (a @ b * scale).transpose(-1, -2)
        out[name] = value
    return out


def quantize_int8(state_dict: dict[str, torch.Tensor],
                  config: Qwen3Config) -> dict[str, torch.Tensor]:
    """A float state dict → weight-only int8 for a ``quant_int8`` config
    (JAX's ``quantize_int8``): every projection and the LM head as
    ``weight_q = clip(round(w / scale), ±127)`` (round half to even) with
    ``scale = max(max|w| over the input axis, 1e-8) / 127`` per output
    channel, computed in f32; a stacked ``scan_layers`` weight quantizes per
    layer and column.  LoRA pairs are merged first."""
    if config.lora_rank > 0:
        state_dict = merge_lora(state_dict, config)
    out = {}
    for name, value in state_dict.items():
        if not (name.endswith("_proj.weight") or name == "lm_head.weight"):
            out[name] = value
            continue
        w = value.float()
        scale = torch.clamp(w.abs().amax(dim=-1), min=1e-8) / 127.0
        q = torch.clamp(torch.round(w / scale[..., None]), -127, 127).to(torch.int8)
        prefix = name[: -len(".weight")]
        out[f"{prefix}.weight_q"], out[f"{prefix}.scale"] = q, scale
    return out


def _jax_key(name: str, config: Qwen3Config) -> str:
    """A port state-dict name → the JAX params path of an adapter npz
    (``layers.3.self_attn.q_proj.lora_a`` → ``layers_3/self_attn/q_proj/lora_a``;
    stacked: ``layers/layer/self_attn/...``)."""
    parts = name.split(".")
    if config.scan_layers:
        return "/".join(["layers", "layer", *parts[1:]])
    return "/".join([f"layers_{parts[1]}", *parts[2:]])


def load_adapter_and_merge(base_config: Qwen3Config,
                           state_dict: dict[str, torch.Tensor],
                           adapter_dir) -> tuple[Qwen3Config, dict[str, torch.Tensor]]:
    """Fold a trained LoRA adapter (``adapter_config.json`` and
    ``adapter_final.npz``, else the newest ``adapter_step*.npz``) into the
    base weights, as JAX's ``load_adapter_and_merge``: returns the rank-0
    config and the merged state dict.  A pair the npz does not hold adds
    nothing (JAX's fresh ``lora_b`` is zero); a tensor whose shape is not
    the base geometry's raises ``ValueError`` with JAX's message."""
    import json
    from pathlib import Path

    adapter_dir = Path(adapter_dir)
    meta = json.loads((adapter_dir / "adapter_config.json").read_text())
    lora_cfg = replace(base_config, lora_rank=int(meta["lora_rank"]),
                       lora_alpha=float(meta["lora_alpha"]),
                       lora_targets=tuple(meta.get("targets", base_config.lora_targets)))
    with torch.device("meta"):
        shapes = {name: t.shape for name, t in Qwen3Model(lora_cfg).state_dict().items()}
    adapter_path = adapter_dir / "adapter_final.npz"
    if not adapter_path.exists():
        candidates = sorted(adapter_dir.glob("adapter_step*.npz"))
        adapter_path = candidates[-1] if candidates else None
    flat = {}
    if adapter_path is not None:
        with np.load(adapter_path) as z:
            flat = {k: z[k] for k in z.files}
    merged = dict(state_dict)
    for name, shape in shapes.items():      # the model's order: JAX's first error
        key = _jax_key(name, lora_cfg)
        if name.endswith((".lora_a", ".lora_b")) and key in flat:
            if tuple(flat[key].shape) != tuple(shape):
                raise ValueError(
                    f"adapter tensor {key} has shape {tuple(flat[key].shape)} but the "
                    f"base geometry expects {tuple(shape)}; the adapter in {adapter_dir} "
                    "was trained over an incompatible base checkpoint")
            weight = state_dict[f"{name.rsplit('.', 1)[0]}.weight"]
            merged[name] = torch.from_numpy(np.array(flat[key], order="C")).to(
                weight.device, weight.dtype)
    # a target the npz does not hold both halves of adds nothing
    for name in [n for n in merged if n.endswith(".lora_a")]:
        other = name[: -len("a")] + "b"
        if other not in merged:
            del merged[name]
    for name in [n for n in merged if n.endswith(".lora_b")]:
        if name[: -len("b")] + "a" not in merged:
            del merged[name]
    return replace(lora_cfg, lora_rank=0), merge_lora(merged, lora_cfg)


def convert_hf_qwen3(state_dict: dict[str, torch.Tensor],
                     config: Qwen3Config) -> dict[str, torch.Tensor]:
    """A HF ``Qwen3ForCausalLM`` state dict as the port's state dict for
    ``config`` (JAX's ``convert_hf_qwen3``): HF's ``[out, in]`` weights keep
    their orientation, every layer's tensors are stacked over a leading
    layer axis when ``config.scan_layers``, and no LoRA pairs are made (a
    LoRA config's fresh pairs are a zero delta; pass a rank-0 config)."""
    sd = {k.removeprefix("model."): v.detach() for k, v in state_dict.items()}
    out = {"embed_tokens.weight": sd["embed_tokens.weight"],
           "final_norm.weight": sd["norm.weight"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    names = {"input_norm.weight": "input_layernorm.weight",
             "post_attn_norm.weight": "post_attention_layernorm.weight",
             "self_attn.q_norm.weight": "self_attn.q_norm.weight",
             "self_attn.k_norm.weight": "self_attn.k_norm.weight"}
    names.update({f"self_attn.{p}.weight": f"self_attn.{p}.weight"
                  for p in ("q_proj", "k_proj", "v_proj", "o_proj")})
    names.update({f"mlp.{p}.weight": f"mlp.{p}.weight"
                  for p in ("gate_proj", "up_proj", "down_proj")})
    for ours, theirs in names.items():
        per_layer = [sd[f"layers.{i}.{theirs}"] for i in range(config.num_layers)]
        if config.scan_layers:
            out[f"layers.{ours}"] = torch.stack(per_layer)
        else:
            out.update({f"layers.{i}.{ours}": t for i, t in enumerate(per_layer)})
    return out


def hf_text_config(hf) -> Qwen3Config:
    """The port's config for a HF Qwen3 (or Qwen3-VL text) config."""
    return Qwen3Config(
        hidden_size=hf.hidden_size, num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads, num_kv_heads=hf.num_key_value_heads,
        head_dim=hf.head_dim, intermediate_size=hf.intermediate_size,
        vocab_size=hf.vocab_size, rope_theta=hf.rope_theta,
        rms_norm_eps=hf.rms_norm_eps, tie_word_embeddings=hf.tie_word_embeddings)


def load_hf_qwen3(model_name_or_path, config: Optional[Qwen3Config] = None
                  ) -> tuple[Qwen3Config, dict[str, torch.Tensor]]:
    """A HF ``Qwen3ForCausalLM`` checkpoint (a local directory) as
    ``(config, state_dict)``, the state dict on the CPU in the checkpoint's
    type (JAX's ``load_hf_qwen3`` returns the model and its variables).
    ``transformers`` is imported here only; without it the ``ImportError``
    propagates."""
    from transformers import Qwen3ForCausalLM

    model = Qwen3ForCausalLM.from_pretrained(model_name_or_path)
    config = config or hf_text_config(model.config)
    return config, convert_hf_qwen3(model.state_dict(), config)
