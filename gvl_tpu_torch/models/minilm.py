"""MiniLM-class sentence encoder, the BERT architecture (counterpart of
:mod:`gvl_tpu.models.minilm`).

A post-LayerNorm BERT encoder, the all-MiniLM-L6-v2 recipe on top of it
(mean pooling over the attention mask, then L2 normalisation) and a
converter from HF ``BertModel`` state dicts.  The attention is plain
PyTorch with the key mask as scores of ``-1e30``, as the JAX model
computes it in plain ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import LayerNorm, load_module


@dataclass(frozen=True)
class MiniLMConfig:
    """Defaults sized for all-MiniLM-L6-v2."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def tiny(cls, **kw) -> "MiniLMConfig":
        base = dict(vocab_size=512, hidden_size=32, num_layers=2,
                    num_heads=2, intermediate_size=64, max_position=64)
        base.update(kw)
        return cls(**base)


class BertLayer(nn.Module):
    """Self-attention (masked keys at -1e30), residual, LayerNorm; exact-GELU
    feed-forward, residual, LayerNorm."""

    def __init__(self, config: MiniLMConfig):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_norm = LayerNorm(d, config.layer_norm_eps)
        self.ff_in = nn.Linear(d, config.intermediate_size)
        self.ff_out = nn.Linear(config.intermediate_size, d)
        self.ff_norm = LayerNorm(d, config.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        batch, seq, d = x.shape

        def heads(t):
            return t.view(batch, seq, self.num_heads, -1).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = (q @ k.transpose(-1, -2)) / float(np.sqrt(d // self.num_heads))
        scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(batch, seq, d)
        x = self.attn_norm(x + self.attn_out(ctx))
        return self.ff_norm(x + self.ff_out(F.gelu(self.ff_in(x))))


class MiniLMModel(nn.Module):
    """BERT encoder; returns the last hidden state ``[B, S, D]``."""

    def __init__(self, config: MiniLMConfig):
        super().__init__()
        self.config = config
        d = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, d)
        self.position_embeddings = nn.Embedding(config.max_position, d)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, d)
        self.embed_norm = LayerNorm(d, config.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(config) for _ in range(config.num_layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = input_ids.long()
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        mask = attention_mask.bool()
        positions = torch.arange(ids.shape[1], device=ids.device)
        x = (self.word_embeddings(ids) + self.position_embeddings(positions)[None]
             + self.token_type_embeddings(torch.zeros_like(ids)))
        x = self.embed_norm(x)
        for layer in self.layers:
            x = layer(x, mask)
        return x


def mean_pool_normalize(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """sentence-transformers pooling: masked mean, then L2 normalisation."""
    mask = attention_mask[..., None].to(hidden.dtype)
    emb = (hidden * mask).sum(1) / torch.clamp(mask.sum(1), min=1e-9)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)


# --------------------------------------------------------------------------
# HF conversion
# --------------------------------------------------------------------------

_LAYER_NAMES = {
    "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
    "attn_out": "attention.output.dense", "attn_norm": "attention.output.LayerNorm",
    "ff_in": "intermediate.dense", "ff_out": "output.dense", "ff_norm": "output.LayerNorm",
}


def convert_hf_bert(state_dict: dict, config: MiniLMConfig) -> dict[str, torch.Tensor]:
    """A HF ``BertModel`` state dict (with or without the ``bert.`` prefix)
    as the port's :class:`MiniLMModel` state dict (JAX's ``convert_hf_bert``);
    HF's ``[out, in]`` weights keep their orientation."""
    sd = {k.removeprefix("bert."): torch.as_tensor(v) for k, v in state_dict.items()}
    out = {f"{name}.weight": sd[f"embeddings.{name}.weight"]
           for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    out["embed_norm.weight"] = sd["embeddings.LayerNorm.weight"]
    out["embed_norm.bias"] = sd["embeddings.LayerNorm.bias"]
    for i in range(config.num_layers):
        for ours, theirs in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = sd[f"encoder.layer.{i}.{theirs}.{leaf}"]
    return out


def read_hf_state(path) -> dict[str, torch.Tensor]:
    """The tensors of a local HF checkpoint directory: ``model.safetensors``
    when ``safetensors`` reads it, else ``pytorch_model.bin``."""
    path = Path(path)
    try:
        from safetensors.torch import load_file

        return load_file(str(path / "model.safetensors"))
    except Exception:
        return torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)


def load_hf_minilm(path) -> tuple[MiniLMConfig, dict[str, torch.Tensor]]:
    """A local HF checkpoint directory (e.g. all-MiniLM-L6-v2) as
    ``(config, state_dict)``, the state dict on the CPU."""
    doc = json.loads((Path(path) / "config.json").read_text())
    config = MiniLMConfig(
        vocab_size=doc["vocab_size"], hidden_size=doc["hidden_size"],
        num_layers=doc["num_hidden_layers"], num_heads=doc["num_attention_heads"],
        intermediate_size=doc["intermediate_size"],
        max_position=doc["max_position_embeddings"],
        type_vocab_size=doc.get("type_vocab_size", 2),
        layer_norm_eps=doc.get("layer_norm_eps", 1e-12))
    return config, convert_hf_bert(read_hf_state(path), config)


def load_minilm(config: MiniLMConfig, state: dict[str, torch.Tensor],
                device: str | torch.device = "cuda") -> MiniLMModel:
    """The port's state dict as a :class:`MiniLMModel` on ``device``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = MiniLMModel(config)
    return load_module(model, state, device)


# --------------------------------------------------------------------------
# Sentence-encoder front end
# --------------------------------------------------------------------------

class MiniLMSentenceEncoder:
    """The retriever's TextEmbedder protocol over :class:`MiniLMModel`:
    texts are tokenized to 256 positions at most, the batch padded to a
    bucket of :data:`BUCKETS` (padded rows keep their first position live),
    encoded on the model's device, mean-pooled and normalised there.

    ``tokenize(texts, max_len)`` gives numpy ``(input_ids, attention_mask)``
    ``[N, max_len]``.
    """

    BUCKETS = (16, 32, 64, 128, 256)
    # sentence-transformers' all-MiniLM-L6-v2 recipe truncates at 256
    # wordpieces (the BERT position table allows 512)
    MAX_TOKENS = 256

    def __init__(self, model: MiniLMModel, tokenize: Callable):
        self.model = model
        self.device = next(model.parameters()).device
        self._tokenize = tokenize

    @classmethod
    def from_hf_checkpoint(cls, path, device: str | torch.device = "cuda"
                           ) -> "MiniLMSentenceEncoder":
        """The model of an HF directory on ``device`` with the directory's
        tokenizer (``transformers.AutoTokenizer``, imported here only)."""
        from transformers import AutoTokenizer

        device = resolve_device(device)
        config, state = load_hf_minilm(path)
        tokenizer = AutoTokenizer.from_pretrained(path)

        def tokenize(texts, max_len):
            out = tokenizer(list(texts), padding="max_length", truncation=True,
                            max_length=max_len, return_tensors="np")
            return out["input_ids"], out["attention_mask"]

        return cls(load_minilm(config, state, device), tokenize)

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return ((n + self.BUCKETS[-1] - 1) // self.BUCKETS[-1]) * self.BUCKETS[-1]

    @torch.inference_mode()
    def encode(self, texts) -> np.ndarray:
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.model.config.hidden_size), np.float32)
        max_len = min(self.model.config.max_position, self.MAX_TOKENS)
        ids, mask = (np.asarray(a) for a in self._tokenize(texts, max_len))
        n = len(texts)
        padded = self._bucket(n)
        if padded != n:
            pad = ((0, padded - n), (0, 0))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
            mask[n:, 0] = 1   # no fully masked rows
        ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        mask = torch.from_numpy(mask.astype(np.int64)).to(self.device)
        out = mean_pool_normalize(self.model(ids, mask), mask)
        return out[:n].float().cpu().numpy()
