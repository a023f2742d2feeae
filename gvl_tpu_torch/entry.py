"""The port's counterpart of ``__graft_entry__.entry``: a forward step of the
flagship reasoning decoder at the full 8B layer geometry (Qwen3-VL-8B's
text decoder: hidden 4096, 32 query / 8 KV heads, head_dim 128, MLP
12288, vocabulary 151936), cut to 4 layers, with zero weights.

    fn, args = entry()          # on the card
    logits = fn(*args)          # [1, 128, 151936]

The prefill's attention runs on the flash kernel (B1).  ``config``
replaces the geometry (the CPU tests pass a tiny one: the 8B geometry at
depth 4 holds 2.0 G f32 weights).
"""

from __future__ import annotations

from typing import Optional

import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model


def flagship_config() -> Qwen3Config:
    """The 8B layer geometry at depth 4 (``__graft_entry__.entry``'s)."""
    return Qwen3Config(
        hidden_size=4096, num_layers=4, num_heads=32, num_kv_heads=8,
        head_dim=128, intermediate_size=12288, vocab_size=151936,
        max_cache_length=1024,
    )


def entry(device: str | torch.device = "cuda", config: Optional[Qwen3Config] = None):
    """(fn, example_args): ``fn(params, tokens)`` runs the decoder's forward
    with ``params`` (a state dict of zeros, f32) on ``tokens`` (``[1, 128]``
    ones) and returns the logits."""
    device = resolve_device(device)
    cfg = config or flagship_config()
    with torch.device("meta"):
        model = Qwen3Model(cfg)
    params = {name: torch.zeros(t.shape, dtype=torch.float32, device=device)
              for name, t in model.state_dict().items()}
    model = model.to_empty(device=device).eval()
    tokens = torch.ones((1, 128), dtype=torch.long, device=device)

    @torch.inference_mode()
    def fn(params, tokens):
        logits, _ = torch.func.functional_call(model, params, (tokens,))
        return logits

    return fn, (params, tokens)
