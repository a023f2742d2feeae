"""The JAX package's Qwen3 parameter tree -> the port's ``state_dict``.

The tree is ``gvl_tpu.models.qwen3.Qwen3Model``'s ``params`` as numpy
arrays (what :func:`gvl_tpu_torch.utils.checkpoints.load_flat_npz` reads
from a flat-npz checkpoint): ``layers_{i}/self_attn/q_proj/base/kernel``
and the like, where ``base`` is the ``LoRADense`` level and Flax ``Dense``
kernels are ``[in, out]`` (``nn.Linear`` keeps ``[out, in]``).
"""

from __future__ import annotations

import numpy as np
import torch

from gvl_tpu_torch.models.qwen3 import Qwen3Config

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _linear(node: dict) -> np.ndarray:
    if "base" in node:          # LoRADense wraps its Dense as "base"
        node = node["base"]
    if "kernel" not in node:
        raise KeyError(f"no float kernel in {sorted(node)} (int8 or LoRA "
                       "parameters are not ported yet)")
    return np.asarray(node["kernel"]).T


def params_from_jax(tree: dict, config: Qwen3Config) -> dict[str, torch.Tensor]:
    """``state_dict`` for :class:`~gvl_tpu_torch.models.qwen3.Qwen3Model`."""
    params = tree["params"] if "params" in tree else tree
    out: dict[str, np.ndarray] = {
        "embed_tokens.weight": np.asarray(params["embed_tokens"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    for i in range(config.num_layers):
        layer = params[f"layers_{i}"]
        pre = f"layers.{i}."
        out[pre + "input_norm.weight"] = layer["input_norm"]["scale"]
        out[pre + "post_attn_norm.weight"] = layer["post_attn_norm"]["scale"]
        attn = layer["self_attn"]
        for name in _ATTN:
            out[pre + f"self_attn.{name}.weight"] = _linear(attn[name])
        out[pre + "self_attn.q_norm.weight"] = attn["q_norm"]["scale"]
        out[pre + "self_attn.k_norm.weight"] = attn["k_norm"]["scale"]
        for name in _MLP:
            out[pre + f"mlp.{name}.weight"] = _linear(layer["mlp"][name])
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
