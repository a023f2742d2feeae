"""The JAX package's Qwen3 parameter tree -> the port's ``state_dict``.

The tree is ``gvl_tpu.models.qwen3.Qwen3Model``'s ``params`` as numpy
arrays (what :func:`gvl_tpu_torch.utils.checkpoints.load_flat_npz` reads
from a flat-npz checkpoint): ``layers_{i}/self_attn/q_proj/base/kernel``
and the like, where ``base`` is the ``LoRADense`` level and Flax ``Dense``
kernels are ``[in, out]`` (the port keeps ``nn.Linear``'s ``[out, in]``).
A ``scan_layers`` tree holds every layer's leaves stacked under
``layers/layer/...`` (kernels ``[L, in, out]``).  Either tree converts to
either layout: the port's state dict follows ``config.scan_layers``.
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
    return np.swapaxes(np.asarray(node["kernel"]), -1, -2)


def _layer(layer: dict) -> dict[str, np.ndarray]:
    """One layer's (or, in a scan tree, every layer's stacked) arrays under
    the port's names."""
    out = {"input_norm.weight": np.asarray(layer["input_norm"]["scale"]),
           "post_attn_norm.weight": np.asarray(layer["post_attn_norm"]["scale"])}
    attn = layer["self_attn"]
    for name in _ATTN:
        out[f"self_attn.{name}.weight"] = _linear(attn[name])
    out["self_attn.q_norm.weight"] = np.asarray(attn["q_norm"]["scale"])
    out["self_attn.k_norm.weight"] = np.asarray(attn["k_norm"]["scale"])
    for name in _MLP:
        out[f"mlp.{name}.weight"] = _linear(layer["mlp"][name])
    return out


def params_from_jax(tree: dict, config: Qwen3Config) -> dict[str, torch.Tensor]:
    """``state_dict`` for :class:`~gvl_tpu_torch.models.qwen3.Qwen3Model`."""
    params = tree["params"] if "params" in tree else tree
    out: dict[str, np.ndarray] = {
        "embed_tokens.weight": np.asarray(params["embed_tokens"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    if "layers" in params:      # scan tree: [L, ...] leaves
        stacked = _layer(params["layers"]["layer"])
        per_layer = [{k: v[i] for k, v in stacked.items()}
                     for i in range(config.num_layers)]
    else:
        per_layer = [_layer(params[f"layers_{i}"])
                     for i in range(config.num_layers)]
    if config.scan_layers:
        for name in per_layer[0]:
            out[f"layers.{name}"] = np.stack([layer[name] for layer in per_layer])
    else:
        for i, layer in enumerate(per_layer):
            out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
