"""Rule-based partition specs (the port's copy of
:mod:`gvl_tpu.parallel.sharding`).

The rules are JAX's, regexes verbatim, matched against the ``/``-joined
paths of the JAX package's parameter tree (the flat-npz keys).  A spec is
a tuple of axis names or None per dimension (no ``PartitionSpec``).
:func:`shard_state` cuts a port state dict for one rank: each tensor's name
maps to its JAX path (:func:`tree_path`), the spec is taken on the JAX
shape (Flax kernels are ``[in, out]``, the port's weights ``[out, in]``)
and the sharded axis is carried over to the port's layout.  A JAX tree
placed by ``shard_pytree`` and this function give rank ``(d, m)`` the
same numbers.

Column-parallel kernels (qkv, MLP up/gate) shard their *output* feature
dim over ``model``; row-parallel kernels (attention out, MLP down) shard
their *input* dim, so each boundary needs exactly one collective, which
:mod:`gvl_tpu_torch.models.qwen3` calls.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Optional, Sequence

import torch

from gvl_tpu_torch.parallel.mesh import MODEL_AXIS, as_mesh

logger = logging.getLogger(__name__)

Spec = tuple


class ShardingRules:
    """Ordered (regex, spec) rules; first match wins.

    >>> rules = ShardingRules([
    ...     (r"attention/(q|k|v)_proj/kernel", (None, "model")),
    ...     (r"attention/o_proj/kernel",       ("model", None)),
    ...     (r".*",                            ()),
    ... ])
    """

    def __init__(self, rules: Sequence[tuple[str, Spec]]):
        self.rules = [(re.compile(pattern), tuple(spec)) for pattern, spec in rules]

    def spec(self, path: str) -> Spec:
        for pattern, spec in self.rules:
            if pattern.search(path):
                return spec
        return ()

    def __add__(self, other: "ShardingRules") -> "ShardingRules":
        merged = ShardingRules([])
        merged.rules = self.rules + other.rules
        return merged


# Default layout for the decoder-only reasoning core (Qwen3-class) and the
# ViT-family encoders.  Dense kernels are [in, out].
LLM_RULES = ShardingRules([
    # token embedding: shard the hidden dim (all-gather activations once)
    (r"embed_tokens/embedding$", (None, "model")),
    (r"lm_head/kernel(_q)?$", (None, "model")),
    (r"lm_head/scale$", ("model",)),
    # attention projections (plain Dense, LoRADense "base", or the
    # int8 "base/kernel_q" weight-only layout — scales follow the
    # output dim of their kernel)
    (r"(self_)?att(ention|n)?/(q|k|v)_proj/(base/)?kernel(_q)?$",
     (None, "model")),
    (r"(self_)?att(ention|n)?/(q|k|v)_proj/base/scale$", ("model",)),
    (r"(self_)?att(ention|n)?/o_proj/(base/)?kernel(_q)?$",
     ("model", None)),
    (r"(self_)?att(ention|n)?/o_proj/base/scale$", ()),
    # MLP
    (r"mlp/(gate|up)_proj/(base/)?kernel(_q)?$", (None, "model")),
    (r"mlp/(gate|up)_proj/base/scale$", ("model",)),
    (r"mlp/down_proj/(base/)?kernel(_q)?$", ("model", None)),
    (r"mlp/down_proj/base/scale$", ()),
    # LoRA: B follows the column-parallel output dim; A of row-parallel
    # layers shards its input dim; everything else replicated
    (r"(q|k|v|gate|up)_proj/lora_b$", (None, "model")),
    (r"(o|down)_proj/lora_a$", ("model", None)),
    # biases on column-parallel layers follow their kernel's output dim
    (r"(q|k|v|gate|up)_proj/(base/)?bias$", ("model",)),
    # everything else (norms, row-parallel biases, remaining lora) replicated
    (r".*", ()),
])

VIT_RULES = ShardingRules([
    (r"att(ention|n)?/(q|k|v)_proj/kernel$", (None, "model")),
    (r"att(ention|n)?/o_proj/kernel$", ("model", None)),
    (r"mlp/(fc1|up_proj|gate_proj)/kernel$", (None, "model")),
    (r"mlp/(fc2|down_proj)/kernel$", ("model", None)),
    (r".*", ()),
])


def spec_for_path(path: str, rules: ShardingRules) -> Spec:
    return rules.spec(path)


def tree_paths(tree: Any, prefix: str = "") -> list[str]:
    """``/``-joined leaf paths of a nested dict (or list) in key order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    out = []
    for key, value in items:
        out.extend(tree_paths(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _sanitize_spec(spec: Spec, shape: tuple, mesh_shape: dict) -> Spec:
    """Fit a spec to the leaf: right-align (extra leading dims — e.g. a
    scan-stacked layer axis — stay replicated), trim to rank, and drop
    axes that don't divide the dimension."""
    axes = list(spec)
    if len(shape) > len(axes):
        axes = [None] * (len(shape) - len(axes)) + axes
    axes = axes[: len(shape)]
    out = []
    for dim, ax in enumerate(axes):
        if ax is None:
            out.append(None)
            continue
        size = mesh_shape[ax] if isinstance(ax, str) else 1
        if dim < len(shape) and shape[dim] % size == 0:
            out.append(ax)
        else:
            logger.debug(
                "dropping axis %s on dim %d (shape %s not divisible)",
                ax, dim, shape,
            )
            out.append(None)
    while out and out[-1] is None:  # canonical form: no trailing Nones
        out.pop()
    return tuple(out)


def sharding_tree(shapes: dict[str, tuple], mesh_shape: dict,
                  rules: ShardingRules) -> dict[str, Spec]:
    """``{path: spec}`` for ``{path: shape}`` (JAX's ``sharding_tree`` on a
    flat tree)."""
    return {path: _sanitize_spec(rules.spec(path), tuple(shape), mesh_shape)
            for path, shape in shapes.items()}


# --------------------------------------------------------------------------
# the port's Qwen3 state dict against the JAX tree's paths
# --------------------------------------------------------------------------

_LEAVES = {"input_norm.weight": "input_norm/scale",
           "post_attn_norm.weight": "post_attn_norm/scale",
           "self_attn.q_norm.weight": "self_attn/q_norm/scale",
           "self_attn.k_norm.weight": "self_attn/k_norm/scale"}


def tree_path(name: str, scan_layers: bool = False) -> tuple[str, bool]:
    """A port Qwen3 state-dict name → (the JAX tree's path, whether the
    port's tensor is the JAX leaf with its last two axes swapped).

    ``layers.3.self_attn.q_proj.weight`` → ``layers_3/self_attn/q_proj/
    base/kernel`` (swapped); a stacked ``layers.mlp.up_proj.weight_q`` →
    ``layers/layer/mlp/up_proj/base/kernel_q``; ``lm_head.scale`` →
    ``lm_head/scale``."""
    if name == "embed_tokens.weight":
        return "embed_tokens/embedding", False
    if name == "final_norm.weight":
        return "final_norm/scale", False
    if name.startswith("lm_head."):
        leaf = name.split(".", 1)[1]
        return {"weight": ("lm_head/kernel", True), "weight_q": ("lm_head/kernel_q", True),
                "scale": ("lm_head/scale", False)}[leaf]
    parts = name.split(".")
    if scan_layers:
        prefix, rest = "layers/layer", ".".join(parts[1:])
    else:
        prefix, rest = f"layers_{parts[1]}", ".".join(parts[2:])
    if rest in _LEAVES:
        return f"{prefix}/{_LEAVES[rest]}", False
    module, leaf = rest.rsplit(".", 1)
    module = module.replace(".", "/")
    if leaf in ("lora_a", "lora_b"):
        return f"{prefix}/{module}/{leaf}", False
    kernel = {"weight": "base/kernel", "weight_q": "base/kernel_q", "scale": "base/scale"}
    return f"{prefix}/{module}/{kernel[leaf]}", leaf != "scale"


def tree_shape(shape: tuple, swapped: bool) -> tuple:
    shape = tuple(shape)
    return shape[:-2] + (shape[-1], shape[-2]) if swapped else shape


def port_axis(jax_axis: int, ndim: int, swapped: bool) -> int:
    """The port tensor's axis holding the JAX leaf's axis ``jax_axis``."""
    if swapped and jax_axis >= ndim - 2:
        return 2 * ndim - 3 - jax_axis
    return jax_axis


def tp_replicated(name: str, config, model_size: int) -> bool:
    """Whether the Qwen3 model keeps this tensor whole on every rank
    whatever its rule says: a layer's attention (q/k/v/o and its norms)
    when the KV heads do not divide over ``model`` (JAX's cache rule,
    ``Qwen3Engine._cache_sharding``), its MLP when the intermediate size
    does not (``models.qwen3.tp_cuts``)."""
    from gvl_tpu_torch.models.qwen3 import tp_cuts

    if model_size == 1:
        return True
    cuts = tp_cuts(config, model_size)
    if ".self_attn." in f".{name}":
        return not cuts["attention"]
    if ".mlp." in f".{name}":
        return not cuts["mlp"]
    return False


def state_specs(state: dict[str, torch.Tensor], config, mesh_shape: dict,
                rules: ShardingRules = None) -> dict[str, tuple[Spec, bool]]:
    """``{name: (spec on the JAX shape, swapped)}`` for a Qwen3 state dict
    (full shapes), with :func:`tp_replicated`'s layers kept whole."""
    rules = rules or LLM_RULES
    out = {}
    for name, t in state.items():
        path, swapped = tree_path(name, config.scan_layers)
        spec = _sanitize_spec(rules.spec(path), tree_shape(t.shape, swapped), mesh_shape)
        if tp_replicated(name, config, mesh_shape[MODEL_AXIS]):
            spec = ()
        out[name] = (spec, swapped)
    return out


def shard_tensor(t: torch.Tensor, spec: Spec, swapped: bool, mesh_shape: dict,
                 coords: tuple[int, int]) -> torch.Tensor:
    """Rank ``coords``'s block of ``t`` (a view) under ``spec`` (taken on
    the JAX shape; ``swapped``: ``t`` is that leaf transposed)."""
    index = {"data": coords[0], "model": coords[1]}
    full = list(spec) + [None] * (t.dim() - len(spec))
    for jax_axis, ax in enumerate(full):
        if ax is None:
            continue
        axis = port_axis(jax_axis, t.dim(), swapped)
        size = t.shape[axis] // mesh_shape[ax]
        t = t.narrow(axis, index[ax] * size, size)
    return t


def shard_state(state: dict[str, torch.Tensor], mesh, config,
                rules: ShardingRules = None,
                coords: Optional[tuple[int, int]] = None,
                mesh_shape: Optional[dict] = None) -> dict[str, torch.Tensor]:
    """This rank's slices of a full Qwen3 state dict (copies; a tensor
    kept whole is the same tensor).  ``coords`` and ``mesh_shape`` name
    another rank of a mesh without a world (``mesh`` may then be None).
    A tensor already cut to this rank's shape is kept as it is."""
    mesh = as_mesh(mesh)
    mesh_shape = mesh_shape or mesh.shape
    coords = coords if coords is not None else mesh.coords
    with torch.device("meta"):
        from gvl_tpu_torch.models.qwen3 import Qwen3Model

        full = {k: v.shape for k, v in Qwen3Model(config).state_dict().items()}
    specs = state_specs({k: torch.empty(full.get(k, v.shape), device="meta")
                         for k, v in state.items()}, config, mesh_shape, rules)
    out = {}
    for name, t in state.items():
        spec, swapped = specs[name]
        if name in full and tuple(t.shape) != tuple(full[name]):
            out[name] = t            # already this rank's block
            continue
        # a copy where cut, so that the full tensor can be freed
        out[name] = shard_tensor(t, spec, swapped, mesh_shape, coords).clone() if spec else t
    return out


def partial_over_model(name: str, model) -> bool:
    """Whether a whole (uncut) parameter of a tensor-parallel Qwen3 model
    takes only this rank's part of its gradient: it is used inside a cut
    region (a cut attention's q/k norms, the whole ``lora_a`` of a
    column-parallel projection or ``lora_b`` of a row-parallel one)."""
    tp = model.tp
    if tp.group is None:
        return False
    leaf = name.rsplit(".", 2)
    if ".self_attn." in f".{name}" and tp.attention:
        return (leaf[-2] in ("q_norm", "k_norm")
                or (leaf[-1] == "lora_a" and leaf[-2] in ("q_proj", "k_proj", "v_proj"))
                or (leaf[-1] == "lora_b" and leaf[-2] == "o_proj"))
    if ".mlp." in f".{name}" and tp.mlp:
        return ((leaf[-1] == "lora_a" and leaf[-2] in ("gate_proj", "up_proj"))
                or (leaf[-1] == "lora_b" and leaf[-2] == "down_proj"))
    return False


def reduce_gradients(model, mesh) -> None:
    """Make each parameter's gradient whole after a data-parallel x
    tensor-parallel backward: summed over ``model`` where the rank holds
    only its part (:func:`partial_over_model`), then over ``data`` (each
    replica's loss must be its share of the global mean)."""
    from gvl_tpu_torch.parallel.collectives import all_reduce_sum

    mesh = as_mesh(mesh)
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        grad = p.grad
        if partial_over_model(name, model):
            grad = all_reduce_sum(grad, mesh.model_group)
        p.grad = all_reduce_sum(grad, mesh.data_group)
