"""gvl_tpu_torch offers all of gvl_tpu's public surface, checked from the
source alone (``ast``; neither package is imported).

The surface of ``gvl_tpu/``: every public module-level name (functions,
classes, assigned names; not a module's ``logging.getLogger`` handle),
every public method of a public class, and every entry of a package's
``__all__``.  Each needs its counterpart in ``gvl_tpu_torch/`` at the same
module path (defined, imported, or listed in ``__all__``; a class's method
may come from a base class of the same module), or an entry in one of two
tables:

- :data:`RENAMED`: the JAX name → the port's name, in the same module
  unless the value says ``module:name``.  A renamed class carries its
  methods to the new name.
- :data:`JAX_ONLY`: the JAX name → why the port has no counterpart.

A table entry that names nothing in ``gvl_tpu/``, a rename whose target is
missing, or a ``JAX_ONLY`` name the port does have, fails
:func:`test_tables_name_what_exists`: a stale table hides no gap.
"""

import ast
import functools
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "gvl_tpu", REPO / "gvl_tpu_torch"

_FLAX_SETUP = "a Flax module's setup(); torch builds submodules in __init__"
_TPU_TILE = "a TPU tile size of the Pallas kernels; the CUDA kernels choose their own tiles"
_GSPMD = ("a GSPMD placement of a whole pytree; the port shards a state dict per tensor "
          "(parallel/sharding.py shard_tensor, state_specs)")

RENAMED = {
    "audio/__init__:JaxAudioEventDetector": "TorchAudioEventDetector",
    "audio/__init__:Wav2Vec2JaxEmbedder": "Wav2Vec2TorchEmbedder",
    "audio/event_model:JaxAudioEventDetector": "TorchAudioEventDetector",
    "audio/processor:Wav2Vec2JaxEmbedder": "Wav2Vec2TorchEmbedder",
    "audio/processor:WhisperJaxASR": "WhisperTorchASR",
    "perception/ocr_model:JaxOCREngine": "TorchOCREngine",
    "perception/segmenter:JaxSegmenterBackend": "TorchSegmenterBackend",
    "perception/semantic:JaxSigLIPBackend": "TorchSigLIPBackend",
    "temporal/clip_encoder:JaxVideoMAEClipEncoder": "TorchVideoMAEClipEncoder",
    # Flax's int8 and LoRA projections are one Linear (quant=..., lora_rank=...)
    "models/qwen3:Int8Dense": "Linear",
    "models/qwen3:LoRADense": "Linear",
    # the functional SAM ViT over a parameter tree -> modules
    "models/sam_vit:vision_encoder": "SamVisionEncoder",
    "models/sam_vit:image_wide_pe": "SamPromptEncoder.image_wide_pe",
    "models/sam_vit:embed_points": "SamPromptEncoder.embed_points",
    "models/sam_vit:embed_boxes": "SamPromptEncoder.embed_boxes",
    "models/sam_vit:mask_decoder": "SamMaskDecoder",
    # each Pallas call -> the wrapper that launches its CUDA kernel
    "ops/quant_matmul:w8a8_matmul_pallas": "w8a8_matmul",
    "ops/quant_matmul:ln_quant_pallas": "ln_quant",
    "ops/quant_matmul:quant_static_pallas": "quant_static",
    "ops/quant_matmul:attention_fused_qkv_pallas": "attention_fused_qkv",
    "ops/quant_matmul:attention_packed_multihead_pallas": "attention_packed_multihead",
    "ops/quant_matmul:attention_qkv_packed_pallas": "attention_qkv_packed",
    # the HiCo trainer sits beside its model, as the OCR and audio-event
    # trainers do in both packages
    "training/hico_train:HicoTrainConfig": "temporal/hico:HicoTrainConfig",
    "training/hico_train:make_sequences": "temporal/hico:make_sequences",
    "training/hico_train:train_hico": "temporal/hico:train_hico",
    "training/hico_train:evaluate_hico": "temporal/hico:evaluate_hico",
}

JAX_ONLY = {
    "models/qwen3:Qwen3Model.setup": _FLAX_SETUP,
    "models/sam:PromptableSegmenter.setup": _FLAX_SETUP,
    "models/whisper:WhisperDecoder.setup": _FLAX_SETUP,
    "models/whisper:WhisperModel.setup": _FLAX_SETUP,
    "temporal/hico:HierarchicalCompressor.setup": _FLAX_SETUP,
    "training/siglip_train:MiniSigLIP.setup": _FLAX_SETUP,
    "models/siglip_fused:BLOCKS": _TPU_TILE,
    "ops/attention:DEFAULT_BLOCK_Q": _TPU_TILE,
    "ops/attention:DEFAULT_BLOCK_K": _TPU_TILE,
    "ops/attention:LANE": _TPU_TILE,
    "ops/cache_update:LANE": _TPU_TILE,
    "ops/cache_update:SUBLANE": _TPU_TILE,
    "ops/decode_attention:DEFAULT_BLOCK_K": _TPU_TILE,
    "ops/decode_attention:LANE": _TPU_TILE,
    "parallel/mesh:MeshManager.activate": "enters a jax.sharding.Mesh context; a torch "
                                          "process group needs none",
    "parallel/mesh:MeshManager.data_sharding": _GSPMD,
    "parallel/mesh:MeshManager.replicated_sharding": _GSPMD,
    "parallel/sharding:named_sharding": _GSPMD,
    "parallel/sharding:shard_pytree": _GSPMD,
    "parallel/__init__:named_sharding": _GSPMD,
    "parallel/__init__:shard_pytree": _GSPMD,
    "utils/jax_setup:setup_jax": "sets up JAX's platform and compilation cache",
    "utils/__init__:setup_jax": "sets up JAX's platform and compilation cache",
    "utils/torch_io:safe_torch_load": "torch.load(weights_only=True), which the port "
                                      "calls directly",
}


@functools.lru_cache(maxsize=None)
def _modules(root: Path) -> dict[str, ast.Module]:
    return {p.relative_to(root).with_suffix("").as_posix(): ast.parse(p.read_text())
            for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts and "_build" not in p.parts}


def _is_logger(node: ast.Assign) -> bool:
    call = node.value
    return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "getLogger")


def _all_entries(tree: ast.Module) -> list[str]:
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)):
            return [e.value for e in node.value.elts]
    return []


def _defined(tree: ast.Module) -> dict[str, ast.AST]:
    """Top-level names bound by a def, a class or an assignment."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign) and not _is_logger(node):
            out.update({t.id: node for t in node.targets if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def jax_surface() -> set[str]:
    """``module:name`` and ``module:Class.method`` of every public name."""
    out = set()
    for module, tree in _modules(JAX_ROOT).items():
        for name, node in _defined(tree).items():
            if name.startswith("_"):
                continue
            out.add(f"{module}:{name}")
            if isinstance(node, ast.ClassDef):
                out.update(f"{module}:{name}.{item.name}" for item in node.body
                           if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and not item.name.startswith("_"))
        out.update(f"{module}:{name}" for name in _all_entries(tree))
    return out


def _members(node: ast.ClassDef, classes: dict[str, ast.ClassDef], seen=()) -> set[str]:
    """Methods and class attributes of ``node`` and of its bases defined in
    the same module."""
    out = set()
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(item.name)
        elif isinstance(item, ast.Assign):
            out.update(t.id for t in item.targets if isinstance(t, ast.Name))
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            out.add(item.target.id)
    for base in node.bases:
        if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
            out |= _members(classes[base.id], classes, seen + (node.name,))
    return out


def port_surface() -> set[str]:
    """``module:name`` and ``module:Class.member`` of everything the port's
    modules bind, import or list in ``__all__`` (private names included:
    presence is what counts)."""
    out = set()
    for module, tree in _modules(PORT_ROOT).items():
        defined = _defined(tree)
        classes = {n: c for n, c in defined.items() if isinstance(c, ast.ClassDef)}
        out.update(f"{module}:{name}" for name in defined)
        out.update(f"{module}:{name}" for name in _all_entries(tree))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update(f"{module}:{(a.asname or a.name).split('.')[0]}" for a in node.names)
        for name, node in classes.items():
            out.update(f"{module}:{name}.{member}" for member in _members(node, classes))
    return out


def counterpart(key: str) -> str:
    """The port's ``module:name`` that ``key`` (a JAX ``module:name``) maps
    to: through :data:`RENAMED`, a renamed class carrying its methods."""
    module, name = key.split(":")
    if key in RENAMED:
        target = RENAMED[key]
        return target if ":" in target else f"{module}:{target}"
    cls, _, method = name.partition(".")
    if method and f"{module}:{cls}" in RENAMED:
        return f"{counterpart(f'{module}:{cls}')}.{method}"
    return key


def gaps(jax: set[str], port: set[str]) -> list[str]:
    """JAX names with no counterpart and no JAX_ONLY entry."""
    return sorted(key for key in jax - JAX_ONLY.keys() if counterpart(key) not in port)


def stale(jax: set[str], port: set[str]) -> list[str]:
    """Table entries that name nothing in gvl_tpu, renames whose target is
    not in the port, and JAX_ONLY names that the port does have."""
    return sorted([key for key in {**RENAMED, **JAX_ONLY} if key not in jax]
                  + [key for key in RENAMED if counterpart(key) not in port]
                  + [key for key in JAX_ONLY if key in port])


@pytest.fixture(scope="module")
def surfaces():
    return jax_surface(), port_surface()


def test_every_public_name_of_gvl_tpu_has_a_counterpart(surfaces):
    jax, port = surfaces
    assert len(jax) > 1000
    missing = gaps(jax, port)
    assert not missing, (f"{len(missing)} public names of gvl_tpu have no counterpart in "
                         f"gvl_tpu_torch and no RENAMED or JAX_ONLY entry: {missing}")


def test_tables_name_what_exists(surfaces):
    jax, port = surfaces
    assert not set(RENAMED) & set(JAX_ONLY)
    assert all(reason.strip() for reason in JAX_ONLY.values())
    assert not stale(jax, port)


def test_subpackages_export_their_counterparts():
    """Every name in a JAX package's ``__all__`` is in the port package's
    ``__all__`` (renamed where the port renamed it)."""
    modules = _modules(PORT_ROOT)
    for module, tree in _modules(JAX_ROOT).items():
        for name in _all_entries(tree):
            key = f"{module}:{name}"
            if key in JAX_ONLY:
                continue
            got_module, got = counterpart(key).split(":")
            assert got in _all_entries(modules[got_module]), key


@pytest.mark.parametrize("change", ["removed", "renamed-away", "stale-rename",
                                    "stale-jax-only", "ported-jax-only"])
def test_the_checks_see_a_gap_or_a_stale_entry(surfaces, monkeypatch, change):
    """Each way the port and the tables can drift apart is caught."""
    jax, port = surfaces
    if change == "removed":
        assert gaps(jax, port - {"perception/ocr:TesseractOCR"}) == [
            "perception/ocr:TesseractOCR"]
    elif change == "renamed-away":
        assert "perception/ocr_model:JaxOCREngine.batch" in gaps(
            jax, port - {"perception/ocr_model:TorchOCREngine.batch"})
    elif change == "stale-rename":
        monkeypatch.setitem(RENAMED, "perception/ocr:NoSuchEngine", "TesseractOCR")
        assert stale(jax, port) == ["perception/ocr:NoSuchEngine"]
    elif change == "stale-jax-only":
        monkeypatch.setitem(JAX_ONLY, "ops/attention:NO_SUCH_TILE", "a tile")
        assert stale(jax, port) == ["ops/attention:NO_SUCH_TILE"]
    else:
        monkeypatch.setitem(JAX_ONLY, "perception/ocr:TesseractOCR", "not needed")
        assert stale(jax, port) == ["perception/ocr:TesseractOCR"]
