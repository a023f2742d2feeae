"""gvl_tpu_torch stands alone: no JAX, no gvl_tpu, no library attention.

Also: entry points refuse to run without a card unless the CPU is asked
for, and chip_smoke.py fails (printing no result) without one.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "gvl_tpu_torch"
QA_CKPT = REPO / "outputs" / "qa_lm"

_BLOCKED_IMPORT = r"""
import importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "gvl_tpu", "PIL", "scripts", "benchmarks",
           "transformers")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import gvl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gvl_tpu_torch.__path__, "gvl_tpu_torch.")]
for name in names:
    __import__(name)
for name in ("gvl_tpu_torch.models.session", "gvl_tpu_torch.models.speculative",
             "gvl_tpu_torch.serving.batch_engine", "gvl_tpu_torch.serving.engine_server",
             "gvl_tpu_torch.serving.api", "gvl_tpu_torch.ops.quant_matmul",
             "gvl_tpu_torch.nn.quant", "gvl_tpu_torch.models.siglip",
             "gvl_tpu_torch.models.siglip_fused", "gvl_tpu_torch.runtime.resize",
             "gvl_tpu_torch.perception.semantic", "gvl_tpu_torch.training.retriever_train",
             "gvl_tpu_torch.agent.retriever", "gvl_tpu_torch.models.sam",
             "gvl_tpu_torch.perception.segmenter", "gvl_tpu_torch.perception.ocr_model",
             "gvl_tpu_torch.perception.ocr", "gvl_tpu_torch.audio.mel",
             "gvl_tpu_torch.audio.event_model", "gvl_tpu_torch.models.whisper",
             "gvl_tpu_torch.training.asr_train", "gvl_tpu_torch.audio.processor",
             "gvl_tpu_torch.runtime.wav", "gvl_tpu_torch.fusion", "gvl_tpu_torch.fusion.timeline",
             "gvl_tpu_torch.fusion.knowledge_base", "gvl_tpu_torch.fusion.schema",
             "gvl_tpu_torch.agent.conversation", "gvl_tpu_torch.agent.confidence",
             "gvl_tpu_torch.agent.tools", "gvl_tpu_torch.agent.trigger",
             "gvl_tpu_torch.agent.temporal_context", "gvl_tpu_torch.agent.loop",
             "gvl_tpu_torch.agent.core", "gvl_tpu_torch.models.projector",
             "gvl_tpu_torch.config", "gvl_tpu_torch.config.presets", "gvl_tpu_torch.io",
             "gvl_tpu_torch.io.video", "gvl_tpu_torch.io.ingest", "gvl_tpu_torch.runtime.y4m",
             "gvl_tpu_torch.training.segmenter_train", "gvl_tpu_torch.perception.batch",
             "gvl_tpu_torch.cache", "gvl_tpu_torch.cache.feature_cache",
             "gvl_tpu_torch.utils.profiler", "gvl_tpu_torch.pipeline", "gvl_tpu_torch.eval",
             "gvl_tpu_torch.eval.model_configs", "gvl_tpu_torch.eval.samples",
             "gvl_tpu_torch.eval.model_inference", "gvl_tpu_torch.entry",
             "gvl_tpu_torch.training.siglip_train", "gvl_tpu_torch.perception.frame_labeler",
             "gvl_tpu_torch.perception.open_vocab", "gvl_tpu_torch.models.videomae",
             "gvl_tpu_torch.training.videomae_train", "gvl_tpu_torch.temporal",
             "gvl_tpu_torch.temporal.clip_encoder", "gvl_tpu_torch.temporal.hico",
             "gvl_tpu_torch.temporal.context_manager", "gvl_tpu_torch.runtime.native",
             "gvl_tpu_torch.agent.search", "gvl_tpu_torch.parallel",
             "gvl_tpu_torch.parallel.pipeline", "gvl_tpu_torch.scripts",
             "gvl_tpu_torch.scripts.realtime_inference", "gvl_tpu_torch.scripts.deploy_api",
             "gvl_tpu_torch.models.qwen3vl", "gvl_tpu_torch.agent.special_tokens",
             "gvl_tpu_torch.eval.loaders", "gvl_tpu_torch.eval.loaders.base",
             "gvl_tpu_torch.eval.loaders.glitchbench", "gvl_tpu_torch.eval.loaders.physgame",
             "gvl_tpu_torch.eval.loaders.videogameqa", "gvl_tpu_torch.eval.loaders.longvideo",
             "gvl_tpu_torch.eval.metrics", "gvl_tpu_torch.eval.perception_cache",
             "gvl_tpu_torch.eval.phase_runner", "gvl_tpu_torch.eval.run_phase1",
             "gvl_tpu_torch.eval.run_phase2", "gvl_tpu_torch.eval.run_phase3",
             "gvl_tpu_torch.eval.eval_harness", "gvl_tpu_torch.scripts.smoke_test",
             "gvl_tpu_torch.scripts.extract_features",
             "gvl_tpu_torch.scripts.demo_projector_inference",
             "gvl_tpu_torch.scripts.run_phase_evidence",
             "gvl_tpu_torch.scripts.summarize_phase_results"):
    assert name in names, name
import chip_smoke
import launch_costs
import card_figures
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print(len(names), "modules")
"""


def test_package_and_chip_smoke_import_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 30


def _source_files():
    return [p for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh")
            and "_build" not in p.parts]


@pytest.mark.parametrize("needle", ["cpp_extension", "scaled_dot_product_attention",
                                    "torch.compile", "import jax", "from jax",
                                    "flax", "optax", "from gvl_tpu.",
                                    "import gvl_tpu.", "_int_mm", "import PIL",
                                    "from PIL"])
def test_forbidden_calls_absent_from_package(needle):
    """No file holds a needle.  PIL's two exceptions, each imported inside
    the function that needs it, as in the JAX package: the HUD text of
    synthetic clips (``SyntheticVideo._with_hud_text``, for a clip with
    ``text=``) and the still images of the single-frame runner
    (``BenchmarkModelRunner._load_frame``, for a sample with an image):
    those functions' own source is left out of the scan for the PIL
    needles."""
    lazy_pil = {PACKAGE / "io" / "video.py": "_with_hud_text",
                PACKAGE / "eval" / "model_inference.py": "_load_frame"}

    def text(path):
        source = path.read_text()
        if "PIL" in needle and path in lazy_pil:
            fn = next(node for node in ast.walk(ast.parse(source))
                      if isinstance(node, ast.FunctionDef) and node.name == lazy_pil[path])
            source = source.replace(ast.get_source_segment(source, fn), "")
        return source

    hits = [str(p.relative_to(REPO)) for p in _source_files() if needle in text(p)]
    assert not hits


def test_chip_smoke_uses_library_attention_only_as_yardstick():
    source = (REPO / "chip_smoke.py").read_text()
    assert "cpp_extension" not in source and "torch.compile" not in source
    tree = ast.parse(source)
    uses = []
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Attribute)
                        and node.attr == "scaled_dot_product_attention"):
                    uses.append(fn.name)
    assert uses and all(name.startswith("library_") for name in uses)
    int_mm = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
              for node in ast.walk(fn)
              if isinstance(node, ast.Attribute) and node.attr == "_int_mm"]
    assert int_mm and all(name.startswith("library_") for name in int_mm)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".")[0] in ("jax", "flax", "gvl_tpu") for m in mods)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.agent.core import create_qa_backend
    from gvl_tpu_torch.models.qwen3 import KVCache, Qwen3Config, Qwen3Engine, init_params
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.models.speculative import PromptLookupEngine, SpeculativeEngine
    from gvl_tpu_torch.serving import ContinuousBatchingEngine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm, load_qa_lm
    from gvl_tpu_torch.models.siglip import SigLIPVisionConfig, init_tower_params, load_tower
    from gvl_tpu_torch.perception.semantic import NaFlexConfig, SigLIPSemanticEncoder

    from gvl_tpu_torch.models.qwen3vl import Qwen3VL, Qwen3VLVisionConfig, init_vl_params

    cfg = Qwen3Config.tiny()
    state = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = [
        lambda: Qwen3VL(Qwen3VLVisionConfig.tiny(), cfg, {}),
        lambda: init_vl_params(Qwen3VLVisionConfig.tiny(), cfg, torch.Generator()),
        lambda: resolve_device(),
        lambda: create_qa_backend(QA_CKPT),
        lambda: load_qa_lm(QA_CKPT),
        lambda: Qwen3Engine(cfg, state),
        lambda: KVCache.zeros(cfg, 1),
        lambda: init_params(cfg, torch.Generator()),
        lambda: evaluate_qa_lm(state, cfg, n_samples=1),
        lambda: Qwen3ChatSession(cfg, state),
        lambda: SpeculativeEngine(cfg, state, cfg, state),
        lambda: PromptLookupEngine(cfg, state),
        lambda: ContinuousBatchingEngine(cfg, state),
        lambda: SigLIPSemanticEncoder.with_random_tower(NaFlexConfig(quant_fused=True)),
        lambda: init_tower_params(SigLIPVisionConfig.tiny(), torch.Generator()),
        lambda: load_tower(SigLIPVisionConfig.tiny(), {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Qwen3Engine(cfg, state, device="cpu").device.type == "cpu"


def test_arm_entry_points_raise_without_a_card(no_card, tmp_path):
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.core import ReasoningCore, create_reasoning_core
    from gvl_tpu_torch.agent.loop import PerceptionReasoningLoop
    from gvl_tpu_torch.audio.processor import build_audio_stack
    from gvl_tpu_torch.config import load_preset
    from gvl_tpu_torch.entry import entry
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
    from gvl_tpu_torch.models.projector import ProjectorBank
    from gvl_tpu_torch.perception.batch import build_segmenter
    from gvl_tpu_torch.perception.encoders import write_random_checkpoints
    from gvl_tpu_torch.pipeline import process_video
    from gvl_tpu_torch.serving.api import InferenceService

    arm = FullPipelineRunner(get_model_config("qa_lm"), device="cpu").preset
    calls = [
        lambda: process_video("synthetic://concept_demo_x?duration=2", arm, use_cache=False),
        lambda: build_segmenter(arm),
        lambda: build_audio_stack(arm.audio),
        lambda: ProjectorBank(),
        lambda: ReasoningCore(),
        lambda: create_reasoning_core(checkpoint_path=str(QA_CKPT)),
        lambda: create_reasoning_core(checkpoint_path=str(tmp_path)),
        lambda: create_reasoning_core(vl_checkpoint_path=str(tmp_path)),
        lambda: PerceptionReasoningLoop(),
        lambda: FullPipelineRunner(get_model_config("qa_lm")),
        lambda: InferenceService(arm).process("synthetic://concept_demo_x?duration=2"),
        lambda: entry(),
        lambda: write_random_checkpoints(tmp_path),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert load_preset("light").perception.use_sam is False
    assert ReasoningCore(ReasoningCoreConfig(embedding_model="hashing"),
                         device="cpu").backend is not None


def test_perception_entry_points_raise_without_a_card(no_card):
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.retriever import TimelineRetriever, make_embedder
    from gvl_tpu_torch.audio.event_model import (
        TorchAudioEventDetector,
        TrainedAudioEmbedder,
        load_event_params,
    )
    from gvl_tpu_torch.audio.processor import create_audio_processor
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig
    from gvl_tpu_torch.models.whisper import WhisperConfig, load_whisper
    from gvl_tpu_torch.nn.layers import init_state, load_module
    from gvl_tpu_torch.perception.ocr import OCRConfig, OCRPipeline, create_ocr_pipeline
    from gvl_tpu_torch.perception.ocr_model import TorchOCREngine
    from gvl_tpu_torch.perception.segmenter import (
        SAMConfig,
        TorchSegmenterBackend,
        create_sam_segmenter,
    )
    from gvl_tpu_torch.training.asr_train import TrainedByteASR
    from gvl_tpu_torch.training.retriever_train import TrainedTextEmbedder

    outputs = REPO / "outputs"
    events = load_event_params(outputs / "audio_event_params.npz")
    with torch.device("meta"):
        tiny_sam = PromptableSegmenter(SamConfig.tiny())
    calls = [
        lambda: TrainedTextEmbedder.from_dir(outputs / "retriever"),
        lambda: make_embedder(ReasoningCoreConfig()),
        lambda: TimelineRetriever(ReasoningCoreConfig()),
        lambda: TorchSegmenterBackend(SAMConfig()),
        lambda: create_sam_segmenter(use_model=True),
        lambda: create_sam_segmenter(checkpoint=str(outputs / "sam_params.npz")),
        lambda: TorchOCREngine(),
        lambda: create_ocr_pipeline("native"),
        lambda: OCRPipeline(OCRConfig(backend="jax")),
        lambda: TorchAudioEventDetector(events),
        lambda: TrainedAudioEmbedder(events),
        lambda: TrainedByteASR.from_dir(outputs / "asr"),
        lambda: load_whisper(WhisperConfig.tiny_random(), {}),
        lambda: create_audio_processor(asr_checkpoint=str(outputs / "asr")),
        lambda: create_audio_processor(event_checkpoint=str(outputs / "audio_event_params.npz")),
        lambda: init_state(tiny_sam, torch.Generator()),
        lambda: load_module(tiny_sam, {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert TorchOCREngine(device="cpu").device.type == "cpu"


def test_siglip_and_temporal_entry_points_raise_without_a_card(no_card):
    from gvl_tpu_torch.config import load_preset
    from gvl_tpu_torch.perception.batch import build_siglip_encoder
    from gvl_tpu_torch.perception.frame_labeler import MiniSigLIPFrameLabeler
    from gvl_tpu_torch.perception.open_vocab import LexiconPromptResolver, OpenVocabSamBackend
    from gvl_tpu_torch.perception.semantic import SigLIPSemanticEncoder
    from gvl_tpu_torch.temporal.clip_encoder import build_clip_encoder
    from gvl_tpu_torch.temporal.hico import TemporalCompressionModule, create_hico_module
    from gvl_tpu_torch.training.siglip_train import load_minisiglip
    from gvl_tpu_torch.training.videomae_train import TrainedClipEncoder, load_clip_encoder

    outputs = REPO / "outputs"
    light = load_preset("light")
    calls = [
        lambda: load_minisiglip(outputs / "minisiglip"),
        lambda: SigLIPSemanticEncoder.from_trained_checkpoint(str(outputs / "minisiglip")),
        lambda: MiniSigLIPFrameLabeler(str(outputs / "minisiglip")),
        lambda: build_siglip_encoder(light),
        lambda: OpenVocabSamBackend.from_trained_checkpoints(
            str(outputs / "sam_params.npz"), str(outputs / "minisiglip")),
        lambda: LexiconPromptResolver.from_trained(str(outputs / "retriever")),
        lambda: load_clip_encoder(outputs / "videomae"),
        lambda: TrainedClipEncoder.from_dir(outputs / "videomae"),
        lambda: build_clip_encoder(light),
        lambda: TemporalCompressionModule(),
        lambda: create_hico_module(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_every_kernel_wrapper_counts_launches_beside_a_plain_version():
    from gvl_tpu_torch.ops import attention, cache_update, decode_attention, quant_matmul

    for module, kernel, plain in [
        (attention, "flash_attention", "attention_reference"),
        (decode_attention, "decode_attention", "decode_attention_reference"),
        (cache_update, "cache_append", "cache_append_reference"),
        (decode_attention, "decode_attention_stacked",
         "decode_attention_stacked_reference"),
        (decode_attention, "chunk_attention", "chunk_attention_reference"),
        (cache_update, "cache_append_stacked", "cache_append_stacked_reference"),
        (quant_matmul, "w8a8_matmul", "w8a8_matmul_reference"),
        (quant_matmul, "ln_quant", "ln_quant_reference"),
        (quant_matmul, "quant_static", "quant_static_reference"),
        (quant_matmul, "attention_fused_qkv", "attention_fused_qkv_reference"),
        (quant_matmul, "attention_packed_multihead",
         "attention_packed_multihead_reference"),
        (quant_matmul, "attention_qkv_packed", "attention_qkv_packed_reference"),
    ]:
        assert isinstance(getattr(module, kernel).launches, int)
        assert callable(getattr(module, plain))


def _run_chip_smoke(cwd, env_extra):
    env = {**os.environ, **env_extra}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_chip_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "gvl_tpu_torch" in proc.stderr and '"ok"' not in proc.stdout


def test_card_figures_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "card_figures.py", "qa"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"device"' not in proc.stdout


def test_launch_costs_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "launch_costs.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"launch"' not in proc.stdout
