"""Benchmark data loaders in the unified sample schema (the port's copy of
``benchmarks/loaders``): local files only, with the synthetic fallback."""

from gvl_tpu_torch.eval.loaders.base import (
    AnswerFormat,
    BenchmarkConfig,
    BenchmarkLoader,
    BenchmarkSample,
    SyntheticLoader,
    TaskType,
)
from gvl_tpu_torch.eval.loaders.glitchbench import GlitchBenchLoader, create_glitchbench_loader
from gvl_tpu_torch.eval.loaders.physgame import PhysGameLoader, create_physgame_loader
from gvl_tpu_torch.eval.loaders.videogameqa import (
    VideoGameQALoader,
    create_videogameqa_loader,
)
from gvl_tpu_torch.eval.loaders.longvideo import (
    LongVideoBenchLoader,
    MLVULoader,
    create_longvideobench_loader,
    create_mlvu_loader,
)

__all__ = [
    "TaskType",
    "AnswerFormat",
    "BenchmarkSample",
    "BenchmarkConfig",
    "BenchmarkLoader",
    "SyntheticLoader",
    "GlitchBenchLoader",
    "create_glitchbench_loader",
    "PhysGameLoader",
    "create_physgame_loader",
    "VideoGameQALoader",
    "create_videogameqa_loader",
    "LongVideoBenchLoader",
    "create_longvideobench_loader",
    "MLVULoader",
    "create_mlvu_loader",
]
