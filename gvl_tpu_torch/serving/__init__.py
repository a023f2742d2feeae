"""HTTP serving of the port's Qwen3 models: continuous batching, its
threaded front-end and the stdlib HTTP API (counterpart of
:mod:`gvl_tpu.serving`)."""

from gvl_tpu_torch.serving.api import InferenceService, create_server, serve
from gvl_tpu_torch.serving.batch_engine import ContinuousBatchingEngine
from gvl_tpu_torch.serving.engine_server import EngineServer

__all__ = [
    "InferenceService",
    "create_server",
    "serve",
    "ContinuousBatchingEngine",
    "EngineServer",
]
