"""The sample schema and the synthetic samples under their earlier names:
:mod:`gvl_tpu_torch.eval.loaders.base` holds them."""

from gvl_tpu_torch.eval.loaders.base import (  # noqa: F401
    AnswerFormat,
    BenchmarkSample,
    SyntheticLoader,
    TaskType,
)
