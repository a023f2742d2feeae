"""Shared utilities: stage profiling, checkpoint IO (counterpart of
:mod:`gvl_tpu.utils`; JAX's ``setup_jax`` has nothing to port)."""

from gvl_tpu_torch.utils.profiler import StageTimer, stage_scope

__all__ = ["StageTimer", "stage_scope"]
