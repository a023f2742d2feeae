"""Whole-video perception-feature cache (the port's copy of
:mod:`gvl_tpu.cache`)."""

from gvl_tpu_torch.cache.feature_cache import FeatureCache, video_content_hash

__all__ = ["FeatureCache", "video_content_hash"]
