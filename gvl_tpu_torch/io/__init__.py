"""Host IO: video frame sources and ingestion ladders (the port's copy of
:mod:`gvl_tpu.io`)."""

from gvl_tpu_torch.io.video import (
    SyntheticVideo,
    Y4MReader,
    extract_frames,
    probe_video,
)
from gvl_tpu_torch.io.ingest import (
    decode_codec_video,
    download_youtube,
    is_youtube_url,
    resolve_video_source,
)

__all__ = [
    "Y4MReader",
    "SyntheticVideo",
    "extract_frames",
    "probe_video",
    "is_youtube_url",
    "download_youtube",
    "decode_codec_video",
    "resolve_video_source",
]
