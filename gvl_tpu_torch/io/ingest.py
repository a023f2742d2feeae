"""Video ingestion: YouTube download and codec-video decode ladders (the
port's copy of :mod:`gvl_tpu.io.ingest`).

The preferred decode route for codec video (mp4/mkv/webm) is an ffmpeg ->
yuv4mpeg pipe into the y4m reader (one subprocess decodes and
rate-subsamples), with cv2/imageio fallbacks.  Every external tool is
probed, never required: without yt-dlp or ffmpeg these rungs raise with
an actionable message.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_YOUTUBE_RE = re.compile(
    r"^(https?://)?(www\.|m\.|music\.)?"
    r"(youtube\.com/(watch\?|shorts/|live/|embed/)|youtu\.be/)",
    re.IGNORECASE,
)


def is_youtube_url(url: str) -> bool:
    """True for watch/shorts/live/embed/youtu.be URLs."""
    return bool(_YOUTUBE_RE.match(url.strip()))


def have_ytdlp() -> bool:
    if shutil.which("yt-dlp"):
        return True
    try:
        import yt_dlp  # noqa: F401
        return True
    except ImportError:
        return False


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def download_youtube(url: str, output_dir: str | Path = "downloads") -> Path:
    """Download a YouTube video as H.264 mp4.  Raises RuntimeError with an
    actionable message when yt-dlp is unavailable."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    template = str(output_dir / "%(id)s.%(ext)s")
    # H.264 forced so every downstream decoder copes
    fmt = "bestvideo[vcodec^=avc1][height<=1080]+bestaudio/best[ext=mp4]/best"

    if shutil.which("yt-dlp"):
        cmd = ["yt-dlp", "-f", fmt, "--merge-output-format", "mp4",
               "-o", template, "--no-playlist", "--print",
               "after_move:filepath", url]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"yt-dlp failed: {proc.stderr[-500:]}")
        path = Path(proc.stdout.strip().splitlines()[-1])
        logger.info("downloaded %s -> %s", url, path)
        return path

    try:
        import yt_dlp
    except ImportError as exc:
        raise RuntimeError(
            "YouTube ingestion needs yt-dlp (pip install yt-dlp or the "
            "standalone binary on PATH)"
        ) from exc
    opts = {"format": fmt, "outtmpl": template, "noplaylist": True,
            "merge_output_format": "mp4"}
    with yt_dlp.YoutubeDL(opts) as ydl:
        info = ydl.extract_info(url, download=True)
        path = Path(ydl.prepare_filename(info)).with_suffix(".mp4")
        if not path.exists():  # merge may keep the original ext
            path = Path(ydl.prepare_filename(info))
    logger.info("downloaded %s -> %s", url, path)
    return path


def ffmpeg_to_y4m(
    video_path: str | Path,
    fps: Optional[float] = None,
    out_path: Optional[Path] = None,
) -> Path:
    """Transcode any codec video to y4m at the target sampling rate.

    The y4m output feeds the existing native reader; because extraction
    rates are low (0.5–2 fps), the uncompressed intermediate stays small
    (~0.5 MB per 480p frame)."""
    if not have_ffmpeg():
        raise RuntimeError(
            "decoding codec video needs ffmpeg on PATH (or install "
            "opencv-python / imageio-ffmpeg for the fallback paths)")
    video_path = Path(video_path)
    if out_path is None:
        fd, tmp = tempfile.mkstemp(suffix=".y4m")
        os.close(fd)   # ffmpeg reopens by name; keep no fd of our own
        out_path = Path(tmp)
    cmd = ["ffmpeg", "-y", "-v", "error", "-i", str(video_path)]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-pix_fmt", "yuv420p", "-f", "yuv4mpegpipe", str(out_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr[-500:]}")
    return out_path


def decode_codec_video(
    video_path: str | Path,
    fps: float = 1.0,
    max_frames: Optional[int] = None,
) -> list[tuple[float, np.ndarray]]:
    """mp4/mkv/webm → [(timestamp, rgb)] via the best available ladder:
    ffmpeg→y4m→native reader, then cv2, then imageio."""
    from gvl_tpu_torch.io.video import extract_frames

    errors = []
    if have_ffmpeg():
        y4m = None
        try:
            y4m = ffmpeg_to_y4m(video_path, fps=fps)
            frames = extract_frames(str(y4m), fps=fps, max_frames=max_frames)
            # timestamps from the resampled stream are already at `fps`
            if frames:
                return frames
            errors.append("ffmpeg: produced zero frames")
        except Exception as exc:  # fall through the ladder
            errors.append(f"ffmpeg: {exc}")
        finally:
            if y4m is not None:
                Path(y4m).unlink(missing_ok=True)

    try:
        import cv2  # noqa: F401

        frames = extract_frames(str(video_path), fps=fps,
                                max_frames=max_frames)
        if frames:
            return frames
        errors.append("cv2: decoded zero frames")
    except Exception as exc:
        errors.append(f"cv2: {exc}")

    try:
        import imageio.v3 as iio

        meta = iio.immeta(video_path, plugin="pyav") or {}
        src_fps = float(meta.get("fps", 30.0))
        step = max(1, int(round(src_fps / fps)))
        out = []
        for i, frame in enumerate(iio.imiter(video_path, plugin="pyav")):
            if i % step == 0:
                out.append((i / src_fps, np.asarray(frame)))
                if max_frames and len(out) >= max_frames:
                    break
        if out:
            return out
        errors.append("imageio: decoded zero frames")
    except Exception as exc:
        errors.append(f"imageio: {exc}")

    raise RuntimeError(
        f"no decoder available for {video_path} — tried "
        + "; ".join(errors)
    )


def resolve_video_source(
    source: str,
    fps: float = 1.0,
    max_frames: Optional[int] = None,
    download_dir: str | Path = "downloads",
) -> list[tuple[float, np.ndarray]]:
    """One entry for every source kind: YouTube URL → download + decode;
    synthetic:// / .y4m → native paths; codec files → decode ladder."""
    from gvl_tpu_torch.io.video import extract_frames

    if is_youtube_url(source):
        source = str(download_youtube(source, download_dir))
    if source.startswith("synthetic://") or source.lower().endswith(".y4m"):
        return extract_frames(source, fps=fps, max_frames=max_frames)
    return decode_codec_video(source, fps=fps, max_frames=max_frames)
