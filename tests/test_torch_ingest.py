"""gvl_tpu_torch's ingest, presets and feature cache against gvl_tpu's, on
the CPU.

Exact equality throughout (host code): synthetic frames (with and without
HUD text) and soundtracks byte for byte; ``extract_frames`` on y4m files
written by ``write_y4m`` (chroma planes of odd size, fps strides), the
port's y4m decoder against the JAX package's native decoder and prefetch
source (frames and timestamps) and the float ``Y4MReader`` against JAX's;
the presets field for field; the feature cache's round trip and the
pipeline's cache dict.
"""

import numpy as np
import pytest

from gvl_tpu.cache import feature_cache as jcache
from gvl_tpu.config import presets as jpresets
from gvl_tpu.io import ingest as jingest
from gvl_tpu.io import video as jvideo
from gvl_tpu.runtime import native
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.cache import feature_cache as tcache
from gvl_tpu_torch.config import presets as tpresets
from gvl_tpu_torch.fusion import timeline as ttl
from gvl_tpu_torch.io import ingest as tingest
from gvl_tpu_torch.io import video as tvideo
from gvl_tpu_torch.runtime.y4m import Y4MFrameSource

URLS = [
    "synthetic://concept_demo_a?duration=3&fps=2&entities=player,boss",
    "synthetic://concept_demo_b?duration=6&fps=2&audio=1",
    "synthetic://concept_demo_c?duration=2&fps=4&entities=enemy,item&text=HP%2040",
    "synthetic://boss_fight?duration=2&fps=3&width=96&height=64&text=SCORE%20120",
    "synthetic://concept_demo_d?duration=10&fps=2&entities=player,item&audio=1",
]


@pytest.mark.parametrize("url", URLS)
def test_synthetic_frames_and_audio_byte_equal(url):
    want, got = jvideo.SyntheticVideo.from_url(url), tvideo.SyntheticVideo.from_url(url)
    assert got.num_frames == want.num_frames
    for i in range(0, want.num_frames, max(1, want.num_frames // 4)):
        np.testing.assert_array_equal(got.frame(i), want.frame(i))
    assert got.audio_ground_truth() == want.audio_ground_truth()
    if want.with_audio:
        (wa, wr), (ga, gr) = want.audio(), got.audio()
        assert gr == wr
        np.testing.assert_array_equal(ga, wa)
    assert tvideo.probe_video(url) == jvideo.probe_video(url)
    for fps in (1.0, 2.0):
        w, g = jvideo.extract_frames(url, fps=fps), tvideo.extract_frames(url, fps=fps)
        assert [t for t, _ in g] == [t for t, _ in w]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g, w))
    assert tvideo.SYNTHETIC_SCHEME_VERSION == jvideo.SYNTHETIC_SCHEME_VERSION


def test_synthetic_text_changes_the_frame():
    url = "synthetic://concept_demo_c?duration=1&fps=1&text=HP%2040"
    plain = tvideo.SyntheticVideo.from_url(url.split("&text")[0]).frame(0)
    assert (tvideo.SyntheticVideo.from_url(url).frame(0) != plain).any()


@pytest.fixture(scope="module")
def y4m_files(tmp_path_factory):
    """y4m clips of seeded frames: 4:2:0 with odd chroma sizes (90 x 62:
    chroma 45 x 31), at 6 and 2.5 fps."""
    root = tmp_path_factory.mktemp("y4m")
    rng = np.random.default_rng(0)
    out = {}
    for name, (h, w, n, fps) in {"odd": (62, 90, 9, 6.0), "wide": (40, 128, 5, 2.5)}.items():
        frames = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]
        path = root / f"{name}.y4m"
        jvideo.write_y4m(path, frames, fps)
        other = root / f"{name}_port.y4m"
        tvideo.write_y4m(other, frames, fps)
        assert path.read_bytes() == other.read_bytes()
        out[name] = path
    return out


@pytest.mark.parametrize("name", ["odd", "wide"])
@pytest.mark.parametrize("fps", [6.0, 2.0, 1.0])
def test_extract_frames_from_y4m_equal(y4m_files, name, fps):
    path = str(y4m_files[name])
    want, got = jvideo.extract_frames(path, fps=fps), tvideo.extract_frames(path, fps=fps)
    assert len(got) == len(want) > 0
    assert [t for t, _ in got] == [t for t, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    capped = tvideo.extract_frames(path, fps=fps, max_frames=2)
    assert [t for t, _ in capped] == [t for t, _ in got[:2]]
    assert tvideo.probe_video(path) == jvideo.probe_video(path)


@pytest.mark.skipif(not native.native_available(), reason="no C++ toolchain for the "
                    "JAX package's native runtime")
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_y4m_source_equals_native_prefetch(y4m_files, stride):
    for path in y4m_files.values():
        want = list(native.NativePrefetchSource(path, capacity=3, stride=stride))
        src = Y4MFrameSource(path, stride=stride)
        got = list(src)
        src.close()
        assert [t for t, _ in got] == [t for t, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
        direct = list(native.NativeY4MReader(path))
        assert all(np.array_equal(a, b) for (_, a), b in zip(list(Y4MFrameSource(path)),
                                                              direct))


def test_float_reader_equals_jax(y4m_files):
    for path in y4m_files.values():
        want, got = jvideo.Y4MReader(path), tvideo.Y4MReader(path)
        assert (got.width, got.height, got.fps) == (want.width, want.height, want.fps)
        assert all(np.array_equal(a, b) for a, b in zip(list(got), list(want)))


def test_unported_rungs_raise_as_jax(tmp_path, monkeypatch):
    assert tingest.is_youtube_url("https://youtu.be/abc") == jingest.is_youtube_url(
        "https://youtu.be/abc")
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0" * 64)
    for pkg in (jingest, tingest):
        monkeypatch.setattr(pkg.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no decoder available"):
        tingest.resolve_video_source(str(clip))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tingest.ffmpeg_to_y4m(clip)
    if not jingest.have_ytdlp():
        with pytest.raises(RuntimeError, match="yt-dlp"):
            tingest.download_youtube("https://youtu.be/abc", tmp_path)


def test_presets_equal_jax():
    for name in ("light", "standard", "full"):
        want, got = jpresets.load_preset(name), tpresets.load_preset(name)
        assert got.to_dict() == want.to_dict()
        assert got.get_hbm_breakdown() == want.get_hbm_breakdown()


def _processed(video):
    """A ProcessedVideo of the port with events, entities and embeddings."""
    result = tpipe.ProcessedVideo(video_path=video)
    rng = np.random.default_rng(3)
    M = ttl.ModalityType
    for t, (m, d) in enumerate([(M.VISUAL, "boss detected"), (M.SPEECH, "go left"),
                                (M.AUDIO, "UI chime"), (M.OCR, "HP 40")]):
        result.timeline.add_event(float(t), m, d, entity_id="boss_000" if t == 0 else None,
                                  confidence=0.5 + t / 10, duration=0.5 * t)
    kb = result.knowledge_base
    for k in range(3):
        kb.register_entity(f"enemy_{k:03d}", "enemy", timestamp=float(k))
    kb.update_entity_state("enemy_000", 2.0, position=(10.0, 20.0), bbox=(5, 15, 15, 25))
    result.timestamps = [0.0, 1.0, 2.0]
    result.audio_embeddings = [(0.0, rng.standard_normal(16).astype(np.float32)),
                               (10.0, rng.standard_normal(16).astype(np.float32))]
    return result


def test_cache_dict_and_restore_equal_jax(tmp_path):
    from scripts import realtime_inference as jri

    video = "synthetic://concept_demo_cache?duration=3"
    ours = _processed(video)
    got = tpipe._to_cache_dict(ours)
    theirs = jri.ProcessedVideo(video_path=video)
    jri._restore_from_cache(theirs, got)
    want = jri._to_cache_dict(theirs)
    for d in (got, want):
        d["knowledge_base"].pop("exported_at")
    assert set(got) == set(want)
    for key in got:
        if isinstance(got[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        elif key != "knowledge_base":
            assert got[key] == want[key], key
    assert ([e["entity_id"] for e in got["knowledge_base"]["entities"]]
            == [e["entity_id"] for e in want["knowledge_base"]["entities"]])
    back = tpipe.ProcessedVideo(video_path=video)
    tpipe._restore_from_cache(back, want)
    assert (back.timeline.build_structured_transcript()
            == theirs.timeline.build_structured_transcript())
    assert back.knowledge_base.export_for_llm() == theirs.knowledge_base.export_for_llm()


def test_feature_cache_round_trips_across_packages(tmp_path):
    video = "synthetic://concept_demo_cache?duration=3"
    features = tpipe._to_cache_dict(_processed(video))
    assert tcache.video_content_hash(video) == jcache.video_content_hash(video)
    tcache.FeatureCache(tmp_path).save_features(video, features)
    for loaded in (tcache.FeatureCache(tmp_path).load_features(video),
                   jcache.FeatureCache(tmp_path).load_features(video)):
        assert loaded["events"] == features["events"]
        np.testing.assert_array_equal(loaded["audio"], features["audio"])
        assert loaded["knowledge_base"] == features["knowledge_base"]
    clip = tmp_path / "clip.y4m"
    jvideo.write_y4m(clip, [np.zeros((8, 8, 3), np.uint8)] * 2, 2.0)
    assert tcache.video_content_hash(clip) == jcache.video_content_hash(clip)
    cache = tcache.FeatureCache(tmp_path / "c")
    assert cache.load_features(str(clip)) is None
    cache.save_features(str(clip), {"x": np.arange(3)})
    np.testing.assert_array_equal(tcache.FeatureCache(tmp_path / "c").load_features(
        str(clip))["x"], np.arange(3))
    assert cache.get_cache_stats()["num_cached_videos"] == 1
