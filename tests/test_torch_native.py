"""The port's native host runtime (``gvl_tpu_torch.runtime.native``, built
from ``gvl_tpu_torch/runtime/csrc/gvl_runtime.cpp`` into
``gvl_tpu_torch/_build/``) against the JAX package's library
(``gvl_tpu.runtime.native``) and against the port's numpy copies
(``runtime/resize.py``, ``wav.py``, ``y4m.py``), on seeded inputs.

Every comparison is exact: bytes for images, masks and frames, float32
bits for WAV samples, float64 equality for timestamps.
"""

import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gvl_tpu.runtime import native as jnative
from gvl_tpu_torch.io import video as tvideo
from gvl_tpu_torch.runtime import native, resize, wav, y4m

pytestmark = pytest.mark.skipif(not jnative.native_available(),
                                reason="no C++ toolchain for the JAX package's runtime")


def _shapes(seed: int, n: int, grow: bool):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        sh, sw = (int(x) for x in rng.integers(1, 70, 2))
        if grow:
            dh, dw = sh + int(rng.integers(0, 60)), sw + int(rng.integers(1, 60))
        else:
            dh, dw = int(rng.integers(1, sh + 1)), int(rng.integers(1, sw + 1))
        c = int(rng.choice([1, 3, 4]))
        yield rng.integers(0, 256, (sh, sw, c), dtype=np.uint8), dh, dw


@pytest.mark.parametrize("grow", [False, True], ids=["area_down", "bilinear_up"])
def test_resize_byte_equal(grow):
    """Area average (neither side grows) and bilinear (either grows), 1, 3
    and 4 channels, odd and prime sizes: the same bytes three ways."""
    for img, dh, dw in _shapes(1 + grow, 120, grow):
        got = native.resize_image(img, dh, dw)
        assert got.shape == (dh, dw, img.shape[2])
        assert np.array_equal(got, jnative.resize_image(img, dh, dw))
        assert np.array_equal(got, resize.resize_image(img, dh, dw))
    flat = np.random.default_rng(3).integers(0, 256, (37, 53), dtype=np.uint8)
    assert np.array_equal(native.resize_image(flat, 20, 90), jnative.resize_image(flat, 20, 90))


def test_resize_batch_and_images():
    """One call for N frames of a shape equals N single calls and JAX's
    batch; ``resize_images`` takes the batch route for a clip and the
    single route for mixed shapes."""
    rng = np.random.default_rng(4)
    for (h, w), (dh, dw) in (((48, 64), (256, 256)), ((300, 200), (128, 128)),
                             ((31, 17), (31, 17))):
        frames = rng.integers(0, 256, (5, h, w, 3), dtype=np.uint8)
        got = native.resize_batch(frames, dh, dw)
        assert np.array_equal(got, jnative.resize_batch(frames, dh, dw))
        assert np.array_equal(got, np.stack([resize.resize_image(f, dh, dw) for f in frames]))
        assert np.array_equal(native.resize_images(list(frames), dh, dw), got)
    mixed = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((20, 30, 3), (33, 11, 3))]
    assert np.array_equal(native.resize_images(mixed, 16, 16),
                          np.stack([resize.resize_image(m, 16, 16) for m in mixed]))
    assert native.resize_batch(np.zeros((0, 4, 4, 3), np.uint8), 2, 2).shape == (0, 2, 2, 3)


def test_resize_mask_nearest_equal():
    rng = np.random.default_rng(5)
    for _ in range(60):
        sh, sw, dh, dw = (int(x) for x in rng.integers(1, 80, 4))
        mask = rng.random((sh, sw)) < 0.4
        got = native.resize_mask(mask, dh, dw)
        assert got.dtype == bool and got.shape == (dh, dw)
        assert np.array_equal(got, jnative.resize_mask(mask, dh, dw))
        assert np.array_equal(got, resize.resize_mask(mask, dh, dw))


def test_bad_sizes_raise():
    with pytest.raises(ValueError):
        native.resize_image(np.zeros((4, 4, 3), np.uint8), 0, 3)
    with pytest.raises(ValueError):
        native.resize_mask(np.zeros((4, 4), bool), 3, 0)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Seeded 4:2:0 clips written by the port's ``write_y4m``: odd chroma
    sizes (62 x 90) at 6 fps, and 23 frames of 48 x 64 at 10 fps."""
    root = tmp_path_factory.mktemp("native_y4m")
    rng = np.random.default_rng(6)
    out = {}
    for name, (h, w, n, fps) in {"odd": (62, 90, 9, 6.0), "long": (48, 64, 23, 10.0)}.items():
        frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
        path = root / f"{name}.y4m"
        tvideo.write_y4m(path, frames, fps)
        out[name] = path
    return out


def _pairs_equal(got, want) -> bool:
    return ([t for t, _ in got] == [t for t, _ in want]
            and all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want)))


def test_y4m_reader_equal(clips):
    for path in clips.values():
        reader = native.NativeY4MReader(path)
        jreader = jnative.NativeY4MReader(path)
        assert (reader.width, reader.height, reader.fps) == (jreader.width, jreader.height,
                                                             jreader.fps)
        got = list(reader)
        reader.close()
        plain = y4m.Y4MFrameSource(path)
        want = [f for _, f in plain]
        plain.close()
        assert len(got) == len(want) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, list(jreader)))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="cannot open"):
        native.NativeY4MReader(Path(next(iter(clips.values()))).with_suffix(".absent"))


@pytest.mark.parametrize("stride", [1, 2, 3, 5])
@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_prefetch_ring_equal(clips, stride, capacity):
    """Every stride-th frame with its timestamp, to the end of the file,
    whatever the ring's size (a capacity below 2 is raised to 2)."""
    for path in clips.values():
        src = native.NativePrefetchSource(path, capacity=capacity, stride=stride)
        got = list(src)
        assert list(src) == []          # at EOF the ring stays empty
        src.close()
        want = list(jnative.NativePrefetchSource(path, capacity=capacity, stride=stride))
        plain = y4m.Y4MFrameSource(path, stride=stride)
        assert _pairs_equal(got, want) and _pairs_equal(got, list(plain))
        plain.close()


def test_prefetch_early_close_does_not_deadlock(clips):
    """Closing after one frame, while the decode thread waits on a full
    ring, stops and joins it; so does closing before any read, and twice."""
    start = time.perf_counter()
    for capacity in (2, 4):
        src = native.NativePrefetchSource(clips["long"], capacity=capacity)
        first = next(iter(src))
        assert first[0] == 0.0
        time.sleep(0.05)                # the producer fills the ring and blocks
        src.close()
        src.close()
        native.NativePrefetchSource(clips["long"], capacity=capacity).close()
    assert time.perf_counter() - start < 10


def test_prefetch_sources_in_threads(clips):
    """Four rings read at once from four threads (the pipelined mode reads
    while other threads work) give each the whole clip."""
    want = list(y4m.Y4MFrameSource(clips["long"], stride=2))
    results = [None] * 4

    def read(i):
        src = native.NativePrefetchSource(clips["long"], capacity=2, stride=2)
        results[i] = list(src)
        src.close()

    threads = [threading.Thread(target=read, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(_pairs_equal(r, want) for r in results)


def test_extract_frames_takes_the_ring(clips, monkeypatch):
    """``extract_frames`` on a ``.y4m`` reads through the port's ring, and
    gives what JAX's ``extract_frames`` gives."""
    from gvl_tpu.io import video as jvideo

    made = []
    real = native.NativePrefetchSource

    def spy(*args, **kw):
        made.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(native, "NativePrefetchSource", spy)
    path = str(clips["long"])
    got = tvideo.extract_frames(path, fps=2.0)
    assert made == [{"capacity": 8, "stride": 5}]
    assert _pairs_equal(got, jvideo.extract_frames(path, fps=2.0))


def _write_wav(path, samples: np.ndarray, rate: int, bits: int, fmt: int = 1):
    channels = samples.shape[1]
    if fmt == 3:
        data = samples.astype("<f4").tobytes()
    elif bits == 16:
        data = samples.astype("<i2").tobytes()
    elif bits == 24:
        v = samples.astype("<i4").reshape(-1)
        data = b"".join(int(x).to_bytes(4, "little", signed=True)[:3] for x in v)
    else:
        data = samples.astype("<i4").tobytes()
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate, rate * block, block, bits)
    # an unknown chunk of odd size before "data" (padded to even)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
            + b"LIST" + struct.pack("<I", 3) + b"abc\0"
            + b"data" + struct.pack("<I", len(data)) + data)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("bits,fmt,channels", [(16, 1, 1), (16, 1, 2), (24, 1, 2),
                                               (32, 1, 1), (32, 3, 3)])
def test_wav_read_equal(tmp_path, bits, fmt, channels):
    rng = np.random.default_rng(bits + fmt + channels)
    n = 1001
    if fmt == 3:
        samples = rng.uniform(-1, 1, (n, channels)).astype(np.float32)
    else:
        lim = 2 ** (bits - 1)
        samples = rng.integers(-lim, lim, (n, channels), dtype=np.int64)
    path = tmp_path / "clip.wav"
    _write_wav(path, samples, 22050, bits, fmt)
    got, rate = native.read_wav_native(path)
    want, jrate = jnative.read_wav_native(path)
    plain, prate = wav.read_wav(path)
    assert rate == jrate == prate == 22050
    assert got.dtype == np.float32 and got.shape == (n,)
    assert got.tobytes() == want.tobytes() == plain.tobytes()


def test_wav_read_errors(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError, match="wav_read failed"):
        native.read_wav_native(bad)
    with pytest.raises(ValueError):
        jnative.read_wav_native(bad)
    with pytest.raises(ValueError, match="wav_read failed"):
        native.read_wav_native(tmp_path / "absent.wav")


def test_build_is_keyed_and_atomic():
    """The library lies under ``_build/runtime-<hash>/`` with no partial
    file beside it, and is not the JAX package's."""
    lib = native._build()
    assert lib.parent.parent == native.BUILD_DIR and lib.parent.name.startswith("runtime-")
    assert not [p for p in lib.parent.iterdir() if ".partial-" in p.name]
    assert Path(native.library()._name).resolve() == lib.resolve()
    assert "gvl_tpu/runtime" not in str(lib)


def test_build_failure_raises(monkeypatch, tmp_path):
    """No compiler: the build raises, and nothing takes the numpy route."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not start"):
        native.resize_image(np.zeros((4, 4, 3), np.uint8), 2, 2)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build failed"):
        native.library()
