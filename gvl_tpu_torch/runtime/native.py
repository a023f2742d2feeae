"""ctypes bindings over the port's native host runtime
(``runtime/csrc/gvl_runtime.cpp``): the counterpart of
:mod:`gvl_tpu.runtime.native`.

The library builds with ``g++`` at first use into
``gvl_tpu_torch/_build/runtime-<hash of the source and flags>/``, written
under a temporary name and renamed into place (the scheme of
:mod:`gvl_tpu_torch.ops._build`), so test workers that build at once never
load a half-written file.  A build that fails raises: nothing falls back
to the numpy versions in :mod:`gvl_tpu_torch.runtime.resize`,
:mod:`~gvl_tpu_torch.runtime.wav` and :mod:`~gvl_tpu_torch.runtime.y4m`,
which stay as the plain versions the tests compare against.

The flags leave out ``-march=native`` (the JAX package's build has it) and
pin ``-ffp-contract=off``: the bilinear taps' float32 coordinates must not
be contracted into fused multiply-adds, so the bytes are those of the
numpy copies and of the JAX package's library on any host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "gvl_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libgvl_runtime.so"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", "-pthread")
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> Path:
    """The library for the current source, compiled if it is not there."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_DIR / f"runtime-{digest.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native runtime needs g++ (or $CXX) to build")
    out_dir.mkdir(parents=True, exist_ok=True)
    partial = out_dir / f"{LIB_NAME}.partial-{os.getpid()}-{threading.get_ident()}"
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(partial)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build passed {BUILD_TIMEOUT_S} s") from exc
    except OSError as exc:
        raise RuntimeError(f"native runtime build could not start {cxx}: {exc}") from exc
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(partial, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded runtime (built at the first call in a process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        int_p, dbl_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i, vp = ctypes.c_int, ctypes.c_void_p
        signatures = {
            "y4m_open": (vp, [ctypes.c_char_p]),
            "y4m_info": (i, [vp, int_p, int_p, dbl_p]),
            "y4m_next_frame": (i, [vp, vp]),
            "y4m_close": (None, [vp]),
            "wav_read": (ctypes.c_long, [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                         int_p]),
            "wav_free": (None, [ctypes.POINTER(ctypes.c_float)]),
            "prefetch_create": (vp, [ctypes.c_char_p, i, i]),
            "prefetch_info": (i, [vp, int_p, int_p, dbl_p]),
            "prefetch_next": (i, [vp, vp, dbl_p]),
            "prefetch_destroy": (None, [vp]),
            "resize_u8": (i, [u8p, i, i, i, u8p, i, i]),
            "resize_u8_batch": (i, [u8p, i, i, i, i, u8p, i, i]),
            "resize_nearest_u8": (i, [u8p, i, i, u8p, i, i]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the runtime builds and loads here (:func:`library` raises the
    reason when it does not)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _info(fn, handle) -> tuple[int, int, float]:
    w, h, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
    fn(handle, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
    return w.value, h.value, fps.value


class NativeY4MReader:
    """Streaming y4m frames (rgb uint8 ``[H, W, 3]``) decoded in C++."""

    def __init__(self, path: str | Path):
        self._lib = library()
        self._handle = self._lib.y4m_open(str(path).encode())
        if not self._handle:
            raise ValueError(f"cannot open y4m: {path}")
        self.width, self.height, self.fps = _info(self._lib.y4m_info, self._handle)

    def __iter__(self) -> Iterator[np.ndarray]:
        out = np.empty((self.height, self.width, 3), np.uint8)
        while self._handle and self._lib.y4m_next_frame(
                self._handle, out.ctypes.data_as(ctypes.c_void_p)) == 1:
            yield out.copy()

    def close(self) -> None:
        if self._handle:
            self._lib.y4m_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativePrefetchSource:
    """``(timestamp, rgb uint8 [H, W, 3])`` of every ``stride``-th frame,
    decoded by a C++ thread into a ring of ``capacity`` frames, so decode
    overlaps whatever the consumer does with the frames.  :meth:`close`
    before the end stops and joins the thread."""

    def __init__(self, path: str | Path, capacity: int = 8, stride: int = 1):
        self._lib = library()
        self._handle = self._lib.prefetch_create(str(path).encode(), capacity, stride)
        if not self._handle:
            raise ValueError(f"cannot open y4m: {path}")
        self.width, self.height, self.fps = _info(self._lib.prefetch_info, self._handle)

    def __iter__(self) -> Iterator[tuple[float, np.ndarray]]:
        out = np.empty((self.height, self.width, 3), np.uint8)
        ts = ctypes.c_double()
        while self._handle and self._lib.prefetch_next(
                self._handle, out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ts)) == 1:
            yield ts.value, out.copy()

    def close(self) -> None:
        if self._handle:
            self._lib.prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def read_wav_native(path: str | Path) -> tuple[np.ndarray, int]:
    """Mono float32 samples and the sample rate of a PCM16/24/32 or float32
    WAV file, decoded in C++; ``ValueError`` where the decoder fails."""
    lib = library()
    out = ctypes.POINTER(ctypes.c_float)()
    rate = ctypes.c_int()
    n = lib.wav_read(str(path).encode(), ctypes.byref(out), ctypes.byref(rate))
    if n <= 0:
        raise ValueError(f"wav_read failed ({n}) for {path}")
    try:
        data = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.wav_free(out)
    return data, rate.value


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 ``[H, W]`` or ``[H, W, C]`` → ``[height, width, C]``: area
    average when neither side grows, else bilinear (half-pixel centres,
    8.8 fixed point)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    sh, sw, c = image.shape
    out = np.empty((height, width, c), np.uint8)
    if not library().resize_u8(_u8p(image), sh, sw, c, _u8p(out), height, width):
        raise ValueError(f"cannot resize {image.shape} to ({height}, {width})")
    return out


def resize_batch(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 ``[N, H, W, C]`` → ``[N, height, width, C]`` in one call."""
    images = np.ascontiguousarray(images, np.uint8)
    n, sh, sw, c = images.shape
    out = np.empty((n, height, width, c), np.uint8)
    if n and not library().resize_u8_batch(_u8p(images), n, sh, sw, c, _u8p(out),
                                           height, width):
        raise ValueError(f"cannot resize {images.shape} to ({height}, {width})")
    return out


def resize_images(images, height: int, width: int) -> np.ndarray:
    """A list of uint8 ``[H, W, 3]`` frames → ``[N, height, width, 3]``:
    one :func:`resize_batch` call when they share a shape (the frames of a
    clip), else one :func:`resize_image` each."""
    shapes = {np.shape(f) for f in images}
    if len(shapes) == 1 and len(next(iter(shapes))) == 3:
        return resize_batch(np.stack(images), height, width)
    return np.stack([resize_image(f, height, width) for f in images])


def resize_mask(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """bool ``[H, W]`` → bool ``[height, width]``, nearest neighbour."""
    src = np.ascontiguousarray(mask, np.uint8)
    out = np.empty((height, width), np.uint8)
    if not library().resize_nearest_u8(_u8p(src), src.shape[0], src.shape[1], _u8p(out),
                                       height, width):
        raise ValueError(f"cannot resize {src.shape} to ({height}, {width})")
    return out.astype(bool)
