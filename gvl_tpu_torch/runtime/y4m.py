"""The y4m decoder of the native host runtime, in numpy (the port's copy of
``y4m_open`` / ``y4m_next_frame`` in ``gvl_tpu/runtime/csrc/gvl_runtime.cpp``,
as ``gvl_tpu.runtime.native`` binds them).

Frames are converted with the native decoder's fixed-point BT.601
arithmetic (16.16, arithmetic shifts, clamped to 0..255), so they are
byte-equal to ``NativeY4MReader`` and ``NativePrefetchSource``, not to the
float conversion of :class:`gvl_tpu_torch.io.video.Y4MReader` (the two
differ by up to 2 LSB).  :class:`Y4MFrameSource` yields what
``NativePrefetchSource(path, stride=...)`` yields: every ``stride``-th
frame with its timestamp ``index / fps``, read in the caller's thread
(the plain version of the port's native ring,
:class:`gvl_tpu_torch.runtime.native.NativePrefetchSource`).  Chroma sizes are ``w // 2`` by
``h // 2`` (4:2:0), ``w // 2`` by ``h`` (4:2:2) or full (4:4:4); luma sizes
that are odd have no well-defined 4:2:0 layout in either decoder.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np


class Y4MFrameSource:
    """Streaming y4m frames ``(timestamp, rgb uint8 [H, W, 3])``."""

    def __init__(self, path: str | Path, stride: int = 1):
        self.path = Path(path)
        self.stride = max(int(stride), 1)
        self._file = open(self.path, "rb")
        header = self._file.readline(1023)
        if not header.startswith(b"YUV4MPEG2"):
            self._file.close()
            raise ValueError(f"cannot open y4m: {path}")
        self.width = self.height = 0
        num, den, self.chroma = 30, 1, 420
        for tok in header[9:].decode("ascii", "ignore").split():
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = (int(x) for x in tok[1:].split(":"))
            elif tok[0] == "C":
                self.chroma = 444 if tok[1:4] == "444" else 422 if tok[1:4] == "422" else 420
        if self.width <= 0 or self.height <= 0 or den <= 0:
            self._file.close()
            raise ValueError(f"cannot open y4m: {path}")
        self.fps = num / den
        w, h = self.width, self.height
        self._cw = w if self.chroma == 444 else w // 2
        self._ch = h // 2 if self.chroma == 420 else h
        self._frame_bytes = w * h + 2 * self._cw * self._ch

    def _to_rgb(self, buf: np.ndarray) -> np.ndarray:
        w, h, cw, ch = self.width, self.height, self._cw, self._ch
        y = buf[: w * h].reshape(h, w).astype(np.int32)
        u = buf[w * h: w * h + cw * ch].reshape(ch, cw).astype(np.int32)
        v = buf[w * h + cw * ch:].reshape(ch, cw).astype(np.int32)
        if self.chroma == 420:
            u, v = u.repeat(2, 0), v.repeat(2, 0)
        if self.chroma != 444:
            u, v = u.repeat(2, 1), v.repeat(2, 1)
        uu, vv = u - 128, v - 128
        yy = 76309 * (y - 16)
        rgb = np.stack([(yy + 104597 * vv) >> 16,
                        (yy - 25675 * uu - 53279 * vv) >> 16,
                        (yy + 132201 * uu) >> 16], axis=-1)
        return np.clip(rgb, 0, 255).astype(np.uint8)

    def __iter__(self) -> Iterator[tuple[float, np.ndarray]]:
        index = 0
        while True:
            line = self._file.readline(255)
            if not line.startswith(b"FRAME"):
                return
            raw = self._file.read(self._frame_bytes)
            if len(raw) < self._frame_bytes:
                return
            if index % self.stride == 0:
                yield index / self.fps, self._to_rgb(np.frombuffer(raw, np.uint8))
            index += 1

    def close(self) -> None:
        self._file.close()
