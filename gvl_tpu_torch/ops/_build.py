"""Build and load the CUDA kernels of ``gvl_tpu_torch/csrc``.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
the sources for ``sm_90a``; one more links the objects into a shared
library with a plain C interface, which :func:`library` loads with
``ctypes``.  No source includes PyTorch's headers, so the build takes
seconds: about as long as the slowest source.

The library goes to ``gvl_tpu_torch/_build/<hash of the sources and
flags>/`` at first use.  It is written under a temporary name and renamed
into place, so a build that was cut off leaves no file that a later run
could take for a finished library, and no lock file to wait on.  A build
that fails or passes :data:`BUILD_TIMEOUT_S` raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libgvl_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300

# element types as the C entry points number them (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gvl_flash_attention": [_VOID_P] * 4 + [_INT] * 8 + [_FLOAT, _INT, _VOID_P],
    "gvl_decode_attention": [_VOID_P] * 5 + [_INT] * 5 + [_FLOAT, _INT, _VOID_P],
    "gvl_decode_attention_split": [],
    "gvl_decode_attention_stacked": [_VOID_P] * 5 + [_INT] * 7 + [_FLOAT, _INT, _VOID_P],
    "gvl_chunk_attention": [_VOID_P] * 5 + [_INT] * 6 + [_FLOAT, _INT, _VOID_P],
    "gvl_cache_append": [_VOID_P] * 5 + [_INT] * 5 + [_VOID_P],
    "gvl_cache_append_stacked": [_VOID_P] * 5 + [_INT] * 7 + [_VOID_P],
    "gvl_w8a8_matmul": [_VOID_P] * 6 + [_INT] * 4 + [_FLOAT, _INT, _INT, _VOID_P],
    "gvl_ln_quant": [_VOID_P] * 4 + [_INT] * 2 + [_FLOAT] * 2 + [_INT, _VOID_P],
    "gvl_quant_static": [_VOID_P] * 2 + [ctypes.c_long, _FLOAT, _INT, _VOID_P],
    "gvl_encoder_attention": [_VOID_P] * 3 + [_INT] * 5 + [_FLOAT, _INT, _INT, _FLOAT]
                             + [_INT] * 3 + [_VOID_P],
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the library was there
    command: tuple        # the link command line, empty when cached
    compiles: tuple = ()  # one compile command line per source


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Digest of every file in csrc/ and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _nvcc(cmd: tuple, outputs: list[Path]) -> None:
    """Run one nvcc command; raise with its output if it fails or passes
    the time limit, removing what it may have half written."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        for path in outputs:
            path.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc did not finish in {BUILD_TIMEOUT_S} s:\n{exc.stderr or ''}") from exc
    if proc.returncode != 0:
        for path in outputs:
            path.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")


def build(root: Path | None = None) -> BuildResult:
    """The kernel library for the current sources, compiling it under
    ``root`` (default :data:`BUILD_DIR`) if it is not there yet."""
    out_dir = (root or BUILD_DIR) / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildResult(lib, 0.0, ())
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"partial-{os.getpid()}"
    nvcc = find_nvcc()
    objects = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]   # nvcc wants .o
    compiles = tuple((nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src))
                     for src, obj in zip(sources(), objects))
    partial = out_dir / f"{LIB_NAME}.{tag}"
    link = (nvcc, *NVCC_FLAGS, "-shared", "-o", str(partial), *(str(o) for o in objects))
    start = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            for done in [pool.submit(_nvcc, cmd, [obj])
                         for cmd, obj in zip(compiles, objects)]:
                done.result()
        _nvcc(link, [partial])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    os.replace(partial, lib)
    return BuildResult(lib, seconds, link, compiles)


def compare_builds() -> dict:
    """Wall seconds of a build with one nvcc command for every source and
    of :func:`build`'s (one per source, started together, then a link),
    each into a fresh directory under :data:`BUILD_DIR`."""
    import tempfile

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as single_dir, \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as split_dir:
        lib = Path(single_dir) / LIB_NAME
        start = time.perf_counter()
        _nvcc((find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(src) for src in sources())), [lib])
        single = time.perf_counter() - start
        split = build(Path(split_dir)).seconds
    return {"sources": len(sources()), "one_command_s": single,
            "per_source_then_link_s": split}


_LIBRARY_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call in a process;
    threads that ask at once wait for one build)."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.gvl_error_string.argtypes = [_INT]
    lib.gvl_error_string.restype = ctypes.c_char_p
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``.  Under a lock: the pipelined
    perception mode launches from a thread per stage, and ``+=`` on an
    attribute can lose a count between threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        text = entry("gvl_error_string")(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({text})")


@functools.cache
def entry(name: str):
    """The loaded library's C function ``name``, looked up once."""
    return getattr(library(), name)


def stream_handle(device_index: int) -> int:
    """PyTorch's current stream on card ``device_index``, as a
    pointer-sized int: inside ``torch.cuda.stream(s)`` it is ``s``, and
    during a CUDA graph capture the capturing stream.  The raw handle, with
    no ``torch.cuda.Stream`` object built around it (the call Triton makes
    for its launches)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def require_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Every tensor on one CUDA device and contiguous, or raise; returns
    the device's index."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(
                f"{name}: tensors must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return index


if __name__ == "__main__":
    # python -m gvl_tpu_torch.ops._build: time both ways of building, as JSON
    import json

    print(json.dumps(compare_builds()))
