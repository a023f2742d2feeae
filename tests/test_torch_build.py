"""The kernel build of gvl_tpu_torch, with nvcc mocked (no CUDA here)."""

import subprocess
from pathlib import Path

import pytest

from gvl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "fake-nvcc")
    return tmp_path / "_build"


def _fake_nvcc(calls, returncode=0, stderr=""):
    def run(cmd, **kw):
        calls.append((list(cmd), kw))
        if returncode == 0:
            out = Path(cmd[cmd.index("-o") + 1])
            out.write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, returncode, "", stderr)
    return run


def test_one_nvcc_command_for_sm90a_with_timeout(build_dir, monkeypatch):
    """One nvcc compile per source (run together), then one link command."""
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    result = _build.build()
    sources = sorted(str(p) for p in (REPO / "gvl_tpu_torch" / "csrc").glob("*.cu"))
    assert len(calls) == len(sources) + 1
    compiles, (link, link_kw) = calls[:-1], calls[-1]
    assert sorted(cmd[-1] for cmd, _ in compiles) == sources
    for cmd, kw in calls:
        assert cmd[0] == "fake-nvcc"
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-Xcompiler", "-fPIC"):
            assert flag in cmd
        assert kw["timeout"] == _build.BUILD_TIMEOUT_S <= 300
    assert all("-c" in cmd for cmd, _ in compiles) and "-shared" in link
    objects = [cmd[cmd.index("-o") + 1] for cmd, _ in compiles]
    assert all(obj.endswith(".o") for obj in objects)      # nvcc goes by suffix
    assert link[-len(objects):] == objects
    assert {"flash_attention.cu", "decode_attention.cu", "cache_append.cu",
            "chunk_attention.cu", "w8a8_matmul.cu", "ln_quant.cu",
            "encoder_attention.cu"} <= {
        Path(s).name for s in sources}
    assert result.path == build_dir / _build.source_hash() / _build.LIB_NAME
    assert result.path.is_file() and result.command == tuple(link)
    assert result.compiles == tuple(tuple(cmd) for cmd, _ in compiles)
    assert not list(result.path.parent.glob("*partial-*"))


def test_finished_library_is_reused(build_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    first = _build.build()
    again = _build.build()
    assert len(calls) == len(_build.sources()) + 1
    assert again.path == first.path and again.seconds == 0.0 and again.command == ()


def test_stale_partial_file_is_not_taken_for_a_library(build_dir, monkeypatch):
    out_dir = build_dir / _build.source_hash()
    out_dir.mkdir(parents=True)
    stale = out_dir / f"{_build.LIB_NAME}.partial-12345"
    stale.write_bytes(b"half a library")
    (out_dir / "lock").write_text("")       # nothing waits on a lock file
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    result = _build.build()
    assert len(calls) == len(_build.sources()) + 1
    assert result.path.read_bytes() == b"\x7fELF"


def test_failed_build_raises_with_nvcc_output(build_dir, monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        _fake_nvcc([], returncode=2, stderr="error: bad kernel"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert not list(build_dir.rglob(_build.LIB_NAME))
    assert not list(build_dir.rglob("*.o"))


def test_timed_out_build_raises(build_dir, monkeypatch):
    def run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"], stderr="still compiling")
    monkeypatch.setattr(subprocess, "run", run)
    with pytest.raises(RuntimeError, match="did not finish"):
        _build.build()


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("one")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.source_hash()
    (tmp_path / "common.cuh").write_text("header")
    second = _build.source_hash()
    (tmp_path / "a.cu").write_text("two")
    assert len({first, second, _build.source_hash()}) == 3


def test_build_dir_is_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert "gvl_tpu_torch/_build/" in ignored
    assert _build.BUILD_DIR == REPO / "gvl_tpu_torch" / "_build"


def test_sources_use_plain_c_interface():
    for path in (REPO / "gvl_tpu_torch" / "csrc").iterdir():
        text = path.read_text()
        assert "torch/extension.h" not in text and "#include <torch" not in text
    names = set(_build._SIGNATURES)
    text = "".join(p.read_text() for p in (REPO / "gvl_tpu_torch" / "csrc").glob("*.cu"))
    for name in names:
        assert f'extern "C" int {name}(' in text


def test_signatures_match_the_c_declarations():
    """ctypes passes what _SIGNATURES declares: a count that differs from
    the C parameter list would shift every argument after it unnoticed."""
    import re

    text = "".join(p.read_text() for p in (REPO / "gvl_tpu_torch" / "csrc").glob("*.cu"))
    for name, argtypes in _build._SIGNATURES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1).strip()
        count = 0 if params in ("", "void") else params.count(",") + 1
        assert count == len(argtypes), name


def test_compare_builds_times_one_command_and_per_source(build_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    times = _build.compare_builds()
    n = len(_build.sources())
    assert times["sources"] == n and len(calls) == 1 + n + 1
    single = calls[0][0]
    assert "-shared" in single and "-c" not in single
    assert single[-n:] == [str(s) for s in _build.sources()]
    assert times["one_command_s"] >= 0 and times["per_source_then_link_s"] > 0
    assert list(build_dir.iterdir()) == []      # both builds were thrown away
