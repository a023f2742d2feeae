"""gvl_tpu_torch.device_times on the CPU: what it counts and which parts it
runs (the measurements themselves need the card)."""

import dataclasses
import subprocess
import sys
from types import SimpleNamespace

from gvl_tpu_torch import device_times


def _event(key, count, device_us):
    return SimpleNamespace(key=key, count=count, device_time_total=device_us)


def test_launch_counts_split_kernels_from_copies():
    prof = SimpleNamespace(key_averages=lambda: [
        _event("decode_attention_kernel", 10, 40.0),
        _event("ampere_sgemm_128x64_tn", 30, 300.0),
        _event("Memcpy HtoD (Pageable -> Device)", 2, 3.0),
        _event("Memset (Device)", 1, 1.0),
        _event("cudaLaunchKernel", 40, 0.0),      # host side: no device time
    ])
    assert device_times._launch_counts(prof) == (40, 3)


def test_parts_and_usage():
    assert set(device_times.PARTS) == {"kernels", "decode", "semantic", "perception"}
    proc = subprocess.run([sys.executable, "-m", "gvl_tpu_torch.device_times", "--only",
                           "nothing"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "usage" in proc.stderr


def test_route_ab_alternates_and_takes_medians(monkeypatch):
    import torch

    from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Engine, init_params

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = Qwen3Config.tiny(head_dim=64, hidden_size=128)
    state = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")
    order = []

    class Tagged(Qwen3Engine):
        def stream(self, *args, **kw):
            order.append(self.tag)
            return super().stream(*args, **kw)

    engines = {}
    for tag, use_kernel in (("kernel", True), ("scatter", False)):
        engines[tag] = Tagged(dataclasses.replace(cfg, use_cache_append_kernel=use_kernel),
                              state, eos_token_id=-1, device="cpu")
        engines[tag].tag = tag
    out = device_times.route_ab(engines, [1, 2, 3], steps=3, rounds=3)
    assert order == ["kernel", "scatter"] * 4          # a warm-up each, then turns
    assert {k: len(v) for k, v in out["rounds_ms_per_step"].items()} == {
        "kernel": 3, "scatter": 3}
    assert all(v > 0 for v in out["median_ms_per_step"].values())
