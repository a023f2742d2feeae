"""The port's counterparts of ``__graft_entry__``: ``entry``, a forward step of the
flagship reasoning decoder at the full 8B layer geometry (Qwen3-VL-8B's
text decoder: hidden 4096, 32 query / 8 KV heads, head_dim 128, MLP
12288, vocabulary 151936), cut to 4 layers, with zero weights.

    fn, args = entry()          # on the card
    logits = fn(*args)          # [1, 128, 151936]

The prefill's attention runs on the flash kernel (B1).  ``config``
replaces the geometry (the CPU tests pass a tiny one: the 8B geometry at
depth 4 holds 2.0 G f32 weights).
"""

from __future__ import annotations

from typing import Optional

import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model


def flagship_config() -> Qwen3Config:
    """The 8B layer geometry at depth 4 (``__graft_entry__.entry``'s)."""
    return Qwen3Config(
        hidden_size=4096, num_layers=4, num_heads=32, num_kv_heads=8,
        head_dim=128, intermediate_size=12288, vocab_size=151936,
        max_cache_length=1024,
    )


def entry(device: str | torch.device = "cuda", config: Optional[Qwen3Config] = None):
    """(fn, example_args): ``fn(params, tokens)`` runs the decoder's forward
    with ``params`` (a state dict of zeros, f32) on ``tokens`` (``[1, 128]``
    ones) and returns the logits."""
    device = resolve_device(device)
    cfg = config or flagship_config()
    with torch.device("meta"):
        model = Qwen3Model(cfg)
    params = {name: torch.zeros(t.shape, dtype=torch.float32, device=device)
              for name, t in model.state_dict().items()}
    model = model.to_empty(device=device).eval()
    tokens = torch.ones((1, 128), dtype=torch.long, device=device)

    @torch.inference_mode()
    def fn(params, tokens):
        logits, _ = torch.func.functional_call(model, params, (tokens,))
        return logits

    return fn, (params, tokens)


# --------------------------------------------------------------------------
# the multi-device dry run (``__graft_entry__.dryrun_multichip``)
# --------------------------------------------------------------------------

# the JAX dry run's must-shard paths at the 8B geometry
MUST_SHARD = (
    r"(q|k|v|gate|up)_proj/base/kernel_q$",
    r"(o|down)_proj/base/kernel_q$",
    r"lm_head/kernel_q$",
    r"embed_tokens/embedding$",
)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> None:
    """One sharded LoRA training step of the reasoning core over a mesh of
    ``n_devices`` ranks, then the tensor-parallel int8 decode, data-parallel
    segmentation, the 8B shard plan and DP x TP serving, each against its
    unsharded run; rank 0 prints the JAX dry run's two lines.

    Runs inside the world when one is up (a test's, or torchrun's:
    ``torchrun --nproc-per-node N -m gvl_tpu_torch.entry --dryrun N``),
    else spawns ``n_devices`` processes that join a ``file://`` store.  The
    backend follows the layout (:func:`~gvl_tpu_torch.parallel.mesh.
    init_distributed`)."""
    import os
    import tempfile

    import torch.distributed as dist

    from gvl_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    resolve_device(device)
    if dist.is_initialized():
        _dryrun_rank(n_devices, device)
        return
    if "MASTER_ADDR" in os.environ:
        init_distributed(device=device)
        try:
            _dryrun_rank(n_devices, device)
        finally:
            shutdown_distributed()
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        mp.spawn(_spawned_rank, args=(n_devices, str(device), store), nprocs=n_devices)


def _spawned_rank(rank: int, n_devices: int, device: str, store: str) -> None:
    from gvl_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    torch.set_num_threads(1)
    init_distributed(init_method=store, world_size=n_devices, rank=rank,
                     local_rank=rank, local_world_size=n_devices, device=device)
    try:
        _dryrun_rank(n_devices, device)
    finally:
        shutdown_distributed()


def _dryrun_rank(n_devices: int, device) -> None:
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from gvl_tpu_torch.models.qwen3 import Qwen3Engine, quantize_int8
    from gvl_tpu_torch.parallel.mesh import MeshManager, build_mesh

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    model_axis = next(c for c in (8, 4, 2, 1) if n_devices % c == 0)
    mesh = build_mesh(n_devices // model_axis, model_axis, strict=True)
    mm = MeshManager(mesh)
    dev = mesh.device

    cfg = toy_config()
    batch = mm.pad_batch(2 * mm.data_size)
    loss, trained = dp_tp_lora_step(mesh, cfg, batch)

    # ---- tensor-parallel int8 serving path: one greedy decode against the
    # unsharded one
    qparams = quantize_int8(trained, cfg)
    cfg_q = dataclasses.replace(cfg, quant_int8=True, lora_rank=0)
    ref = Qwen3Engine(cfg_q, qparams, eos_token_id=-1, dtype=torch.float32, device=dev)
    expected = ref.generate([7, 3, 9], max_new_tokens=4, temperature=0.0)
    tp = Qwen3Engine(cfg_q, qparams, eos_token_id=-1, dtype=torch.float32, device=dev,
                     mesh=mesh)
    got = tp.generate([7, 3, 9], max_new_tokens=4, temperature=0.0)
    if got != expected:
        raise AssertionError(f"TP int8 decode mismatch: {got} != {expected}")

    # ---- data-parallel perception: frames split over a data-major mesh
    from gvl_tpu_torch.perception.segmenter import SAMConfig, TorchSegmenterBackend

    dp_mesh = build_mesh(n_devices, 1, strict=True)
    seg_cfg = SAMConfig(image_size=64)
    single = TorchSegmenterBackend(seg_cfg, device=dev)
    dp = TorchSegmenterBackend(seg_cfg, state=single.model.state_dict(), device=dev,
                               mesh=dp_mesh)
    frames = [np.random.RandomState(i).randint(0, 255, (48, 64, 3)).astype(np.uint8)
              for i in range(3)]
    a = single(frames, ["player"], [0, 1, 2])
    b = dp(frames, ["player"], [0, 1, 2])
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        for ca, cb in zip(fa, fb):
            if [d["mask"].bbox for d in ca] != [d["mask"].bbox for d in cb]:
                raise AssertionError("DP segmenter detections differ from one rank's")

    # ---- the 8B geometry's shard plan on the meta device
    stats = plan_8b(n_devices, build_mesh(1, n_devices, strict=True))

    # ---- DP x TP serving through the batching engine
    dp_tp_tokens = _dp_tp_serving_check(n_devices, cfg_q, qparams, dev)

    if rank == 0:
        print(
            f"dryrun_multichip OK: mesh={dict(mesh.shape)} "
            f"batch={batch} loss={loss:.4f} "
            f"tp_int8_decode={got} dp_perception_frames={len(b)} "
            f"dp_tp_serving={dp_tp_tokens}", flush=True)
        print(
            f"8B shard plan OK: model={n_devices} "
            f"params_sharded={stats['asserted']} "
            f"plan_s={stats['plan_s']:.1f} "
            f"(36L/4096d/32q8kv/ffn12288/int8, scan-layers, meta device)", flush=True)


def toy_config() -> Qwen3Config:
    """The JAX dry run's toy geometry (its KV heads divide every model size
    the dry run uses), with LoRA rank 4."""
    return Qwen3Config.tiny(
        hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=8,
        head_dim=16, intermediate_size=256, vocab_size=512, lora_rank=4,
    )


def dp_tp_lora_step(mesh, cfg: Qwen3Config, batch: int, seq: int = 16):
    """One AdamW step on the LoRA pairs of ``cfg``'s decoder (seeded weights,
    seeded tokens ``[batch, seq]``) over ``mesh``: each data replica takes
    its rows, the gradients are made whole and summed over data
    (:func:`~gvl_tpu_torch.parallel.sharding.reduce_gradients`).  Raises
    unless the loss, every gradient and every updated shard equal the
    one-process step's on the whole batch (within the bounds stated
    below); returns (loss, the one-process step's state dict)."""
    import numpy as np
    import torch.nn.functional as F

    from gvl_tpu_torch.models.qwen3 import init_jax_params, load_model
    from gvl_tpu_torch.parallel.collectives import all_reduce_sum
    from gvl_tpu_torch.parallel.mesh import MeshManager
    from gvl_tpu_torch.parallel.sharding import reduce_gradients, shard_state

    mm = MeshManager(mesh)
    dev = mm.device
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)),
                             device=dev)
    params = {k: v.to(dev) for k, v in
              init_jax_params(cfg, torch.Generator().manual_seed(0), device="cpu").items()}

    def lora_step(model, rows, total: int):
        """The loss of ``rows`` as a share of the mean over ``total``
        positions, its gradients and an optimizer over the LoRA pairs."""
        for name, p in model.named_parameters():
            p.requires_grad_(name.endswith(("lora_a", "lora_b")))
        opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad],
                                lr=1e-3, weight_decay=1e-4)
        logits, _ = model(rows)
        targets = torch.roll(rows, -1, dims=1)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size).float(),
                               targets[:, :-1].reshape(-1), reduction="sum") / total
        loss.backward()
        return opt, loss.detach()

    total = batch * (seq - 1)
    # the one-process step on the whole batch
    full = load_model(cfg, {k: v.clone() for k, v in params.items()}, dev)
    opt, want_loss = lora_step(full, tokens, total)
    want_grads = shard_state({n: p.grad for n, p in full.named_parameters()
                              if p.grad is not None}, mesh, cfg)
    opt.step()
    # the sharded step: this replica's rows, gradients summed over data
    per = batch // mm.data_size
    rows = tokens[mm.coords[0] * per:(mm.coords[0] + 1) * per]
    sharded = load_model(cfg, {k: v.clone() for k, v in params.items()}, dev, mesh)
    opt, loss = lora_step(sharded, rows, total)
    reduce_gradients(sharded, mesh)
    loss = float(all_reduce_sum(loss, mesh.data_group))
    if abs(loss - float(want_loss)) > 1e-5 * max(1.0, abs(float(want_loss))):
        raise AssertionError(f"DP x TP loss {loss} != one-process {float(want_loss)}")
    # each gradient within 1e-4 of its largest |value| (the sums' order differs)
    for name, p in sharded.named_parameters():
        if p.grad is None:
            continue
        want = want_grads[name]
        err = float((p.grad - want).abs().max())
        if err > 1e-4 * max(float(want.abs().max()), 1e-12):
            raise AssertionError(f"DP x TP gradient differs on {name}: max {err}")
    opt.step()
    # Adam's first step is near lr * sign(g): 1e-5 = lr / 100 admits only
    # the gradients that round near zero
    trained = {k: v.detach() for k, v in full.state_dict().items()}
    want = shard_state(trained, mesh, cfg)
    for name, p in sharded.state_dict().items():
        if not torch.allclose(p, want[name], atol=1e-5, rtol=0):
            raise AssertionError(f"DP x TP step differs on {name}: max "
                                 f"{float((p - want[name]).abs().max())}")
    return loss, trained


def plan_8b(n_devices: int, mesh) -> dict:
    """The 8B int8 ``scan_layers`` decoder's shards over ``model`` =
    ``n_devices`` on the meta device: every must-shard path (JAX's) cut over
    ``model`` (at least 9 of them), and the shapes a rank's model holds
    equal to those :func:`~gvl_tpu_torch.parallel.sharding.shard_state`
    cuts."""
    import re
    import time

    from gvl_tpu_torch.parallel.sharding import shard_state, state_specs, tree_path

    start = time.perf_counter()
    cfg = Qwen3Config(quant_int8=True, scan_layers=True, max_cache_length=4096, lora_rank=0)
    with torch.device("meta"):
        full = Qwen3Model(cfg).state_dict()
        local = Qwen3Model(cfg, mesh).state_dict()
    specs = state_specs(full, cfg, mesh.shape)
    asserted = 0
    for name, (spec, _) in specs.items():
        path, _ = tree_path(name, cfg.scan_layers)
        if any(re.search(p, path) for p in MUST_SHARD):
            if "model" not in spec:
                raise AssertionError(f"8B TP spec dropped on {path}: {spec} — dimension "
                                     f"not divisible by model={n_devices}?")
            asserted += 1
    if asserted < 9:
        raise AssertionError(f"only {asserted} 8B params matched TP rules")
    cut = shard_state(full, mesh, cfg)
    for name, t in local.items():
        if tuple(t.shape) != tuple(cut[name].shape):
            raise AssertionError(f"8B plan: {name} holds {tuple(t.shape)}, the cut "
                                 f"{tuple(cut[name].shape)}")
    return {"asserted": asserted, "plan_s": time.perf_counter() - start}


def _dp_tp_serving_check(n_devices: int, cfg_q, qparams, dev):
    """Concurrent requests through the continuous-batching engine on a
    (data=2, model=N/2) mesh, slots over data, weights over model: the
    unsharded engine's tokens."""
    from gvl_tpu_torch.parallel.mesh import build_mesh
    from gvl_tpu_torch.serving.batch_engine import ContinuousBatchingEngine

    prompts = [[7, 3, 9], [5, 11, 2, 8]]
    ref = ContinuousBatchingEngine(cfg_q, qparams, eos_token_id=-1, num_slots=2,
                                   dtype=torch.float32, temperature=0.0, device=dev)
    expected = ref.generate_many(prompts, max_new_tokens=4)
    if n_devices % 2:
        return expected  # odd meshes: DP x TP shape unavailable
    mesh = build_mesh(2, n_devices // 2, strict=True)
    engine = ContinuousBatchingEngine(cfg_q, qparams, eos_token_id=-1, num_slots=2,
                                      dtype=torch.float32, temperature=0.0, device=dev,
                                      mesh=mesh)
    got = engine.generate_many(prompts, max_new_tokens=4)
    if got != expected:
        raise AssertionError(f"dp x tp serving mismatch: {got} != {expected}")
    return got


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the port's entry checks")
    parser.add_argument("--dryrun", type=int, default=None, metavar="N",
                        help="the multi-device dry run over N ranks")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    fn, example = entry(args.device)
    print("entry OK:", tuple(fn(*example).shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
