"""What the ranks of a test's gloo world run (``torch_world.World.run``).

Each function runs on every rank of the world, with the same arguments,
and returns this rank's result as numpy arrays or plain values; the test
process compares them with JAX's.  Nothing here imports JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------------- mesh

def mesh_layouts(requests) -> list:
    """(shape, coords, data ranks, model ranks, describe) of each
    ``(data, model, strict)`` request, or the error's text."""
    from gvl_tpu_torch.parallel.mesh import MeshManager, build_mesh

    out = []
    for data, model, strict in requests:
        try:
            mesh = build_mesh(data, model, strict=strict, device="cpu")
        except ValueError as exc:
            out.append(str(exc))
            continue
        out.append((dict(mesh.shape), mesh.coords, mesh.data_ranks, mesh.model_ranks,
                    MeshManager(mesh).describe()))
    return out


def collectives() -> dict:
    """Each collective on a 2 x 2 mesh, forward and backward."""
    from gvl_tpu_torch.parallel import collectives as c
    from gvl_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(2, 2, device="cpu")
    rank = dist.get_rank()
    x = torch.arange(3.0) + 10 * rank
    out = {
        "reduce_model": _np(c.all_reduce_sum(x, mesh.model_group)),
        "reduce_data": _np(c.all_reduce_sum(x, mesh.data_group)),
        "gather_model": _np(c.all_gather_cat(x[None], 0, mesh.model_group)),
        "shift_data": _np(c.ring_shift(x, mesh.data_group, mesh.data_ranks)),
        "broadcast": c.broadcast_objects({"rank": rank, "list": [rank] * 2}),
        "bool_batch": c.gather_batch(torch.tensor([rank % 2 == 0]), mesh, 2).tolist(),
        "reference_loaded": sorted({m.split(".")[0] for m in sys.modules}
                                   & {"jax", "jaxlib", "flax", "optax", "gvl_tpu"}),
    }
    # gradients: a whole input made this rank's piece (copy_to_group), the
    # pieces gathered (column-parallel) and summed (row-parallel)
    w = torch.full((3,), float(rank + 1), requires_grad=True)
    xin = torch.ones(3, requires_grad=True)
    z = c.copy_to_group(xin, mesh.model_group) * w
    g = c.all_gather_cat(z[None], 0, mesh.model_group)
    y = c.all_reduce_sum(z, mesh.model_group)
    ((g * torch.tensor([[1.0], [2.0]])).sum() + y.sum()).backward()
    out["grad_w"], out["grad_x"] = _np(w.grad), _np(xin.grad)
    return out


# ---------------------------------------------------------------- decoder

def _mesh(data: int, model: int):
    from gvl_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(data, model, strict=True, device="cpu")


def tp_logits(cfg, state, data: int, model: int, tokens) -> np.ndarray:
    """Whole logits of a tensor-parallel forward, and its cached prefill."""
    from gvl_tpu_torch.models.qwen3 import load_model

    model_ = load_model(cfg, state, "cpu", _mesh(data, model))
    with torch.inference_mode():
        logits, _ = model_(torch.as_tensor(tokens))
    return _np(logits)


def tp_generate(cfg, state, data: int, model: int, prompt, n: int, kind: str = "engine",
                temperature: float = 0.0, gamma: int = 3):
    """Greedy (or seeded sampled) tokens of one engine at a mesh."""
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.models.speculative import PromptLookupEngine, SpeculativeEngine

    mesh = _mesh(data, model) if data * model > 1 else None
    kw = dict(eos_token_id=-1, dtype=torch.float32, device="cpu", mesh=mesh)
    if kind == "engine":
        engine = Qwen3Engine(cfg, state, **kw)
    elif kind == "session":
        engine = Qwen3ChatSession(cfg, state, **kw)
    elif kind == "speculative":
        engine = SpeculativeEngine(cfg, state, cfg, state, gamma=gamma, **kw)
    else:
        engine = PromptLookupEngine(cfg, state, gamma=gamma, **kw)
    gen = torch.Generator().manual_seed(3)
    if kind == "session":
        first = engine.generate(prompt, max_new_tokens=n, temperature=temperature,
                                generator=gen)
        second = engine.generate(prompt + first + [5, 6], max_new_tokens=n,
                                 temperature=temperature, generator=gen)
        return [first, second, engine.last_ingested]
    return engine.generate(prompt, max_new_tokens=n, temperature=temperature, generator=gen)


def batch_generate(cfg, state, data: int, model: int, prompts, n: int,
                   temperature: float = 0.0, slots: int = 4, sessions: bool = False):
    """The batching engine's tokens for ``prompts`` (all submitted on every
    rank; with ``sessions``, a second round that reuses each slot's
    prefix), and the prefilled counts."""
    from gvl_tpu_torch.serving.batch_engine import ContinuousBatchingEngine

    mesh = _mesh(data, model) if data * model > 1 else None
    engine = ContinuousBatchingEngine(cfg, state, eos_token_id=-1, num_slots=slots,
                                      dtype=torch.float32, temperature=temperature,
                                      device="cpu", mesh=mesh)
    if not sessions:
        return engine.generate_many(prompts, n)
    keys = [f"s{i}" for i in range(len(prompts))]
    ids = [engine.submit(p, n, session_key=k) for p, k in zip(prompts, keys)]
    first = engine.run()
    again = [p + first[i] + [9] for p, i in zip(prompts, ids)]
    ids2 = [engine.submit(p, n, session_key=k) for p, k in zip(again, keys)]
    second = engine.run()
    return ([first[i] for i in ids], [second[i] for i in ids2],
            [engine._requests[i].prefilled for i in ids2])


def _engine(cfg, state, data: int, model: int, slots: int, temperature: float):
    from gvl_tpu_torch.serving.batch_engine import ContinuousBatchingEngine

    mesh = _mesh(data, model) if data * model > 1 else None
    return ContinuousBatchingEngine(cfg, state, eos_token_id=-1, num_slots=slots,
                                    dtype=torch.float32, temperature=temperature,
                                    device="cpu", mesh=mesh)


def lockstep_sessions(cfg, state, data: int, model: int, prompts, n: int,
                      temperatures=(0.0,)) -> list[dict]:
    """For each temperature, chat turns through the engine's step on every
    rank (rank 0 queues them): session a's two turns, then b's, at
    ``max_sessions`` 1 (b's first turn evicts a), beside ``generate``
    requests submitted on every rank.  Rank 0 returns the turns' tokens and
    prefilled counts; every rank its table of sessions after each step and
    each session's transcript."""
    return [_lockstep_sessions(cfg, state, data, model, prompts, n, t)
            for t in temperatures]


def _lockstep_sessions(cfg, state, data, model, prompts, n, temperature) -> dict:
    engine = _engine(cfg, state, data, model, 2, temperature)
    engine.max_sessions = 1
    leader = not dist.is_initialized() or dist.get_rank() == 0
    out = {"turns": [], "tables": []}

    def step(*turns):
        queued = [engine.submit_turn(sid, ids, n, temperature=temperature)
                  for sid, ids in turns] if leader else []
        engine.step()
        out["tables"].append(list(engine.sessions))
        for turn in queued:
            assert turn.done and turn.error is None, turn.error
            out["turns"].append((turn.tokens, turn.prefilled))
        return [t.tokens for t in queued]

    ids = [engine.submit(p, n) for p in prompts]
    if leader:
        a1, = step(("a", prompts[0]))
        _, b1 = step(("a", prompts[0] + a1 + [5, 6]), ("b", prompts[1]))
        step(("b", prompts[1] + b1 + [7]))
    else:
        for _ in range(3):
            step()
    out["generated"] = [engine.run()[i] for i in ids]
    out["cached"] = {sid: s._cached for sid, s in engine.sessions.items()}
    return out


def _trip_prefill(engine, on, nth: int = 1) -> None:
    """The ``nth`` prefill raises, on the ranks ``on(slot)`` picks (as
    JAX's ``TestPrefillFailureAttribution`` wraps its prefill)."""
    real, calls = engine._prefill, []

    def flaky(slot, delta):
        calls.append(slot)
        if len(calls) == nth and on(slot):
            raise RuntimeError("injected prefill error")
        return real(slot, delta)

    engine._prefill = flaky


def prefill_failure(cfg, state, data: int, model: int, prompts, n: int, where: str,
                    bad: int = 0, temperatures=(0.0,)) -> list[dict]:
    """For each temperature, two requests on two slots whose ``bad``-th
    prefill fails, ``where`` "every" rank or on the slot's "owner" replica
    only; then ``generate_many(prompts)``.  Every request's tokens and
    whether it failed, then the tokens of the run after."""
    return [_prefill_failure(cfg, state, data, model, prompts, n, where, bad, t)
            for t in temperatures]


def _prefill_failure(cfg, state, data, model, prompts, n, where, bad, temperature) -> dict:
    engine = _engine(cfg, state, data, model, 2, temperature)
    _trip_prefill(engine, (lambda slot: True) if where == "every" else engine._owns,
                  nth=bad + 1)
    ids = [engine.submit(p, n) for p in prompts[:2]]
    results = engine.run()
    first = [(results[i], engine._requests[i].error is not None) for i in ids]
    return {"first": first, "after": engine.generate_many(prompts, n)}


def decode_failure(cfg, state, data: int, model: int, prompts, n: int) -> dict:
    """The served path: rank 0's ``EngineServer`` drives, the other ranks
    :meth:`follow`.  A chat session that rank 1 alone cannot open fails its
    turn on every rank, and its next turn answers.  The decode step with
    both slots live raises on every rank: both streams fail, on every rank,
    and the server then answers ``prompts`` concurrently.  Every rank
    returns which requests failed and its table of sessions; rank 0 the
    chat turns' outcomes."""
    from concurrent.futures import ThreadPoolExecutor

    from gvl_tpu_torch.serving.engine_server import EngineError, EngineServer

    engine = _engine(cfg, state, data, model, 2, 0.0)
    tripped = []

    def trip(module, args):
        if not tripped and all(r is not None for r in engine._slot_req):
            tripped.append(1)
            raise RuntimeError("injected device error")

    engine.model.register_forward_pre_hook(trip)
    if dist.get_rank() == 1:
        real = engine._new_session

        def short_of_memory():
            engine._new_session = real
            raise RuntimeError("injected allocation error")

        engine._new_session = short_of_memory
    out = {}
    if dist.get_rank() == 0:
        server = EngineServer(engine)

        def generate(prompt, m=n):
            try:
                return server.generate(prompt, m)
            except EngineError as exc:
                return str(exc)

        try:
            out["chat"] = []
            for _ in range(2):
                try:
                    out["chat"].append(server.chat("s", prompts[0], n))
                except EngineError as exc:
                    out["chat"].append(str(exc))
            with ThreadPoolExecutor(2) as pool:
                out["failed"] = list(pool.map(lambda p: generate(p, 40), prompts[:2]))
            with ThreadPoolExecutor(len(prompts)) as pool:
                out["after"] = list(pool.map(generate, prompts))
        finally:
            server.shutdown()
            engine.release_followers()
    else:
        engine.follow()
    out["errors"] = {i: r.error is not None for i, r in engine._requests.items()}
    out["tripped"] = len(tripped)
    out["sessions"] = list(engine.sessions)
    return out


def vl_generate(vision_cfg, text_cfg, state, data: int, model: int, ids, patches, grid,
                n: int, image_token_id: int, mrope_section):
    from gvl_tpu_torch.models.qwen3vl import Qwen3VL

    vl = Qwen3VL(vision_cfg, text_cfg, state, image_token_id=image_token_id,
                 mrope_section=mrope_section, device="cpu", mesh=_mesh(data, model))
    return vl.generate(ids, patches, grid, max_new_tokens=n, temperature=0.0,
                       eos_token_id=-1, cache_dtype=torch.float32)


# ------------------------------------------------------------------- ring

def ring(q, k, v, causal: bool, data: int, model: int) -> dict:
    """This rank's rows of ring attention over ``data`` (q/k/v whole here,
    sliced by rank), and its rows of dq, dk, dv of ``sum(out ** 2)``."""
    from gvl_tpu_torch.ops.ring_attention import ring_attention

    mesh = _mesh(data, model)
    d = mesh.data_index
    per = q.shape[2] // data
    parts = [torch.tensor(x[:, :, d * per:(d + 1) * per], requires_grad=True)
             for x in (q, k, v)]
    out = ring_attention(*parts, mesh, axis_name="data", causal=causal)
    (out ** 2).sum().backward()
    return {"out": _np(out), "dq": _np(parts[0].grad), "dk": _np(parts[1].grad),
            "dv": _np(parts[2].grad)}


# ------------------------------------------------------------- perception

def _box(b):
    return (b.x_min, b.y_min, b.x_max, b.y_max)


def segment(seg_cfg, state, data: int, frames, concepts):
    """Detections (score, bbox, mask area) of the segmenter at ``data``
    replicas (1: no mesh)."""
    from gvl_tpu_torch.perception.segmenter import TorchSegmenterBackend

    mesh = _mesh(data, dist.get_world_size() // data) if data > 1 else None
    backend = TorchSegmenterBackend(seg_cfg, state=state, device="cpu", mesh=mesh)
    out = backend(frames, concepts, list(range(len(frames))))
    return [[[(d["mask"].confidence, _box(d["mask"].bbox), d["mask"].area_pixels)
              for d in per_concept] for per_concept in frame] for frame in out]


def siglip(vision_cfg, state, data: int, batch, fused: bool, pool: str = "mean"):
    """Pooled embeddings of the SigLIP backend (``fused``: the W8A8 tower)
    at ``data`` replicas."""
    from gvl_tpu_torch.models.siglip import load_tower
    from gvl_tpu_torch.perception.semantic import (
        FusedSigLIPBackend,
        TorchSigLIPBackend,
        noise_pixels,
    )

    mesh = _mesh(data, dist.get_world_size() // data) if data > 1 else None
    tower = load_tower(vision_cfg, state, "cpu")
    if fused:
        backend = FusedSigLIPBackend(
            tower, calib_pixels=noise_pixels(4, vision_cfg.image_size, "cpu"),
            pool_strategy=pool, mesh=mesh)
    else:
        backend = TorchSigLIPBackend(tower, "float32", pool_strategy=pool, mesh=mesh)
    return backend(batch)[1]


def stack_builders(preset, data: int, frames):
    """``build_perception_stack(mesh=)``: the segmenter's detection counts
    and the encoder's whole-image embeddings."""
    from gvl_tpu_torch.perception.batch import build_perception_stack

    mesh = _mesh(data, dist.get_world_size() // data) if data > 1 else None
    segmenter, encoder, _ = build_perception_stack(preset, device="cpu", mesh=mesh)
    counts = [[len(c) for c in f] for f in segmenter.backend(frames, ["player"],
                                                             list(range(len(frames))))]
    return counts, encoder.encode_images_batch(frames)


# ------------------------------------------------------------------ entry

def dryrun(n: int) -> str:
    """What ``dryrun_multichip(n)`` prints on this rank."""
    import contextlib
    import io

    from gvl_tpu_torch.entry import dryrun_multichip

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(n, device="cpu")
    return out.getvalue()


def lora_step(data: int, model: int) -> float:
    from gvl_tpu_torch.entry import dp_tp_lora_step, toy_config

    mesh = _mesh(data, model)
    return dp_tp_lora_step(mesh, toy_config(), 2 * data)[0]


def plan_8b(model: int) -> int:
    from gvl_tpu_torch.entry import plan_8b as plan

    return plan(model, _mesh(dist.get_world_size() // model, model))["asserted"]
