"""gvl_tpu_torch.parallel against gvl_tpu.parallel, on the CPU.

The mesh's fitting (``_fit_axes``, ``build_mesh`` with and without
``strict``) against JAX's at 1 to 8 devices; ``build_mesh`` itself in one
world of four gloo processes (the ranks' coordinates and groups); the
collectives there, forward and backward; every parameter path's spec
against JAX's ``sharding_tree`` for the QA model, a LoRA tree and the 8B
int8 tree at model 2, 4 and 8; and rank ``(d, m)``'s ``shard_state``
slices against the shards JAX's ``shard_pytree`` puts on device ``(d, m)``
of its 8-device mesh.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import qwen3 as jq
from gvl_tpu.parallel import mesh as jmesh
from gvl_tpu.parallel import sharding as jshard
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_from_jax, params_to_jax
from gvl_tpu_torch.parallel import mesh as tmesh
from gvl_tpu_torch.parallel import sharding as tshard

import torch_mp_cases as cases
from torch_world import World

QA_CONFIG = Path(__file__).resolve().parents[1] / "outputs" / "qa_lm" / "qa_lm_config.json"


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.mark.parametrize("n", range(1, 9))
def test_fit_axes_matches_jax(n):
    for data, model in ((1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (1, 8), (8, 1),
                        (3, 3), (1, 6), (4, 8)):
        assert tmesh._fit_axes(data, model, n) == jmesh._fit_axes(data, model, n)


REQUESTS = [(1, 1, False), (2, 2, False), (1, 4, False), (4, 1, False), (2, 4, False),
            (8, 8, False), (1, 3, False), (2, 2, True), (2, 4, True), (1, 1, True)]


def test_build_mesh_in_a_world_matches_jax(world):
    """Shapes as JAX fits them to four devices (strict ones raising JAX's
    message); rank r at (r // m, r % m), its row the model group, its
    column the data group; gloo named by ``describe``."""
    devices = jax.devices()[:4]
    got = world.run(cases.mesh_layouts, REQUESTS)
    for i, (data, model, strict) in enumerate(REQUESTS):
        try:
            want = dict(jmesh.build_mesh(data, model, devices=devices, strict=strict).shape)
        except ValueError as exc:
            assert all(r[i] == str(exc) for r in got)
            continue
        for rank, per_rank in enumerate(got):
            shape, coords, data_ranks, model_ranks, desc = per_rank[i]
            m = want["model"]
            assert shape == want
            assert tuple(coords) == (rank // m, rank % m)
            assert model_ranks == list(range(rank // m * m, rank // m * m + m))
            assert data_ranks == list(range(rank % m, 4, m))
            assert "gloo" in desc and f"{shape['data']}x{m}" in desc


def test_collectives_forward_and_backward(world):
    got = world.run(cases.collectives)
    x = [np.arange(3.0) + 10 * r for r in range(4)]
    for rank, out in enumerate(got):
        row, col = rank // 2, rank % 2
        np.testing.assert_array_equal(out["reduce_model"], x[2 * row] + x[2 * row + 1])
        np.testing.assert_array_equal(out["reduce_data"], x[col] + x[col + 2])
        np.testing.assert_array_equal(out["gather_model"], np.stack(x[2 * row:2 * row + 2]))
        # the data ring of column col is (col, col + 2): each receives the other's
        np.testing.assert_array_equal(out["shift_data"], x[(rank + 2) % 4])
        assert out["broadcast"] == {"rank": 0, "list": [0, 0]}
        assert out["reference_loaded"] == []      # the ranks import no JAX
        assert out["bool_batch"] == [col == 0] * 2   # column col: ranks col, col + 2
        # L = sum_m (c_m + 1) x . w_m with c = (1, 2) over the row's ranks
        np.testing.assert_array_equal(out["grad_w"], np.full(3, 2.0 + col))
        w_row = [2 * row + 1, 2 * row + 2]
        np.testing.assert_array_equal(out["grad_x"], np.full(3, 2.0 * w_row[0] + 3.0 * w_row[1]))


def test_init_distributed_single_process_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() is False
    mm = tmesh.MeshManager.single_device(device="cpu")
    assert (mm.data_size, mm.model_size, mm.num_devices) == (1, 1, 1)
    assert mm.pad_batch(5) == 5 and "no world" in mm.describe()
    assert tmesh.MeshManager(tmesh.build_mesh(2, 4, device="cpu")).num_devices == 1


def test_rules_are_jax_verbatim():
    for port, jax_rules in ((tshard.LLM_RULES, jshard.LLM_RULES),
                            (tshard.VIT_RULES, jshard.VIT_RULES)):
        assert [(p.pattern, tuple(s)) for p, s in port.rules] == \
            [(p.pattern, tuple(s)) for p, s in jax_rules.rules]


def _qa_config(lib):
    fields = json.loads(QA_CONFIG.read_text())
    return lib.Qwen3Config(**{k: v for k, v in fields.items()
                              if k in {f.name for f in dataclasses.fields(lib.Qwen3Config)}})


def _tree(kind):
    """(JAX params shapes, JAX config, port config) of each tree."""
    if kind == "qa":
        jcfg, tcfg = _qa_config(jq), _qa_config(tq)
    elif kind == "lora":
        jcfg = jq.Qwen3Config.tiny(num_heads=8, num_kv_heads=4, lora_rank=4)
        tcfg = tq.Qwen3Config.tiny(num_heads=8, num_kv_heads=4, lora_rank=4)
    else:   # the 8B int8 tree, stacked, as the JAX dry run compiles it
        jcfg = jq.Qwen3Config(scan_layers=True, max_cache_length=4096, lora_rank=0)
        tcfg = tq.Qwen3Config(scan_layers=True, max_cache_length=4096, lora_rank=0,
                              quant_int8=True)
    raw = jax.eval_shape(lambda: jq.Qwen3Model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32)))["params"]
    if kind == "8b":
        raw = jax.eval_shape(lambda p: jq.quantize_int8(p, jcfg), raw)
    return raw, tcfg


@pytest.fixture(scope="module")
def trees():
    return {kind: _tree(kind) for kind in ("qa", "lora", "8b")}


@pytest.mark.parametrize("kind", ["qa", "lora", "8b"])
@pytest.mark.parametrize("model", [2, 4, 8])
def test_specs_match_jax_sharding_tree(trees, kind, model):
    """Every path's spec equals JAX's; every port tensor's JAX path is a
    path of JAX's tree with the port's shape (transposed where swapped) and
    takes JAX's spec, but for the layers the model keeps whole (attention
    whose KV heads do not divide, as JAX's cache rule)."""
    raw, tcfg = trees[kind]
    mesh = jmesh.build_mesh(8 // model, model)
    want = {path: tuple(s.spec) for path, _, s in
            jshard._flatten_with_paths(jshard.sharding_tree(raw, mesh, jshard.LLM_RULES))}
    shapes = {path: leaf.shape for path, _, leaf in jshard._flatten_with_paths(raw)}
    mesh_shape = {"data": 8 // model, "model": model}
    assert tshard.sharding_tree(shapes, mesh_shape, tshard.LLM_RULES) == want
    assert tshard.tree_paths({"a": {"b": 1, "c": [2, 3]}}) == ["a/b", "a/c/0", "a/c/1"]
    with torch.device("meta"):
        state = tq.Qwen3Model(tcfg).state_dict()
    specs = tshard.state_specs(state, tcfg, mesh_shape)
    assert len(specs) == len(want)
    kept_whole = 0
    for name, (spec, swapped) in specs.items():
        path, _ = tshard.tree_path(name, tcfg.scan_layers)
        assert tshard.tree_shape(state[name].shape, swapped) == tuple(shapes[path]), name
        if tshard.tp_replicated(name, tcfg, model):
            assert spec == ()
            kept_whole += want[path] != ()
        else:
            assert spec == want[path], name
    # attention is whole where the KV heads do not divide (the QA model's 5
    # at every size, the LoRA tree's 4 at model 8); JAX cuts its q/k/v/o
    assert (kept_whole > 0) == (tcfg.num_kv_heads % model != 0)
    assert kind != "qa" or kept_whole > 0


def _jax_shards(leaf, mesh):
    """{(d, m): numpy block} of a placed JAX array."""
    where = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(mesh.devices)}
    return {where[s.device.id]: np.asarray(s.data) for s in leaf.addressable_shards}


@pytest.mark.parametrize("variant", ["plain", "int8", "lora", "scan"])
def test_shard_state_matches_jax_addressable_shards(variant):
    """Rank (d, m)'s slices equal the block JAX's ``shard_pytree`` puts on
    device (d, m), transposed into the port's layout where JAX's kernel is
    [in, out]."""
    kw = dict(num_heads=8, num_kv_heads=8, intermediate_size=256, vocab_size=512)
    if variant == "lora":
        kw["lora_rank"] = 4
    if variant == "scan":
        kw["scan_layers"] = True
    jcfg, tcfg = jq.Qwen3Config.tiny(**kw), tq.Qwen3Config.tiny(**kw)
    # Flax's laws drawn by the port, in JAX's tree (no JAX compile)
    params = params_to_jax(tq.init_jax_params(tcfg, torch.Generator().manual_seed(0),
                                              device="cpu"), tcfg)
    if variant == "lora":   # non-zero B, so that its blocks are told apart
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.5 if getattr(p[-1], "key", "") == "lora_b" else x, params)
    if variant == "int8":
        params = jq.quantize_int8(params, jcfg)
        tcfg = dataclasses.replace(tcfg, quant_int8=True)
    state = params_from_jax(params, tcfg)
    for shape in ((2, 4), (1, 8)):
        mesh = jmesh.build_mesh(*shape)
        placed = jshard.shard_pytree(params, mesh, jshard.LLM_RULES)
        blocks = {path: _jax_shards(leaf, mesh)
                  for path, _, leaf in jshard._flatten_with_paths(placed)}
        mesh_shape = {"data": shape[0], "model": shape[1]}
        for coords in [(d, m) for d in range(shape[0]) for m in range(shape[1])]:
            mine = tshard.shard_state(state, None, tcfg, coords=coords, mesh_shape=mesh_shape)
            for name, t in mine.items():
                path, swapped = tshard.tree_path(name, tcfg.scan_layers)
                want = blocks[path][coords]
                if swapped:
                    want = np.swapaxes(want, -1, -2)
                np.testing.assert_array_equal(t.numpy(), want, err_msg=f"{name} at {coords}")
