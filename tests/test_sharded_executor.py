"""Mesh-sharded graph executor (multi-chip serving, BASELINE config 5).

Runs on the 8-virtual-device CPU mesh (conftest). The contract: an
Executor built with a (data, model) mesh produces the same tap outputs as
the single-device executor — captures TP-shard per
``parallel/mesh.param_spec``, ``run_stacked`` micro-batches shard over
"data", and XLA GSPMD inserts the collectives.
"""

import numpy as np
import pytest

import jax

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.models import vit
from interactive_vit_tpu.models.vit_plugin import make_vit_model
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.parallel.mesh import make_mesh
from interactive_vit_tpu.wire.schema import GraphLibrary, graph_from_json

CFG = vit.ViTConfig("vit_mesh", img_size=32, patch=16, width=64,
                    depth=2, heads=4, num_classes=16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    vit.VARIANTS["vit_mesh"] = CFG
    reg = Registry()
    register_builtin(reg)
    lib = GraphLibrary(str(tmp_path_factory.mktemp("graphs")))
    # attn_impl=None: the mesh path serves the GSPMD-partitionable plain
    # attention path
    make_vit_model("vit_mesh").register(reg, lib)
    yield reg, lib
    del vit.VARIANTS["vit_mesh"]


def _graph(lib, rng_seed=0):
    g = graph_from_json(lib.load("vit_mesh.json"))
    img = np.random.default_rng(rng_seed).random((3, 32, 32)).astype(
        np.float32)
    g.add_input(img, g.nodes[0], "o")
    return g


def _flatten(outs):
    return {
        (i, ch): np.asarray(v)
        for i, sub in outs.items() for ch, v in sub.items()
    }


@pytest.mark.parametrize("axes", [
    {"data": 8, "model": 1},
    {"data": 1, "model": 2},
    {"data": 4, "model": 2},
])
def test_single_request_matches_unsharded(setup, axes):
    reg, lib = setup
    ref = Executor(reg=reg).run(_graph(lib), taps="primary")
    mesh = make_mesh(axes)
    got = Executor(reg=reg, mesh=mesh).run(_graph(lib), taps="primary")
    ref_f, got_f = _flatten(ref), _flatten(got)
    assert ref_f.keys() == got_f.keys()
    for k in ref_f:
        np.testing.assert_allclose(got_f[k], ref_f[k], atol=1e-5,
                                   err_msg=str(k))


def test_stacked_batch_shards_over_data(setup):
    reg, lib = setup
    graphs = [_graph(lib, seed) for seed in range(5)]
    ref = Executor(reg=reg).run_stacked(
        [_graph(lib, s) for s in range(5)], taps="primary")
    mesh = make_mesh({"data": 4, "model": 2})
    ex = Executor(reg=reg, mesh=mesh)
    got = ex.run_stacked(graphs, taps="primary")
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        rf, gf = _flatten(r), _flatten(g)
        assert rf.keys() == gf.keys()
        for k in rf:
            np.testing.assert_allclose(gf[k], rf[k], atol=1e-5,
                                       err_msg=str(k))
    # second submit hits the compiled-program cache
    ex.run_stacked([_graph(lib, 9)] * 3, taps="primary")
    assert not ex.last_stats.cache_hit  # 3 -> bucket 4, same as 5? no: 5->8
    ex.run_stacked([_graph(lib, 10)] * 3, taps="primary")
    assert ex.last_stats.cache_hit


def test_captures_actually_sharded(setup):
    """TP leaves (qkv_w) really live sharded on the model axis."""
    reg, lib = setup
    mesh = make_mesh({"data": 4, "model": 2})
    ex = Executor(reg=reg, mesh=mesh)
    ex.run(_graph(lib), taps="primary")
    _, _, caps = next(iter(ex._cache.values()))
    leaves = jax.tree.leaves(caps)
    sharded = [
        x for x in leaves
        if hasattr(x, "sharding") and not x.sharding.is_fully_replicated
    ]
    assert sharded, "expected at least one TP-sharded capture leaf"


def test_quantized_captures_tp_shard():
    """int8 weight leaves shard like their dense parents (param_spec
    resolves .../qkv_w/int8_q to the dense qkv_w spec)."""
    from jax.sharding import PartitionSpec as P

    from interactive_vit_tpu.parallel.mesh import param_spec

    assert param_spec("blocks/0/qkv_w/int8_q") == P(None, "model")
    assert param_spec("blocks/0/qkv_w/int8_s") == P("model")
    assert param_spec("blocks/0/proj_w/int8_q") == P("model", None)
    assert param_spec("blocks/0/proj_w/int8_s") == P(None)
    assert param_spec("head/w/int8_q") == P()

    # and physically, through the executor: quantized vit graph on a mesh
    from interactive_vit_tpu.ops.quant import QKEY
    import jax.numpy as jnp

    params = vit.init_params(jax.random.key(0), CFG)
    from interactive_vit_tpu.ops.quant import quantize_tree
    qp = quantize_tree(params)
    mesh = make_mesh({"data": 4, "model": 2})
    from interactive_vit_tpu.parallel.mesh import shard_params
    placed = shard_params(qp, mesh)
    q_leaf = placed["blocks"][0]["qkv_w"][QKEY]
    assert not q_leaf.sharding.is_fully_replicated
    np.testing.assert_array_equal(
        np.asarray(q_leaf), np.asarray(qp["blocks"][0]["qkv_w"][QKEY]))


def test_mesh_output_shardings_pinned(setup):
    """Mesh-mode jit pins entry-output shardings: stacked outputs shard
    their bucket dim over "data", single-request taps replicate."""
    from jax.sharding import PartitionSpec as P

    from interactive_vit_tpu.graph.executor import mesh_out_spec

    mesh = make_mesh({"data": 4, "model": 2})
    assert mesh_out_spec((8, 3, 5), mesh, batched=True) == P("data")
    assert mesh_out_spec((5, 3), mesh, batched=True) == P()  # indivisible
    assert mesh_out_spec((8, 3), mesh, batched=False) == P()
    assert mesh_out_spec((), mesh, batched=True) == P()

    reg, lib = setup
    ex = Executor(reg=reg, mesh=mesh)
    flat = ex.run_stacked([_graph(lib, s) for s in range(4)],
                          taps="primary", defer=True)
    try:
        for key, arr in flat.items():
            spec = arr.sharding.spec
            assert spec[0] == "data", f"{key}: {spec}"
    finally:
        jax.block_until_ready(list(flat.values()))

    flat1 = ex.run(_graph(lib), taps="primary", defer=True)
    try:
        for key, arr in flat1.items():
            assert arr.sharding.is_fully_replicated, \
                f"{key}: {arr.sharding}"
    finally:
        jax.block_until_ready(list(flat1.values()))


def test_serving_app_on_mesh(tmp_path):
    """build_app(mesh_spec=...) serves a compute round-trip end-to-end."""
    from interactive_vit_tpu.serving.server import build_app
    from interactive_vit_tpu.wire.codec import Request, Response

    app = build_app(models=("vit_t16",), graphs_dir=str(tmp_path),
                    mesh_spec="data=4,model=2", dtype_name="float32")
    obj = app.graphs.load("vit_t16.json")
    g = graph_from_json(obj)
    img = np.random.default_rng(1).random((3, 224, 224)).astype(np.float32)
    g.add_input(img, g.nodes[0], "o")
    body = app.compute(Request.encode(g))
    outs = Response.decode(body)
    assert len(outs) >= 16
    logits = [v for sub in outs.values() for v in sub.values()]
    assert all(np.isfinite(v).all() for v in logits)


def test_head_major_tp_layout_matches_baseline():
    """permute_qkv_head_major + qkv_head_major=True is numerically the
    same model (the mesh TP column sharding is then head-ALIGNED — the
    actual Megatron split; parallel/mesh.py docstring)."""
    import jax
    import jax.numpy as jnp

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.parallel.mesh import permute_qkv_head_major

    cfg = vit.ViTConfig("vit_hm", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=7)
    params = vit.init_params(jax.random.key(3), cfg)
    x = jnp.asarray(np.random.default_rng(0).random(
        (2, 3, 32, 32), dtype=np.float32))

    base = vit.forward(params, x, cfg, want_attn=True)
    perm = permute_qkv_head_major(params, cfg.heads)
    got = vit.forward(perm, x, cfg, want_attn=True, qkv_head_major=True)

    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(base["logits"]), atol=1e-5)
    for a, b in zip(got["attn"], base["attn"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got["rollout"]),
                               np.asarray(base["rollout"]), atol=1e-5)


def test_mesh_stacked_mixed_dynamic_values(setup):
    """Mixed dynamic values stack under a (data, model) mesh too: the
    stacked captures place replicated; GSPMD shards the batch axis."""
    from interactive_vit_tpu.graph.ir import Graph

    reg, _lib = setup
    mesh = make_mesh({"data": 4, "model": 2})
    ex = Executor(reg=reg, mesh=mesh)

    def cos_graph(a):
        g = Graph()
        n = g.add_node("cos", {"A": str(a)})
        g.add_input(np.linspace(0, 1, 8).astype(np.float32), n, "o")
        return g

    a_vals = [0.5, 1.5, 2.5, 3.5]
    res = ex.run_stacked([cos_graph(a) for a in a_vals], taps="all")
    x = np.linspace(0, 1, 8)
    for i, a in enumerate(a_vals):
        np.testing.assert_allclose(np.asarray(res[i][0]["o"]),
                                   np.cos(a * x), rtol=1e-5)


def test_mesh_selective_head_taps(setup):
    """attn_heads works through the mesh executor (GSPMD XLA path): the
    served tap shrinks to the selected heads and matches the full tap's
    slices."""
    from interactive_vit_tpu.wire.schema import graph_from_json

    reg, lib = setup
    mesh = make_mesh({"data": 4, "model": 2})
    ex = Executor(reg=reg, mesh=mesh)

    def graph(heads_param):
        g = graph_from_json(lib.load("vit_mesh.json"))
        img = np.random.default_rng(0).random((3, 32, 32)).astype(
            np.float32)
        g.add_input(img, g.nodes[0], "o")
        # find the first block node and set the param
        for n in g.nodes:
            if n.name.endswith(":blocks.0"):
                if heads_param:
                    n.params["attn_heads"] = heads_param
                return g, n.index
        raise AssertionError("no block node")

    g_full, bi = graph(None)
    full = np.asarray(ex.run(g_full, taps=[(bi, "attn")])[bi]["attn"])
    g_sel, bi = graph("[1,3]")
    sel = np.asarray(ex.run(g_sel, taps=[(bi, "attn")])[bi]["attn"])
    assert sel.shape[1] == 2 and full.shape[1] == CFG.heads
    np.testing.assert_allclose(sel, full[:, [1, 3]], atol=1e-5)
