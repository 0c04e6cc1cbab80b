"""AOT graph export (graph/export.py + the ivt-export / ivt-run-exported
CLIs): the staged program serialized via jax.export must reload and run
with numeric parity, WITHOUT the node registry or model code.

The reference has no deployment artifact at all (saved graphs are
topology only, ``/root/reference/main/views.py:21-30``) — this subsystem
is beyond-reference surface, so the contracts pinned here are our own:
artifact round-trip parity, dynamic-capture edits post-export, and the
model-code-free load path.
"""

import json
import os

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor, shape_struct
from interactive_vit_tpu.graph.export import (
    ExportedGraph, ExportError, export_graph, load_artifact,
)
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.ops.node_ops import register_builtin


@pytest.fixture
def reg():
    r = Registry()
    register_builtin(r)
    return r


def chain(x):
    """cos -> binop(+ const) chain over input x."""
    g = Graph()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    k = g.add_node("const", {"value": "0.25",
                             "dims": json.dumps(list(x.shape))})
    b = g.add_node("binop", {"op": "+"})
    g.connect(c, "o", b, "a")
    g.connect(k, "o", b, "b")
    g.add_input(x, c, "o")
    return g, b


def test_roundtrip_parity(reg, tmp_path):
    x = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    g, sink = chain(x)
    ex = Executor(reg)
    want = ex.run(g, taps="all")

    out_dir = str(tmp_path / "art")
    manifest = export_graph(g, out_dir, taps="all", executor=ex)
    assert manifest["format"] == 1
    assert sorted(os.listdir(out_dir)) == [
        "captures.safetensors", "manifest.json", "program.stablehlo"]

    art = load_artifact(out_dir)
    got = art(x)
    assert set(got) == set(want)
    for i in want:
        for ch in want[i]:
            np.testing.assert_allclose(
                np.asarray(got[i][ch]), np.asarray(want[i][ch]), atol=1e-6)


def test_load_needs_no_registry(reg, tmp_path):
    # the whole point: deserialize+run without node kinds or model code
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="primary", executor=Executor(reg))

    art = ExportedGraph(out_dir)  # no registry anywhere in this path
    got = art(x)
    ref = np.cos(2.0 * x + 0.5) + 0.25
    sink = max(got)  # the binop is the graph's only sink
    np.testing.assert_allclose(np.asarray(got[sink]["c"]), ref, atol=1e-6)


def test_dynamic_capture_edit_after_export(reg, tmp_path):
    # cos A/b are dynamic node params -> captures: editable post-export
    # without re-lowering (the live executor's interactivity contract,
    # carried into the deployed artifact)
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g = Graph()
    c = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    g.add_input(x, c, "o")
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="all", executor=Executor(reg))

    art = load_artifact(out_dir)
    np.testing.assert_allclose(np.asarray(art(x)[c.index]["o"]),
                               np.cos(2.0 * x + 0.5), atol=1e-6)
    art.set_cap(c.index, "A", 3.0)
    np.testing.assert_allclose(np.asarray(art(x)[c.index]["o"]),
                               np.cos(3.0 * x + 0.5), atol=1e-6)
    with pytest.raises(ExportError, match="no capture"):
        art.set_cap(c.index, "nope", 1.0)
    with pytest.raises(ExportError, match="shape"):
        art.set_cap(c.index, "A", np.zeros((2, 2), np.float32))


def test_model_graph_with_saliency_exports(reg, tmp_path):
    # a real model chain incl. a gradient node: weights ride in the
    # captures safetensors; jax.grad is inside the StableHLO
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit.ViTConfig("vit_exp", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=8)
    vit.VARIANTS["vit_exp"] = cfg
    try:
        make_vit_model("vit_exp").register(reg)
        g = Graph()
        emb = g.add_node("vit_exp:embed")
        b0 = g.add_node("vit_exp:blocks.0")
        b1 = g.add_node("vit_exp:blocks.1")
        head = g.add_node("vit_exp:head")
        s = g.add_node("saliency", {"target": "class", "class": "3"})
        g.connect(emb, "o", b0, "o")
        g.connect(b0, "o", b1, "o")
        g.connect(b1, "o", head, "o")
        g.connect(head, "o", s, "o")
        img = np.random.default_rng(0).random((2, 3, 32, 32)).astype(
            np.float32)
        g.add_input(img, emb, "o")
        ex = Executor(reg)
        want = ex.run(g, taps={(head.index, "o"), (s.index, "g")})

        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir,
                     taps={(head.index, "o"), (s.index, "g")}, executor=ex)
        art = load_artifact(out_dir)
        got = art(img)
        np.testing.assert_allclose(np.asarray(got[head.index]["o"]),
                                   np.asarray(want[head.index]["o"]),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got[s.index]["g"]),
                                   np.asarray(want[s.index]["g"]),
                                   atol=1e-5, rtol=1e-4)
        # class index is a dynamic capture: scrub it post-deploy
        art.set_cap(s.index, "class", 5)
        got5 = art(img)
        assert not np.allclose(np.asarray(got5[s.index]["g"]),
                               np.asarray(got[s.index]["g"]))
    finally:
        del vit.VARIANTS["vit_exp"]


def test_input_contract_errors(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=Executor(reg))
    art = load_artifact(out_dir)
    with pytest.raises(ExportError, match="takes 1 inputs"):
        art(x, x)
    with pytest.raises(ExportError, match="shape"):
        art(np.zeros((3,), np.float32))


def test_generator_graph_exports_nullary(reg, tmp_path):
    # noise/const source graphs have zero input edges: the artifact is a
    # nullary program (and the seed/value stay editable captures)
    g = Graph()
    k = g.add_node("const", {"value": "1.5", "dims": "[4]"})
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, taps="all", executor=Executor(reg))
    art = load_artifact(out_dir)
    np.testing.assert_allclose(np.asarray(art()[k.index]["o"]),
                               np.full((4,), 1.5, np.float32))
    art.set_cap(k.index, "value", 2.5)
    np.testing.assert_allclose(np.asarray(art()[k.index]["o"]),
                               np.full((4,), 2.5, np.float32))


def test_corrupt_artifact_errors(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=Executor(reg))
    with pytest.raises(ExportError, match="manifest"):
        load_artifact(str(tmp_path / "missing"))
    # truncated program bytes
    p = os.path.join(out_dir, "program.stablehlo")
    with open(p, "r+b") as f:
        f.truncate(10)
    with pytest.raises(ExportError, match="deserialization"):
        load_artifact(out_dir)


def test_shape_struct_inputs_export(reg, tmp_path):
    # the CLI wires ShapeDtypeStructs (no materialized pixels); the
    # artifact must still run on real arrays afterwards
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g = Graph()
    c = g.add_node("cos", {"A": "1.0", "b": "0.0"})
    g.add_input(shape_struct(x), c, "o")
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=Executor(reg))
    art = load_artifact(out_dir)
    np.testing.assert_allclose(np.asarray(art(x)[c.index]["o"]),
                               np.cos(x), atol=1e-6)


def test_export_cli_end_to_end(reg, tmp_path):
    # ivt-export --check on a library graph, then ivt-run-exported
    from interactive_vit_tpu.tools.export_graph import main as export_main
    from interactive_vit_tpu.tools.run_exported import main as run_main

    out_dir = str(tmp_path / "art")
    rc = export_main(["demo_noise", "--out", out_dir, "--taps", "all",
                      "--check"])
    assert rc == 0
    art = load_artifact(out_dir)
    assert art.manifest["provenance"]["graph"] == "demo_noise.json"

    feeds = []
    for i, s in enumerate(art.input_specs):
        p = str(tmp_path / f"in{i}.npy")
        np.save(p, np.random.default_rng(i).random(
            s["shape"]).astype(s["dtype"]))
        feeds.append(p)
    taps_dir = str(tmp_path / "taps")
    rc = run_main([out_dir, *feeds, "--out", taps_dir])
    assert rc == 0
    assert any(f.endswith(".npy") for f in os.listdir(taps_dir))


def test_bf16_model_artifact_roundtrips(reg, tmp_path):
    # the safetensors reader upcasts BF16 to f32, but jax.export enforces
    # the exported capture dtypes at call time: the skeleton must carry
    # dtype and the loader must cast back (review finding: bf16 — the
    # headline serving dtype — previously produced unloadable
    # artifacts)
    import jax.numpy as jnp

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit.ViTConfig("vit_bf", img_size=32, patch=16, width=64,
                        depth=1, heads=4, num_classes=8)
    vit.VARIANTS["vit_bf"] = cfg
    try:
        make_vit_model("vit_bf", dtype=jnp.bfloat16).register(reg)
        g = Graph()
        emb = g.add_node("vit_bf:embed")
        head = g.add_node("vit_bf:head")
        g.connect(emb, "o", head, "o")
        img = np.random.default_rng(0).random((1, 3, 32, 32)).astype(
            np.float32)
        g.add_input(img, emb, "o")
        ex = Executor(reg)
        want = ex.run(g, taps={(head.index, "o")})

        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir, taps={(head.index, "o")}, executor=ex)
        got = load_artifact(out_dir)(img)
        np.testing.assert_allclose(
            np.asarray(got[head.index]["o"], np.float32),
            np.asarray(want[head.index]["o"], np.float32), atol=1e-2)
    finally:
        del vit.VARIANTS["vit_bf"]


def test_capture_path_collision_refused(tmp_path):
    # "."-joined path keys can alias when dict keys contain dots
    # (layer names like "blocks.0" do): refusing beats deploying the
    # wrong weights silently
    from interactive_vit_tpu.graph.export import _flatten_caps

    caps = {"a": {"b": np.zeros(2, np.float32)},
            "a.b": np.ones(2, np.float32)}
    with pytest.raises(ExportError, match="collision"):
        _flatten_caps(caps, "c", {})


def test_set_cap_on_weights_subtree_is_export_error(reg, tmp_path):
    # a model layer's capture is a nested dict: set_cap must refuse with
    # the one documented error type, not AttributeError
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit.ViTConfig("vit_sc", img_size=32, patch=16, width=64,
                        depth=1, heads=4, num_classes=8)
    vit.VARIANTS["vit_sc"] = cfg
    try:
        make_vit_model("vit_sc", quantize="w8").register(reg)
        g = Graph()
        emb = g.add_node("vit_sc:embed")
        b0 = g.add_node("vit_sc:blocks.0")
        g.connect(emb, "o", b0, "o")
        img = np.zeros((1, 3, 32, 32), np.float32)
        g.add_input(img, emb, "o")
        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir, executor=Executor(reg))
        art = load_artifact(out_dir)
        subtree = next(
            ((int(i), k) for i, c in art.caps.items()
             if isinstance(c, dict)
             for k, v in c.items() if isinstance(v, dict)), None)
        assert subtree is not None, "expected a quant-dict capture"
        with pytest.raises(ExportError, match="subtree"):
            art.set_cap(subtree[0], subtree[1], 1.0)
    finally:
        del vit.VARIANTS["vit_sc"]


def test_cross_platform_export_lowering(reg, tmp_path):
    # one artifact lowered for BOTH cpu and cuda (plain path: Pallas
    # fns lower only for their native platform); executes on the CPU
    # backend here
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit.ViTConfig("vit_xp", img_size=32, patch=16, width=64,
                        depth=1, heads=4, num_classes=8)
    vit.VARIANTS["vit_xp"] = cfg
    try:
        make_vit_model("vit_xp").register(reg)
        g = Graph()
        emb = g.add_node("vit_xp:embed")
        head = g.add_node("vit_xp:head")
        g.connect(emb, "o", head, "o")
        img = np.zeros((1, 3, 32, 32), np.float32)
        g.add_input(img, emb, "o")
        out_dir = str(tmp_path / "art")
        m = export_graph(g, out_dir, executor=Executor(reg),
                         platforms=["cpu", "cuda"])
        assert m["platforms"] == ["cpu", "cuda"]
        art = load_artifact(out_dir)
        assert np.asarray(art(img)[head.index]["o"]).shape == (1, 8)
    finally:
        del vit.VARIANTS["vit_xp"]


def test_mesh_sharded_export_roundtrips(reg, tmp_path):
    # deployment of a MESH-sharded program: the exported StableHLO bakes
    # the executor's own placement (TP captures per param_spec,
    # replicated inputs); the loader rebuilds an identical mesh, places
    # arguments the same way, and must match the live mesh executor
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.parallel.mesh import make_mesh

    cfg = vit.ViTConfig("vit_me", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=8)
    vit.VARIANTS["vit_me"] = cfg
    try:
        make_vit_model("vit_me",
                       tp_layout=True).register(reg)
        mesh = make_mesh({"data": 4, "model": 2})
        ex = Executor(reg, mesh=mesh)
        g = Graph()
        emb = g.add_node("vit_me:embed")
        b0 = g.add_node("vit_me:blocks.0")
        b1 = g.add_node("vit_me:blocks.1")
        head = g.add_node("vit_me:head")
        g.connect(emb, "o", b0, "o")
        g.connect(b0, "o", b1, "o")
        g.connect(b1, "o", head, "o")
        img = np.random.default_rng(0).random((2, 3, 32, 32)).astype(
            np.float32)
        g.add_input(img, emb, "o")
        want = ex.run(g, taps={(head.index, "o"), (b0.index, "attn")})

        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir,
                     taps={(head.index, "o"), (b0.index, "attn")},
                     executor=ex)
        art = load_artifact(out_dir)
        assert art.manifest["mesh"] == {"axes": ["data", "model"],
                                        "shape": [4, 2]}
        assert art.mesh is not None
        got = art(img)
        for i in want:
            for ch in want[i]:
                np.testing.assert_allclose(
                    np.asarray(got[i][ch]), np.asarray(want[i][ch]),
                    atol=1e-5)
    finally:
        del vit.VARIANTS["vit_me"]


def test_pp_folded_export_roundtrips(reg, tmp_path):
    # a PP-folded staged program (GPipe shard_map over the "stage" axis,
    # executor._find_pp_segments) must survive jax.export serialization —
    # pins shard_map-under-export against jax upgrades
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.parallel.mesh import make_mesh

    cfg = vit.ViTConfig("vit_ppx", img_size=32, patch=16, width=64,
                        depth=4, heads=4, num_classes=8)
    vit.VARIANTS["vit_ppx"] = cfg
    try:
        make_vit_model("vit_ppx").register(reg)
        mesh = make_mesh({"data": 2, "model": 1, "stage": 2})
        ex = Executor(reg, mesh=mesh)
        g = Graph()
        emb = g.add_node("vit_ppx:embed")
        prev = emb
        for i in range(4):
            b = g.add_node(f"vit_ppx:blocks.{i}")
            g.connect(prev, "o", b, "o")
            prev = b
        head = g.add_node("vit_ppx:head")
        g.connect(prev, "o", head, "o")
        img = np.random.default_rng(0).random((1, 3, 32, 32)).astype(
            np.float32)
        g.add_input(img, emb, "o")
        want = ex.run(g, taps={(head.index, "o")})
        assert ex.last_pp_segments, "expected a folded PP segment"

        out_dir = str(tmp_path / "art")
        export_graph(g, out_dir, taps={(head.index, "o")}, executor=ex)
        got = load_artifact(out_dir)(img)
        np.testing.assert_allclose(np.asarray(got[head.index]["o"]),
                                   np.asarray(want[head.index]["o"]),
                                   atol=1e-5)
    finally:
        del vit.VARIANTS["vit_ppx"]


def test_manifest_is_json_and_versioned(reg, tmp_path):
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    g, _ = chain(x)
    out_dir = str(tmp_path / "art")
    export_graph(g, out_dir, executor=Executor(reg))
    m = json.load(open(os.path.join(out_dir, "manifest.json")))
    assert m["format"] == 1
    assert m["inputs"][0]["shape"] == [8]
    assert m["inputs"][0]["dtype"] == "float32"
    assert all(isinstance(i, list) and len(i) == 2 for i in m["out_keys"])


def test_selftest_passes_and_catches_corruption(tmp_path):
    """The manifest's seeded-replay record verifies artifact integrity
    with no model code; corrupting capture bytes fails it (round 4 —
    the deploy-fleet counterpart of --check)."""
    import jax

    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.graph.export import export_graph, load_artifact
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.ops.node_ops import register_builtin

    reg = Registry()
    register_builtin(reg)
    g = Graph()
    a = g.add_node("cos", {"A": "2.0", "b": "0.5"})
    b = g.add_node("binop", {"op": "*"})
    g.connect(a, "o", b, "a")
    g.connect(a, "o", b, "b")
    g.add_input(np.zeros((64,), np.float32), a, "o")
    d = str(tmp_path / "art")
    export_graph(g, d, taps="primary", executor=Executor(reg))

    art = load_artifact(d)
    res = art.selftest()
    assert res["ok"], res
    assert res["checked"] >= 2

    # corrupt the tail of the captures payload (header stays valid so
    # the artifact still LOADS; the values are wrong)
    caps_path = os.path.join(d, "captures.safetensors")
    raw = bytearray(open(caps_path, "rb").read())
    raw[-4:] = b"\x7f\x7f\x7f\x7f"
    open(caps_path, "wb").write(raw)
    res2 = load_artifact(d).selftest()
    assert not res2["ok"], res2


def test_hot_path_properties(tmp_path):
    """The three from-export hot-path rules: captures are DEVICE-resident
    from load, the program runs through one cached jit wrapper, and
    `want=` limits which outputs pay the device->host fetch."""
    import jax

    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.graph.export import export_graph, load_artifact
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.ops.node_ops import register_builtin

    reg = Registry()
    register_builtin(reg)
    g = Graph()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos", {"A": "3.0"})
    g.connect(a, "o", b, "o")
    g.add_input(np.zeros((8,), np.float32), a, "o")
    d = str(tmp_path / "art")
    export_graph(g, d, taps="primary", executor=Executor(reg))

    art = load_artifact(d)
    for leaf in jax.tree.leaves(art.caps):
        assert isinstance(leaf, jax.Array), type(leaf)  # not host numpy

    x = np.linspace(0, 1, 8, dtype=np.float32)
    full = art(x)
    assert set(full) == {0, 1}
    art(x)
    assert art._jitted_call is not None  # cached wrapper, not raw call
    sub = art(x, want={(1, "o")})
    assert set(sub) == {1}  # only the requested tap fetched
    np.testing.assert_allclose(sub[1]["o"], full[1]["o"])
