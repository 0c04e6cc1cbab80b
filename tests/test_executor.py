"""Staged executor tests: staging, caching, taps, error attribution."""

import os
import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor, NodeError, resolve_taps
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.ops.node_ops import register_builtin

# the reference's own saved graphs, as committed copies in this repo
GRAPHS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "static", "graphs")


@pytest.fixture
def reg():
    r = Registry()
    register_builtin(r)
    return r


@pytest.fixture
def ex(reg):
    return Executor(reg)


def test_single_cos_node(ex):
    g = Graph()
    n = g.add_node("cos", {"A": "2.0", "b": "1.0"})
    x = np.linspace(0, 3, 16, dtype=np.float32)
    g.add_input(x, n, "o")

    out = ex.run(g)
    np.testing.assert_allclose(out[0]["o"], np.cos(2.0 * x + 1.0), rtol=1e-6)


def test_chain_fuses_and_matches_eager(ex, reg):
    g = Graph()
    a = g.add_node("cos", {"A": "1.0"})
    b = g.add_node("cos", {"A": "3.0", "b": "0.25"})
    g.connect(a, "o", b, "o")
    x = np.linspace(-1, 1, 8, dtype=np.float32)
    g.add_input(x, a, "o")

    staged = ex.run(g)
    expected = np.cos(3.0 * np.cos(x) + 0.25)
    np.testing.assert_allclose(staged[1]["o"], expected, rtol=1e-6)

    # eager debug path agrees
    eager, errors = ex.run_eager(g)
    assert not errors
    np.testing.assert_allclose(
        np.asarray(eager[1]["o"]), np.asarray(staged[1]["o"]), rtol=1e-6
    )


def test_compile_cache_hit(ex):
    def make(x):
        g = Graph()
        n = g.add_node("cos")
        g.add_input(x, n, "o")
        return g

    x = np.zeros((4,), np.float32)
    ex.run(make(x))
    assert not ex.last_stats.cache_hit
    ex.run(make(x + 1))  # same shapes/topology -> cache hit
    assert ex.last_stats.cache_hit
    ex.run(make(np.zeros((8,), np.float32)))  # new shape -> miss
    assert not ex.last_stats.cache_hit


def test_taps_subset(ex):
    g = Graph()
    a = g.add_node("cos")
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    g.add_input(np.ones((4,), np.float32), a, "o")

    out = ex.run(g, taps={(1, "o")})
    assert set(out) == {1}

    sinks = resolve_taps(g, "sinks", ex.reg)
    assert sinks == {(1, "o")}


def test_all_taps_returns_every_node(ex):
    g = Graph()
    a = g.add_node("cos")
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    g.add_input(np.ones((4,), np.float32), a, "o")
    out = ex.run(g, taps="all")
    assert set(out) == {0, 1}


def test_error_attribution_unknown_kind(ex):
    g = Graph()
    g.add_node("nonexistent_kind")
    with pytest.raises(NodeError) as ei:
        ex.run(g)
    assert ei.value.node_index == 0


def test_error_attribution_missing_input(ex):
    g = Graph()
    a = g.add_node("cos")
    b = g.add_node("binop", {"op": "+"})
    g.connect(a, "o", b, "a")
    g.add_input(np.ones((4,), np.float32), a, "o")
    # binop's "b" channel unwired
    with pytest.raises(NodeError) as ei:
        ex.run(g)
    assert ei.value.node_index == 1


def test_error_attribution_shape_mismatch_at_trace(ex):
    g = Graph()
    n = g.add_node("binop", {"op": "+"})
    g.add_input(np.ones((4,), np.float32), n, "a")
    g.add_input(np.ones((5,), np.float32), n, "b")
    with pytest.raises(NodeError) as ei:
        ex.run(g)
    assert ei.value.node_index == 0


def test_eager_fault_isolation(ex):
    g = Graph()
    bad = g.add_node("binop", {"op": "+"})  # shape mismatch -> fails
    down = g.add_node("cos")
    ok = g.add_node("cos")
    g.connect(bad, "c", down, "o")
    g.add_input(np.ones((4,), np.float32), bad, "a")
    g.add_input(np.ones((5,), np.float32), bad, "b")
    g.add_input(np.ones((2,), np.float32), ok, "o")

    outputs, errors = ex.run_eager(g)
    assert 0 in errors
    assert errors[1] == "eval error upstream"
    assert 2 in outputs  # independent node still evaluated


def test_diamond_multi_consumer(ex):
    g = Graph()
    src = g.add_node("cos")
    l = g.add_node("cos", {"A": "2.0"})
    r = g.add_node("cos", {"A": "0.5"})
    join = g.add_node("binop", {"op": "*"})
    g.connect(src, "o", l, "o")
    g.connect(src, "o", r, "o")
    g.connect(l, "o", join, "a")
    g.connect(r, "o", join, "b")
    x = np.full((4,), 0.3, np.float32)
    g.add_input(x, src, "o")

    out = ex.run(g, taps="sinks")
    c = np.cos(x)
    np.testing.assert_allclose(
        out[3]["c"], np.cos(2 * c) * np.cos(0.5 * c), rtol=1e-6
    )


def test_compile_cache_lru_eviction(reg):
    ex = Executor(reg, max_cache_entries=2)
    for size in (4, 8, 16):
        g = Graph()
        n = g.add_node("cos")
        g.add_input(np.zeros((size,), np.float32), n, "o")
        ex.run(g)
    assert ex.cache_info()["entries"] == 2
    # the oldest (size 4) was evicted -> re-running it is a miss
    g = Graph()
    n = g.add_node("cos")
    g.add_input(np.zeros((4,), np.float32), n, "o")
    ex.run(g)
    assert not ex.last_stats.cache_hit


def test_unjitted_executor_path(reg):
    """use_jit=False: the staged closure runs eagerly, same results."""
    ex = Executor(reg, use_jit=False)
    g = Graph()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    x = np.linspace(0, 1, 8, dtype=np.float32)
    g.add_input(x, a, "o")
    out = ex.run(g)
    np.testing.assert_allclose(
        np.asarray(out[1]["o"]), np.cos(np.cos(2.0 * x)), rtol=1e-6
    )


def test_run_device_resident(reg):
    """to_host=False keeps outputs as jax arrays (bench fast path)."""
    import jax

    ex = Executor(reg)
    g = Graph()
    n = g.add_node("cos")
    g.add_input(np.ones((4,), np.float32), n, "o")
    out = ex.run(g, to_host=False)
    assert isinstance(out[0]["o"], jax.Array)


def test_input_cache_reuses_device_buffers(simple_setup=None):
    """Content-addressed input cache: identical bytes -> same device
    buffer (no re-upload); changed bytes -> fresh upload; LRU-bounded."""
    import numpy as np

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.ops.node_ops import register_builtin

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg=reg)

    img = np.random.default_rng(0).random((4, 8)).astype(np.float32)
    a = ex._device_input(img)
    b = ex._device_input(img.copy())  # same content, different array
    assert a is b
    c = ex._device_input(img + 1)
    assert c is not a
    assert len(ex._input_cache) == 2

    # correctness through the full run path (second run = cache hit)
    def run_once(x):
        g = Graph()
        n = g.add_node("cos", {"A": "1.0", "b": "0.0"})
        g.add_input(x, n, "o")
        outs = ex.run(g, taps="all")
        return outs[0]["o"]

    r1 = run_once(img)
    r2 = run_once(img.copy())
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(r1, np.cos(img), atol=1e-6)

    # LRU eviction respects the byte budget
    ex.input_cache_budget = img.nbytes * 2
    for i in range(5):
        ex._device_input(img + 2 + i)
    assert ex._input_cache_bytes <= ex.input_cache_budget


def test_explicit_bad_taps_raise_attributed_errors():
    """Unknown tap node/channel must raise (GraphError/NodeError), not be
    silently dropped from the response (review finding: partial HTTP 200
    with no diagnostic violated the attribution contract)."""
    from interactive_vit_tpu.graph.executor import NodeError
    from interactive_vit_tpu.graph.ir import GraphError

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    g = Graph()
    n = g.add_node("cos", {})
    g.add_input(np.ones((4,), np.float32), n, "o")
    with pytest.raises(GraphError):
        ex.run(g, taps={(5, "o")})
    with pytest.raises(NodeError) as ei:
        ex.run(g, taps={(0, "att")})
    assert "att" in str(ei.value) and "node 0" in str(ei.value)


def test_batcher_survives_bad_graph_and_generator_taps():
    """A bad graph in the pipelined window must fail ITS OWN future (not
    kill the worker thread), and generator tap specs must not be silently
    exhausted to an empty set."""
    from interactive_vit_tpu.serving.batcher import MicroBatcher

    reg = Registry()
    register_builtin(reg)
    b = MicroBatcher(Executor(reg), max_wait_ms=1.0)

    def good():
        g = Graph()
        n = g.add_node("cos", {"A": "1.0"})
        g.add_input(np.ones((4,), np.float32), n, "o")
        return g

    # generator taps: previously sorted() exhausted it -> empty program
    fut = b.submit(good(), taps=((i, "o") for i in [0]))
    out = fut.result(timeout=30)
    assert 0 in out and "o" in out[0]

    # unknown node kind: future fails with the attributed error, and the
    # worker keeps serving subsequent requests
    bad = Graph()
    bad.add_node("nonexistent_kind", {})
    f_bad = b.submit(bad, taps="all")
    with pytest.raises(Exception):
        f_bad.result(timeout=30)
    f_ok = b.submit(good(), taps="all")
    assert 0 in f_ok.result(timeout=30)
    b.stop()


def test_descriptions_isolates_broken_kind():
    """One kind whose io() raises must not poison the batched palette."""
    from interactive_vit_tpu.graph.registry import NodeKind
    from interactive_vit_tpu.serving.app import App

    class Broken(NodeKind):
        def __init__(self):
            super().__init__("broken_io")

        def io(self, params):
            raise ValueError("params required")

        def fn(self, params):
            return lambda ins: {}

    reg = Registry()
    register_builtin(reg)
    Broken().register(reg)
    app = App(reg=reg, graphs_dir=GRAPHS)
    out = app.descriptions(["cos", "broken_io", "missing"])
    assert out["cos"]["io"]["ins"] == ["o"]
    assert "error" in out["broken_io"]
    assert "error" in out["missing"]
    app.batcher.stop()


def test_dynamic_params_rekey_without_recompile():
    """Interactive edits of dynamic params (cos A/b, noise seed, const
    value, conv2d matrix, patch_sim query) hit the cached program AND
    deliver the new values (they ride as runtime captures, outside the
    compile signature)."""
    import base64

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    def cos_graph(a):
        g = Graph()
        n = g.add_node("cos", {"A": str(a)})
        g.add_input(np.ones((4,), np.float32), n, "o")
        return g

    out1 = ex.run(cos_graph(1.0), taps="all")
    assert not ex.last_stats.cache_hit
    out2 = ex.run(cos_graph(2.0), taps="all")
    assert ex.last_stats.cache_hit  # same program, new capture
    np.testing.assert_allclose(np.asarray(out1[0]["o"]), np.cos(np.ones(4)),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out2[0]["o"]),
                               np.cos(2 * np.ones(4)), rtol=1e-6)

    # noise: seed bump re-keys (different values), dims change recompiles
    def noise_graph(seed, dims="[8]"):
        g = Graph()
        g.add_node("noise", {"seed": str(seed), "dims": dims})
        return g

    n1 = np.asarray(ex.run(noise_graph(0), taps="all")[0]["o"])
    n2 = np.asarray(ex.run(noise_graph(1), taps="all")[0]["o"])
    assert ex.last_stats.cache_hit
    assert not np.array_equal(n1, n2)
    ex.run(noise_graph(1, dims="[9]"), taps="all")
    assert not ex.last_stats.cache_hit  # shape change = new program

    # conv2d: matrix edit re-keys
    def conv_graph(mat):
        g = Graph()
        n = g.add_node("conv2d", {
            "h": "3", "w": "3",
            "matrix": base64.b64encode(
                np.asarray(mat, "<f4").tobytes()).decode(),
        })
        g.add_input(np.ones((1, 6, 6), np.float32), n, "o")
        return g

    ident = np.zeros((3, 3)); ident[1, 1] = 1.0
    box = np.full((3, 3), 1 / 9)
    c1 = np.asarray(ex.run(conv_graph(ident), taps="all")[0]["o"])
    c2 = np.asarray(ex.run(conv_graph(box), taps="all")[0]["o"])
    assert ex.last_stats.cache_hit
    np.testing.assert_allclose(c1, np.ones((1, 4, 4)), atol=1e-6)
    np.testing.assert_allclose(c2, np.ones((1, 4, 4)), atol=1e-5)

    # patch_sim: query scrub re-keys; self-similarity lands on the query
    def sim_graph(row, col):
        g = Graph()
        n = g.add_node("patch_sim", {"row": str(row), "col": str(col)})
        g.add_input(np.random.default_rng(0).standard_normal(
            (1, 17, 16)).astype(np.float32), n, "o")
        return g

    s1 = np.asarray(ex.run(sim_graph(0, 0), taps="all")[0]["o"])
    s2 = np.asarray(ex.run(sim_graph(2, 3), taps="all")[0]["o"])
    assert ex.last_stats.cache_hit
    assert s1[0, 0, 0, 0] == pytest.approx(1.0, abs=1e-5)
    assert s2[0, 0, 2, 3] == pytest.approx(1.0, abs=1e-5)


def test_dynamic_params_refresh_in_stacked_runs():
    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    def graphs(a, k=3):
        out = []
        for i in range(k):
            g = Graph()
            n = g.add_node("cos", {"A": str(a)})
            g.add_input(np.full((4,), float(i), np.float32), n, "o")
            out.append(g)
        return out

    r1 = ex.run_stacked(graphs(1.0), taps="all")
    r2 = ex.run_stacked(graphs(3.0), taps="all")
    assert ex.last_stats.cache_hit
    np.testing.assert_allclose(np.asarray(r2[1][0]["o"]),
                               np.cos(3.0 * np.ones(4)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r1[1][0]["o"]),
                               np.cos(1.0 * np.ones(4)), rtol=1e-6)


def test_dynamic_param_edge_cases():
    """Negative noise seed works (UI down-click reaches -1); a bad param
    decode in captures() carries node attribution; bf16 streams keep
    their dtype through cos."""
    import base64

    import jax.numpy as jnp

    from interactive_vit_tpu.graph.executor import NodeError

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    g = Graph()
    g.add_node("noise", {"seed": "-1", "dims": "[4]"})
    out = ex.run(g, taps="all")
    assert np.asarray(out[0]["o"]).shape == (4,)

    # conv2d h bumped while the matrix is still 3x3: attributed error
    g2 = Graph()
    n = g2.add_node("conv2d", {
        "h": "5", "w": "3",
        "matrix": base64.b64encode(
            np.zeros(9, "<f4").tobytes()).decode(),
    })
    g2.add_input(np.ones((1, 8, 8), np.float32), n, "o")
    with pytest.raises(NodeError) as ei:
        ex.run(g2, taps="all")
    assert "node 0" in str(ei.value)

    # bf16 stream stays bf16 through cos (weak-typed-constant parity)
    g3 = Graph()
    n3 = g3.add_node("cos", {"A": "2.0"})
    g3.add_input(jnp.ones((4,), jnp.bfloat16), n3, "o")
    out3 = ex.run(g3, taps="all", to_host=False)
    assert out3[0]["o"].dtype == jnp.bfloat16


def test_stacked_batches_mixed_dynamic_values():
    """Requests differing ONLY in dynamic params share one vmapped batch:
    run_stacked stacks their captures per request (VERDICT r2 #5), so
    each request gets ITS OWN conv matrix / cos A / noise seed."""
    import base64

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    # cos: three different A values in one stack
    def cos_graph(a, x):
        g = Graph()
        n = g.add_node("cos", {"A": str(a)})
        g.add_input(x, n, "o")
        return g

    xs = [np.full((4,), float(i + 1), np.float32) for i in range(3)]
    a_vals = [0.5, 1.0, 2.0]
    res = ex.run_stacked(
        [cos_graph(a, x) for a, x in zip(a_vals, xs)], taps="all")
    assert not ex.last_stats.cache_hit
    for i, (a, x) in enumerate(zip(a_vals, xs)):
        np.testing.assert_allclose(np.asarray(res[i][0]["o"]),
                                   np.cos(a * x), rtol=1e-6)

    # cache hit on a NEW set of values: per-request captures refresh
    a2 = [3.0, 4.0, 5.0]
    res2 = ex.run_stacked(
        [cos_graph(a, x) for a, x in zip(a2, xs)], taps="all")
    assert ex.last_stats.cache_hit
    for i, (a, x) in enumerate(zip(a2, xs)):
        np.testing.assert_allclose(np.asarray(res2[i][0]["o"]),
                                   np.cos(a * x), rtol=1e-6)

    # conv2d: per-request matrices (identity vs box blur)
    def conv_graph(mat):
        g = Graph()
        n = g.add_node("conv2d", {
            "h": "3", "w": "3",
            "matrix": base64.b64encode(
                np.asarray(mat, "<f4").tobytes()).decode(),
        })
        g.add_input(np.ones((1, 6, 6), np.float32), n, "o")
        return g

    ident = np.zeros((3, 3), np.float32); ident[1, 1] = 1.0
    box = np.full((3, 3), 1 / 9, np.float32)
    cres = ex.run_stacked([conv_graph(ident), conv_graph(box)], taps="all")
    np.testing.assert_allclose(
        np.asarray(cres[0][0]["o"]), np.ones((1, 4, 4)), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(cres[1][0]["o"]), np.ones((1, 4, 4)), atol=1e-5)

    # mixed STATIC params still refuse to stack
    def noise_graph(dims):
        g = Graph()
        g.add_node("noise", {"seed": "0", "dims": dims})
        return g

    with pytest.raises(ValueError, match="mixed graph signatures"):
        ex.run_stacked([noise_graph("[4]"), noise_graph("[8]")], taps="all")

    # mixed noise SEEDS stack; each row gets its own stream
    def seed_graph(s):
        g = Graph()
        g.add_node("noise", {"seed": str(s), "dims": "[8]"})
        return g

    nres = ex.run_stacked([seed_graph(0), seed_graph(1)], taps="all")
    n0 = np.asarray(nres[0][0]["o"])
    n1 = np.asarray(nres[1][0]["o"])
    assert n0.shape == (8,) and not np.array_equal(n0, n1)
