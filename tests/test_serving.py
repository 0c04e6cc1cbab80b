"""Serving tier tests: endpoints, wire contract over HTTP, micro-batching."""

import json
import os
import threading
import urllib.request
import urllib.error

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.serving.app import App
from interactive_vit_tpu.wire.codec import Request, Response

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND = os.path.join(REPO, "frontend")
# the reference's own saved graphs, as committed copies in this repo
GRAPHS = os.path.join(REPO, "static", "graphs")


@pytest.fixture(scope="module")
def served():
    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=GRAPHS,
              max_wait_ms=5.0)
    httpd = app.serve("127.0.0.1", 0, background=True)
    port = httpd.server_address[1]
    yield app, f"http://127.0.0.1:{port}"
    httpd.shutdown()
    app.batcher.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def make_cos_graph(x, a="2.0"):
    g = Graph()
    n = g.add_node("cos", {"A": a})
    g.add_input(x, n, "o")
    return g


def test_compute_endpoint_roundtrip(served):
    _, base = served
    x = np.linspace(0, 1, 16, dtype=np.float32)
    raw = _post(base + "/compute", Request.encode(make_cos_graph(x)))
    out = Response.decode(raw)
    np.testing.assert_allclose(out[0]["o"], np.cos(2.0 * x), rtol=1e-6)


def test_compute_error_is_400_with_node_attribution(served):
    _, base = served
    g = Graph()
    n = g.add_node("no_such_kind")
    g.add_input(np.ones(4, np.float32), n, "o")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/compute", Request.encode(g))
    assert ei.value.code == 400
    body = ei.value.read().decode()
    assert "node 0" in body and "no_such_kind" in body


def test_description_and_contents(served):
    _, base = served
    io = json.loads(_get(base + "/description/binop"))
    assert io == {"ins": ["a", "b"], "outs": ["c"]}
    html = _get(base + "/contents/cos?A=3.0").decode()
    assert "cos" in html

    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/description/nope")
    assert ei.value.code == 400


def test_batched_descriptions(served):
    _, base = served
    out = json.loads(_get(base + "/descriptions?names=cos,binop,nope"))
    assert out["cos"]["io"] == {"ins": ["o"], "outs": ["o"]}
    assert "error" in out["nope"]


def test_list_and_load_graphs(served):
    _, base = served
    names = json.loads(_get(base + "/list_graphs"))
    assert "demo_noise.json" in names
    obj = json.loads(_get(base + "/load_graph/demo_noise.json"))
    assert "nodes" in obj and "edges" in obj


def test_path_traversal_blocked(served):
    _, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/load_graph/..%2F..%2Fmanage.py")
    assert ei.value.code == 400


def test_metrics_endpoint(served):
    _, base = served
    m = json.loads(_get(base + "/metrics"))
    assert "request_p50_ms" in m
    assert m["counters"].get("compute_requests", 0) >= 1


def test_concurrent_identical_requests_get_batched(served):
    app, base = served
    before = app.metrics.snapshot()["counters"].get("batches", 0)
    xs = [np.full((32,), i, np.float32) for i in range(6)]
    results = [None] * 6

    def worker(i):
        raw = _post(base + "/compute", Request.encode(make_cos_graph(xs[i])))
        results[i] = Response.decode(raw)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    for i in range(6):
        np.testing.assert_allclose(
            results[i][0]["o"], np.cos(2.0 * xs[i]), rtol=1e-6
        )
    snap = app.metrics.snapshot()
    batches = snap["counters"]["batches"] - before
    # 6 concurrent same-signature requests must share programs: fewer
    # batches than requests proves stacking happened
    assert batches < 6, f"no batching observed: {snap}"


def test_mixed_signature_requests_still_correct(served):
    app, base = served
    x = np.ones((8,), np.float32)
    y = np.ones((16,), np.float32)  # different shape -> different signature
    r1, r2 = [None], [None]

    def w1():
        r1[0] = Response.decode(_post(base + "/compute",
                                      Request.encode(make_cos_graph(x))))

    def w2():
        r2[0] = Response.decode(_post(base + "/compute",
                                      Request.encode(make_cos_graph(y, a="1.0"))))

    t1, t2 = threading.Thread(target=w1), threading.Thread(target=w2)
    t1.start(); t2.start(); t1.join(); t2.join()
    np.testing.assert_allclose(r1[0][0]["o"], np.cos(2.0 * x), rtol=1e-6)
    np.testing.assert_allclose(r2[0][0]["o"], np.cos(1.0 * y), rtol=1e-6)


def test_run_stacked_direct():
    """Executor.run_stacked: correctness + padding to power-of-two bucket."""
    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)
    graphs = []
    xs = []
    for i in range(3):  # 3 -> bucket 4, one padded row dropped
        x = np.full((8,), float(i), np.float32)
        xs.append(x)
        graphs.append(make_cos_graph(x))
    results = ex.run_stacked(graphs, taps="all")
    assert len(results) == 3
    for i, res in enumerate(results):
        np.testing.assert_allclose(res[0]["o"], np.cos(2.0 * xs[i]), rtol=1e-6)


def test_frontend_assets_served():
    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=GRAPHS,
              frontend_dir=FRONTEND)
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        html = _get(base + "/").decode()
        assert "app.js" in html
        for path, frag in [
            ("/static/styles.css", "--bg"),
            ("/static/js/app.js", "initToolbar"),
            ("/static/js/wire.js", "0x69babe69"),
            ("/static/js/graph.js", "class Context"),
            ("/static/js/nodes.js", "registerAll"),
            ("/static/js/workspace.js", "registerTool"),
        ]:
            body = _get(base + path).decode()
            assert frag in body, f"{path} missing {frag!r}"
        # traversal blocked
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/static/..%2F..%2Fpyproject.toml")
    finally:
        httpd.shutdown()
        app.batcher.stop()


def test_primary_policy_and_explicit_taps():
    """Wire tap extension: default excludes unconsumed extras (attention
    maps); explicit taps ship exactly what's asked."""
    import jax
    from interactive_vit_tpu.models import vit as vit_mod
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit_mod.ViTConfig("vit_srv", img_size=32, patch=16, width=64,
                            depth=2, heads=4, num_classes=10)
    vit_mod.VARIANTS["vit_srv"] = cfg
    reg = Registry()
    register_builtin(reg)
    model = make_vit_model("vit_srv",
                           params=vit_mod.init_params(jax.random.key(0), cfg))
    model.register(reg)

    app = App(reg=reg, graphs_dir=GRAPHS)
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        g = Graph()
        emb = g.add_node("vit_srv:embed")
        b0 = g.add_node("vit_srv:blocks.0")
        g.connect(emb, "o", b0, "o")
        x = np.random.default_rng(0).random((1, 3, 32, 32)).astype(np.float32)
        g.add_input(x, emb, "o")

        # default (primary): o channels only, no attn
        out = Response.decode(_post(base + "/compute", Request.encode(g)))
        assert "o" in out[1] and "attn" not in out[1]
        assert set(out) == {0, 1}

        # explicit taps: exactly the attention map
        from interactive_vit_tpu.wire.codec import (
            REQUEST_MAGIC, decode_message, encode_message,
        )

        raw = Request.encode(g)
        obj, tensors = decode_message(bytes(raw), expect_magic=REQUEST_MAGIC)
        obj["taps"] = [{"node": 1, "channel": "attn"}]
        raw2 = encode_message(REQUEST_MAGIC, obj, tensors)
        out2 = Response.decode(_post(base + "/compute", bytes(raw2)))
        assert set(out2) == {1}
        assert set(out2[1]) == {"attn"}
        assert out2[1]["attn"].shape == (1, 4, cfg.tokens, cfg.tokens)
    finally:
        httpd.shutdown()
        app.batcher.stop()


def test_debug_eval_endpoint(served):
    """Per-node timings + fault isolation over HTTP."""
    _, base = served
    g = Graph()
    a = g.add_node("cos", {"A": "2.0"})
    b = g.add_node("cos")
    g.connect(a, "o", b, "o")
    g.add_input(np.ones((16,), np.float32), a, "o")
    out = json.loads(_post(base + "/debug_eval", bytes(Request.encode(g))))
    assert set(out["timings_ms"]) == {"0", "1"}
    assert out["output_shapes"]["1"]["o"] == [16]
    assert out["errors"] == {}

    # failing node: downstream isolated
    g2 = Graph()
    bad = g2.add_node("binop", {"op": "+"})
    down = g2.add_node("cos")
    g2.connect(bad, "c", down, "o")
    g2.add_input(np.ones((4,), np.float32), bad, "a")
    g2.add_input(np.ones((5,), np.float32), bad, "b")
    out2 = json.loads(_post(base + "/debug_eval", bytes(Request.encode(g2))))
    assert "0" in out2["errors"]
    assert out2["errors"]["1"] == "eval error upstream"


def test_debug_eval_computes_wired_optional_channels():
    """debug_eval must inject __taps__ (effective_params) like every other
    evaluation path — a block's wired 'attn' channel is computed, not
    'input has no value' on the consumer (advisor r1, app.py:131)."""
    import jax
    from interactive_vit_tpu.models import vit as vit_mod
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit_mod.ViTConfig("vit_dbg", img_size=32, patch=16, width=64,
                            depth=1, heads=4, num_classes=10)
    vit_mod.VARIANTS["vit_dbg"] = cfg
    try:
        reg = Registry()
        register_builtin(reg)
        model = make_vit_model(
            "vit_dbg", params=vit_mod.init_params(jax.random.key(0), cfg))
        model.register(reg)
        app = App(reg=reg, graphs_dir=GRAPHS)
        g = Graph()
        emb = g.add_node("vit_dbg:embed")
        b0 = g.add_node("vit_dbg:blocks.0")
        down = g.add_node("cos")
        g.connect(emb, "o", b0, "o")
        g.connect(b0, "attn", down, "o")  # wire the optional channel
        x = np.random.default_rng(0).random((1, 3, 32, 32)).astype(np.float32)
        g.add_input(x, emb, "o")
        out = app.debug_eval(bytes(Request.encode(g)))
        assert out["errors"] == {}, out["errors"]
        assert out["output_shapes"]["1"]["attn"] == \
            [1, 4, cfg.tokens, cfg.tokens]
        assert "2" in out["timings_ms"]
    finally:
        del vit_mod.VARIANTS["vit_dbg"]


def test_compute_timeout_returns_503():
    """A wedged device must fail /compute fast with 503, not hang the
    handler thread forever (advisor r1, app.py:91)."""
    import concurrent.futures

    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=GRAPHS,
              compute_timeout_s=0.2)

    class WedgedBatcher:
        def submit(self, graph, taps):
            return concurrent.futures.Future()  # never resolves

        def start(self):
            pass

        def stop(self):
            pass

        def quiet_for(self, window_s):
            # real batcher interface: the speculator's idle gate calls
            # this from its thread — a double without it used to kill
            # the tap-speculator with an AttributeError (VERDICT r3 #1)
            return False

    app.batcher = WedgedBatcher()
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        x = np.ones((4,), np.float32)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/compute", Request.encode(make_cos_graph(x)))
        assert ei.value.code == 503
        assert "exceeded" in ei.value.read().decode()
    finally:
        httpd.shutdown()


def test_batcher_survives_failing_request(served):
    """A request that fails at trace poisons only its own future; the
    worker keeps serving (failure-detection contract)."""
    _, base = served
    bad = Graph()
    n = bad.add_node("binop", {"op": "+"})
    bad.add_input(np.ones((4,), np.float32), n, "a")
    bad.add_input(np.ones((5,), np.float32), n, "b")  # shape mismatch
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/compute", Request.encode(bad))
    assert ei.value.code == 400
    assert "node 0" in ei.value.read().decode()

    # the worker is still alive and serving
    x = np.linspace(0, 1, 8, dtype=np.float32)
    out = Response.decode(_post(base + "/compute",
                                Request.encode(make_cos_graph(x))))
    np.testing.assert_allclose(out[0]["o"], np.cos(2.0 * x), rtol=1e-6)


def test_health_endpoint(served):
    _, base = served
    h = json.loads(_get(base + "/health"))
    assert h["ok"] is True
    assert "device" in h and h["latency_ms"] >= 0


def test_boot_warmup():
    """--warmup pre-compiles the model chain; the next request is a hit."""
    import jax
    from interactive_vit_tpu.models import vit as vit_mod
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.serving.server import warmup
    from interactive_vit_tpu.wire.schema import graph_from_json

    cfg = vit_mod.ViTConfig("vit_warm", img_size=224, patch=16, width=64,
                            depth=1, heads=4, num_classes=10)
    vit_mod.VARIANTS["vit_warm"] = cfg
    reg = Registry()
    register_builtin(reg)
    import tempfile

    gdir = tempfile.mkdtemp()
    app = App(reg=reg, graphs_dir=gdir)
    model = make_vit_model("vit_warm",
                           params=vit_mod.init_params(jax.random.key(0), cfg))
    model.register(reg, app.graphs)

    warmup(app, ["vit_warm"])
    g = graph_from_json(app.graphs.load("vit_warm.json"))
    g.add_input(np.zeros((3, 224, 224), np.float32), g.nodes[0], "o")
    app.executor.run(g, taps="primary")
    assert app.executor.last_stats.cache_hit
    app.batcher.stop()


def test_static_absolute_path_traversal_blocked():
    """GET /static//etc/passwd must not read outside frontend_dir
    (os.path.join swallows the prefix when the suffix is absolute).
    Needs a bundled frontend — the shared fixture serves the fallback
    page for every static path."""
    reg = Registry()
    register_builtin(reg)
    app = App(reg=reg, graphs_dir=GRAPHS,
              frontend_dir=FRONTEND)
    httpd = app.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for path in ("/static//etc/passwd", "/static/%2Fetc%2Fpasswd",
                     "/static/..%2f..%2f..%2fetc%2fpasswd"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base + path)
            assert ei.value.code in (400, 404)
    finally:
        httpd.shutdown()
        app.batcher.stop()


class _StubExecutor:
    """Minimal Executor stand-in for batcher unit tests."""

    def __init__(self):
        self.calls = []

    def run(self, graph, taps, defer=False):
        self.calls.append(1)
        return {"0/o": graph}  # flat dict contract

    def run_stacked(self, graphs, taps, defer=False):
        self.calls.append(len(graphs))
        return {"0/o": list(graphs)}

    def is_compiled(self, graph, taps, batch=None):
        return True


def _stub_item(sig):
    from interactive_vit_tpu.serving.batcher import _Item

    class G:  # graph stand-in: only .signature is needed pre-dispatch
        def signature(self, extra=()):
            return sig

    return _Item(G(), "all", sig)


def test_batcher_drain_on_stop_fails_queued_futures(monkeypatch):
    """Shutdown must not leave futures pending forever (a pending future
    hangs its HTTP handler thread)."""
    from interactive_vit_tpu.serving.batcher import MicroBatcher

    b = MicroBatcher(_StubExecutor())
    a1, a2 = _stub_item("sigA"), _stub_item("sigB")
    b._backlog.append(a1)
    b._q.put(a2)
    b._drain_stopped()
    for it in (a1, a2):
        assert it.future.done()
        with pytest.raises(RuntimeError):
            it.future.result()


def test_batcher_restart_after_stop():
    """stop() then submit() must restart the worker thread (Thread
    objects are single-use)."""
    from interactive_vit_tpu.serving.batcher import MicroBatcher

    import numpy as np

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.ops.node_ops import register_builtin

    reg = Registry()
    register_builtin(reg)
    b = MicroBatcher(Executor(reg=reg), max_wait_ms=1.0)

    def eval_once():
        g = Graph()
        n = g.add_node("cos", {"A": "1.0", "b": "0.0"})
        g.add_input(np.ones((4, 4), np.float32), n, "o")
        return b.submit(g, taps="all").result(timeout=30)

    out1 = eval_once()
    b.stop()
    out2 = eval_once()  # restarts the worker
    np.testing.assert_allclose(out2[0]["o"], out1[0]["o"])
    b.stop()


def test_batcher_minority_signature_not_starved():
    """Other-signature items go to the backlog and are served FIRST next
    cycle, ahead of later same-signature arrivals."""
    from interactive_vit_tpu.serving.batcher import MicroBatcher

    b = MicroBatcher(_StubExecutor(), max_batch=4, max_wait_ms=1.0)
    first = _stub_item("sigA")
    minority = _stub_item("sigB")
    b._q.put(minority)
    group = b._collect_group(first)
    assert [it.sig for it in group] == ["sigA"]
    assert [it.sig for it in b._backlog] == ["sigB"]
    # next cycle serves the backlog before the queue
    later = _stub_item("sigA")
    b._q.put(later)
    nxt = b._next_item(block=True)
    assert nxt is minority


def test_bf16_response_negotiation_over_http(served):
    """resp_dtype=bf16 halves tap bytes end-to-end; default stays f32."""
    from interactive_vit_tpu.wire.codec import (
        REQUEST_MAGIC, decode_message, encode_message,
    )

    _, base = served
    x = np.linspace(0, 1, 256, dtype=np.float32)
    raw = Request.encode(make_cos_graph(x))
    f32_resp = _post(base + "/compute", raw)

    obj, tensors = decode_message(bytes(raw), expect_magic=REQUEST_MAGIC)
    obj["resp_dtype"] = "bf16"
    bf16_resp = _post(
        base + "/compute", bytes(encode_message(REQUEST_MAGIC, obj, tensors)))
    assert len(bf16_resp) < len(f32_resp)
    out = Response.decode(bf16_resp)
    # bf16 carries ~3 decimal digits: plenty for viewer taps
    np.testing.assert_allclose(out[0]["o"], np.cos(2.0 * x), atol=2e-2)


def test_metrics_phase_breakdown(served):
    """decode/queue/compute/encode phases appear in /metrics (the latency
    attribution the RTT-floor claim rests on)."""
    _, base = served
    x = np.ones((64,), np.float32)
    _post(base + "/compute", Request.encode(make_cos_graph(x)))
    m = json.loads(_get(base + "/metrics"))
    for key in ("decode_p50_ms", "queue_p50_ms", "compute_p50_ms",
                "encode_p50_ms", "request_p50_ms"):
        assert key in m, key
        assert m[key] >= 0
    assert m["counters"]["response_bytes"] > 0


def test_dense_feature_nodes_over_http(served):
    """pca_view/patch_sim are served net-node kinds: /description lists
    their IO, /contents ships the param-bound editors, and a /compute
    request through them returns the rendered maps."""
    app, base = served
    io = json.loads(_get(f"{base}/description/pca_view"))
    assert io == {"ins": ["o"], "outs": ["o"]}
    html = _get(f"{base}/contents/patch_sim").decode()
    assert 'data-param="row"' in html and 'data-param="col"' in html

    x = np.random.default_rng(0).standard_normal((1, 10, 8)).astype(np.float32)
    g = Graph()
    pca = g.add_node("pca_view", {"skip": "1"})
    sim = g.add_node("patch_sim", {"row": "1", "col": "2"})
    g.add_input(x, pca, "o")
    g.add_input(x, sim, "o")
    resp = _post(f"{base}/compute", Request.encode(g))
    out = Response.decode(resp)
    assert out[0]["o"].shape == (1, 3, 3, 3)
    assert out[1]["o"].shape == (1, 3, 3, 3)
    assert out[1]["o"][0, 0, 1, 2] == pytest.approx(1.0, abs=1e-5)


def test_warmup_compiles_every_bucket():
    """--warmup pre-compiles the single program AND each power-of-two
    vmapped bucket so a first concurrent burst never pays a cold compile
    mid-traffic."""
    from interactive_vit_tpu.serving.server import build_app, warmup

    app = build_app(models=("vit_t16",))
    try:
        warmup(app, ["vit_t16"], batch_sizes=(1, 2, 4))
        assert app.executor.cache_info()["entries"] >= 3
    finally:
        app.batcher.stop()


def test_concurrent_dynamic_variant_requests_get_batched(served):
    """Concurrent sessions with DIFFERENT dynamic values (distinct cos A
    per client) share a vmapped batch: the batcher groups on the program
    signature and run_stacked stacks per-request captures (VERDICT r2
    #5). Each client still gets its own A."""
    app, base = served
    x = np.linspace(0, 1, 32).astype(np.float32)
    # warm the stacked bucket so the group path is compiled
    app.executor.run_stacked(
        [make_cos_graph(x, a=str(a)) for a in (9.0,) * 8], taps="all")
    before = app.metrics.snapshot()["counters"].get("batches", 0)
    a_vals = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    results = [None] * len(a_vals)

    def worker(i):
        raw = _post(base + "/compute",
                    Request.encode(make_cos_graph(x, a=str(a_vals[i]))))
        results[i] = Response.decode(raw)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(a_vals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    for i, a in enumerate(a_vals):
        np.testing.assert_allclose(results[i][0]["o"], np.cos(a * x),
                                   rtol=1e-5)
    batches = app.metrics.snapshot()["counters"]["batches"] - before
    assert batches < len(a_vals), "dynamic variants did not share a batch"


def test_profile_endpoint(served):
    """POST /profile returns the trace_agg device-time report for one
    request: structure always (CPU traces carry no hlo_category device
    events, so totals may be 0 off-accelerator), iters/wall always."""
    app, base = served
    x = np.arange(6, dtype=np.float32)
    body = Request.encode(make_cos_graph(x))
    rep = json.loads(_post(base + "/profile?iters=2&top=5", body))
    assert set(rep) >= {"total_device_us", "by_category_us", "top_ops_us",
                        "iters", "wall_ms", "note"}
    assert rep["iters"] == 2
    assert rep["wall_ms"] > 0


def test_profile_busy_is_409(served):
    app, base = served
    x = np.arange(4, dtype=np.float32)
    body = Request.encode(make_cos_graph(x))
    # simulate an in-flight capture by holding the lock
    json.loads(_post(base + "/profile", body))  # creates the lock lazily
    app._profile_lock.acquire()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/profile", body)
        assert ei.value.code == 409
    finally:
        app._profile_lock.release()


def test_profile_bad_bytes_is_400(served):
    _, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/profile", b"garbage")
    assert ei.value.code == 400


def test_request_id_header(served):
    """Every /compute response carries X-IVT-Request-Id (generation-pid-
    counter), correlating client observations with server log lines."""
    _, base = served
    x = np.linspace(0, 1, 8, dtype=np.float32)
    body = Request.encode(make_cos_graph(x))
    r1 = urllib.request.urlopen(urllib.request.Request(
        base + "/compute", data=bytes(body), method="POST"))
    r1.read()
    rid1 = r1.headers.get("X-IVT-Request-Id")
    r2 = urllib.request.urlopen(urllib.request.Request(
        base + "/compute", data=bytes(body), method="POST"))
    r2.read()
    rid2 = r2.headers.get("X-IVT-Request-Id")
    assert rid1 and rid2 and rid1 != rid2
    assert rid1.startswith("g0-")


def test_request_id_not_reused_on_keepalive_get(served):
    """A GET (/metrics) after a /compute on the SAME keep-alive
    connection must not echo the previous compute's request id —
    handler instances persist across a connection's requests, so a
    stale ``_rid`` would mis-correlate client observations with log
    lines (advisor r4)."""
    import http.client

    _, base = served
    host, port = base.split("//")[1].split(":")
    x = np.linspace(0, 1, 8, dtype=np.float32)
    body = bytes(Request.encode(make_cos_graph(x)))
    c = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        c.request("POST", "/compute", body=body)
        r1 = c.getresponse()
        r1.read()
        assert r1.getheader("X-IVT-Request-Id")
        c.request("GET", "/metrics")
        r2 = c.getresponse()
        r2.read()
        assert r2.getheader("X-IVT-Request-Id") is None
    finally:
        c.close()


def test_pipeline_depth_2_resolves_all_signatures():
    """Depth-2 dispatch pipelining: with two groups in flight, results
    still route to the right futures in order, mixed signatures
    included (the r5 batcher-efficiency experiment's knob)."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.serving.batcher import MicroBatcher

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)
    b = MicroBatcher(ex, max_batch=4, max_wait_ms=2.0, pipeline_depth=2)
    b.start()
    try:
        futs = []
        for i in range(9):
            x = np.linspace(0, 1, 8 + (i % 3), dtype=np.float32)
            g = Graph()
            n = g.add_node("cos", {"A": str(2.0 + (i % 3))})
            g.add_input(x, n, "o")
            futs.append((x, 2.0 + (i % 3), b.submit(g, taps="primary")))
        for x, a, f in futs:
            out = f.result(timeout=60)
            (got,) = (v for sub in out.values() for v in sub.values())
            np.testing.assert_allclose(np.asarray(got), np.cos(a * x),
                                       rtol=1e-5)
    finally:
        b.stop()
