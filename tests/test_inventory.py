"""Served-program inventory + recycle warm loop (VERDICT r4 weak #1) and
speculation observability counters (weak #2).

The inventory records every program signature a worker generation
dispatches; the recycler saves it (plus lifetime speculation counters)
across the exec, and the next generation warms that exact set at boot so
clients never eat the post-recycle re-staging surge. These tests pin:
the shape-JSON graph roundtrip, record/dedup/count, save/load with
carried counters, warm() -> compiled programs (single + vmapped bucket),
the warm-hit counter (a request finding its program speculatively
compiled), the per-request X-IVT-Timing header, and the cross-generation
end-to-end loop through the real server entry point.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor, resolve_taps
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.serving import inventory as inv
from interactive_vit_tpu.serving.app import App
from interactive_vit_tpu.wire.codec import Request, Response


def make_reg():
    reg = Registry()
    register_builtin(reg)
    return reg


def cos_graph(x, a="2.0"):
    g = Graph()
    n = g.add_node("cos", {"A": a})
    g.add_input(x, n, "o")
    return g


X = np.linspace(-1, 1, 16, dtype=np.float32)


def test_shape_json_roundtrip_preserves_signature():
    reg = make_reg()
    g = Graph()
    n0 = g.add_node("cos", {"A": "2.0"})
    n1 = g.add_node("binop", {"op": "mul"})
    g.connect(n0, "o", n1, "a")
    g.add_input(X, n0, "o")
    g.add_input(X, n1, "b")
    obj = inv.graph_to_shape_json(g)
    # JSON-serializable (the file is written across the exec)
    obj = json.loads(json.dumps(obj))
    g2 = inv.graph_from_shape_json(obj)
    ex = Executor(reg)
    taps = resolve_taps(g, "primary", reg)
    assert ex._program_sig(g, taps) == ex._program_sig(
        g2, resolve_taps(g2, "primary", reg))


def test_record_dedup_and_count():
    pi = inv.ProgramInventory("")
    g = cos_graph(X)
    pi.record(g, "primary", None, sig="s1")
    pi.record(g, "primary", None, sig="s1")
    pi.record(g, "primary", 4, sig="s1")  # distinct bucket = new entry
    assert len(pi) == 2
    with pi._lock:
        counts = sorted(e["count"] for e in pi._entries.values())
    assert counts == [1, 2]


def test_save_load_carry(tmp_path):
    path = str(tmp_path / "inv.json")
    pi = inv.ProgramInventory(path)
    pi.record(cos_graph(X), "primary", None, sig="s1")
    pi.record(cos_graph(X, a="3.0"), frozenset({(0, "o")}), 2, sig="s2")
    assert pi.save(carry={"speculative_compiled": 7})
    entries, carry = inv.ProgramInventory.load(path)
    assert len(entries) == 2
    assert carry == {"speculative_compiled": 7}
    # taps shapes survive: string and explicit list forms
    forms = {json.dumps(e["taps"]) for e in entries}
    assert '"primary"' in forms


def test_warm_compiles_single_and_bucket(tmp_path):
    reg = make_reg()
    ex = Executor(reg)
    pi = inv.ProgramInventory(str(tmp_path / "inv.json"))
    g = cos_graph(X)
    sig1 = ex._program_sig(g, resolve_taps(g, "primary", reg))
    pi.record(g, "primary", None, sig=sig1)
    pi.record(g, "primary", 4, sig=sig1 + "/b4")
    pi.save()
    entries, _ = inv.ProgramInventory.load(pi.path)

    ex2 = Executor(make_reg())
    stats = inv.warm(ex2, entries, budget_s=60.0)
    assert stats == {"warmed": 2, "deferred": 0, "failed": 0}
    assert ex2.is_compiled(g, "primary")
    assert ex2.is_compiled(g, "primary", batch=4)


def test_warm_budget_defers_to_speculator(tmp_path):
    reg = make_reg()
    ex = Executor(reg)
    entries = []
    for i, a in enumerate(["1.0", "2.0", "3.0"]):
        g = cos_graph(X, a=a)
        # distinct STATIC param -> distinct program: force via shuffle
        g2 = Graph()
        n = g2.add_node("cos", {"A": "1.0"})
        g2.add_input(np.zeros((4 + i,), np.float32), n, "o")
        entries.append({"graph": inv.graph_to_shape_json(g2),
                        "taps": "primary", "batch": None,
                        "count": 10 - i})
    from interactive_vit_tpu.serving.speculate import TapSpeculator

    spec = TapSpeculator(ex)
    stats = inv.warm(ex, entries, budget_s=0.0, speculator=spec)
    assert stats["warmed"] == 0 and stats["deferred"] == 3
    # drain compiles them on the calling thread, hottest first
    n = spec.drain(timeout_s=60)
    assert n == 3
    for i in range(3):
        g = Graph()
        nn = g.add_node("cos", {"A": "1.0"})
        g.add_input(np.zeros((4 + i,), np.float32), nn, "o")
        assert ex.is_compiled(g, "primary")


def test_warm_survives_stale_entries():
    ex = Executor(make_reg())
    stale = {"graph": {"nodes": [{"name": "gone_kind", "params": {}}],
                       "edges": [],
                       "inputs": [{"node": 0, "channel": "o",
                                   "shape": [4], "dtype": "float32"}]},
             "taps": "primary", "batch": None, "count": 5}
    g = cos_graph(X)
    good = {"graph": inv.graph_to_shape_json(g), "taps": "primary",
            "batch": None, "count": 1}
    stats = inv.warm(ex, [stale, good], budget_s=60.0)
    assert stats["warmed"] == 1 and stats["failed"] == 1
    assert ex.is_compiled(g, "primary")


def test_warm_hit_counter_and_inventory_record(tmp_path):
    """A request whose program the speculator already compiled counts as
    a warm hit; every dispatched group lands in the inventory."""
    app = App(reg=make_reg(), graphs_dir=str(tmp_path),
              max_wait_ms=1.0,
              inventory_path=str(tmp_path / "inv.json"))
    g = cos_graph(X)
    # pretend the speculator compiled this exact program
    sig = app.executor._program_sig(
        g, resolve_taps(g, "primary", app.reg))
    app.executor.precompile(g, "primary")
    with app.speculator._lock:
        app.speculator.compiled_sigs.add(sig)
    app.batcher.start()
    try:
        body = bytes(Request.encode(cos_graph(X)))
        raw = app.compute(body)
        Response.decode(raw)
        assert app.metrics.counters.get("speculative_warm_served") == 1
        assert app.metrics.counters.get("speculative_warm_sigs") == 1
        assert len(app.inventory) == 1
        # second request: served count grows, unique sigs doesn't
        app.compute(body)
        assert app.metrics.counters.get("speculative_warm_served") == 2
        assert app.metrics.counters.get("speculative_warm_sigs") == 1
        # save + carry shape
        assert app.save_inventory()
        _, carry = inv.ProgramInventory.load(str(tmp_path / "inv.json"))
        assert carry["speculative_warm_served"] == 2
        assert carry["compute_requests"] == 2
    finally:
        app.batcher.stop()


def test_timing_header_on_compute(tmp_path):
    app = App(reg=make_reg(), graphs_dir=str(tmp_path), max_wait_ms=1.0)
    httpd = app.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = bytes(Request.encode(cos_graph(X)))
        r = urllib.request.urlopen(urllib.request.Request(
            base + "/compute", data=body, method="POST"), timeout=60)
        r.read()
        timing = r.headers.get("X-IVT-Timing")
        assert timing, "X-IVT-Timing header missing"
        parts = dict(kv.split("=") for kv in timing.split(";"))
        for k in ("decode", "queue", "compute", "encode", "wall",
                  "batch"):
            assert k in parts, (k, timing)
        assert float(parts["wall"]) >= float(parts["compute"])
        assert int(parts["batch"]) == 1
        # GETs carry no timing header
        r2 = urllib.request.urlopen(base + "/metrics", timeout=30)
        r2.read()
        assert r2.headers.get("X-IVT-Timing") is None
    finally:
        httpd.shutdown()
        app.batcher.stop()


def test_generation_warms_previous_inventory(tmp_path):
    """End-to-end through the real entry point: generation 0 serves and
    recycles; generation 1 must boot having warmed gen-0's program set
    (inventory_warmed counter) and report lifetime counters."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    inv_path = str(tmp_path / "warm_inv.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "interactive_vit_tpu.serving.server",
         "--platform", "cpu", "--models", "", "--port", str(port),
         "--graphs-dir", str(tmp_path / "graphs"),
         "--jit-cache", str(tmp_path / "jit_cache"),
         "--recycle-after-requests", "3", "--no-speculate",
         "--warm-inventory", inv_path,
         "--max-wait-ms", "1"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"

    def get_json(path, timeout=30):
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                snap = get_json("/metrics", timeout=5)
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                assert proc.poll() is None, "server died during boot"
                time.sleep(0.5)
        assert snap["generation"] == 0

        body = bytes(Request.encode(cos_graph(X)))
        for _ in range(4):  # exceed the 3-request recycle budget
            req = urllib.request.Request(base + "/compute", data=body,
                                         method="POST")
            urllib.request.urlopen(req, timeout=120).read()

        deadline = time.monotonic() + 90
        while True:
            snap = get_json("/metrics", timeout=120)
            if snap["generation"] >= 1:
                break
            assert time.monotonic() < deadline, "never recycled"
            time.sleep(0.5)
        # the fresh generation warmed the previous one's program set
        assert snap["counters"].get("inventory_warmed", 0) >= 1, snap
        assert os.path.exists(inv_path)
        # lifetime counters carried across the exec
        assert snap.get("lifetime", {}).get("compute_requests", 0) >= 4
        # and the warmed program serves without re-staging
        req = urllib.request.Request(base + "/compute", data=body,
                                     method="POST")
        r = urllib.request.urlopen(req, timeout=120)
        outs = Response.decode(r.read())
        (out,) = (v for sub in outs.values() for v in sub.values())
        np.testing.assert_allclose(out, np.cos(2.0 * X), rtol=1e-5)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_seed_accumulates_across_generations(tmp_path):
    """A generation seeds its inventory from the previous generations'
    file, so coverage accumulates across recycles (counts decayed) and
    re-serving resumes counting."""
    path = str(tmp_path / "inv.json")
    g = cos_graph(X)
    pi = inv.ProgramInventory(path)
    pi.record(g, "primary", None, sig="s1")
    for _ in range(9):
        pi.record(g, "primary", None, sig="s1")
    pi.save()
    entries, _ = inv.ProgramInventory.load(path)

    pi2 = inv.ProgramInventory(path)
    assert pi2.seed(entries) == 1
    # decayed count (10 // 2 = 5), resumes counting on re-serve
    pi2.record(g, "primary", None, sig="s1")
    pi2.record(cos_graph(X, a="9.0"), "primary", None, sig="s2")
    pi2.save()
    entries2, _ = inv.ProgramInventory.load(path)
    by_sig = {e["sig"]: e for e in entries2}
    assert by_sig["s1"]["count"] == 6
    assert by_sig["s2"]["count"] == 1
    # pre-sig entries are skipped, not crashed on
    assert pi2.seed([{"graph": {}, "taps": "primary", "batch": None,
                      "count": 3}]) == 0
