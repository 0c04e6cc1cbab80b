"""Worker recycling (serving/recycle.py): bounded-lifetime serving
processes with zero-drop restarts.

Unit tests cover the budget logic; the integration test boots the REAL
server entry point as a subprocess with ``--recycle-after-requests`` and
drives sequential ``/compute`` requests through multiple exec generations,
asserting every request succeeds and the generation counter (surfaced in
``/metrics``) advances — i.e. the listen-socket handoff across ``exec``
really does park mid-restart connections in the kernel backlog instead of
refusing them.

The capability this guards: a PJRT plugin or library that leaks host RSS
per device transfer makes long soaks impossible without process
recycling.
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

from interactive_vit_tpu.serving.recycle import Recycler, rss_mb


class _FakeMetrics:
    def __init__(self, served=0):
        self.counters = {"compute_requests": served}


class _FakeApp:
    def __init__(self, served=0):
        self.metrics = _FakeMetrics(served)
        self.inflight = 0
        self.draining = False
        self.generation = 0


def test_rss_mb_reads_proc():
    cur = rss_mb()
    assert cur > 10.0  # a live CPython with jax imported is >10 MB


def test_due_reason_request_budget():
    rec = Recycler(_FakeApp(served=5), max_compute_requests=5)
    assert "served 5" in rec.due_reason()
    rec = Recycler(_FakeApp(served=4), max_compute_requests=5)
    assert rec.due_reason() == ""


def test_due_reason_rss_budget_respects_min_uptime():
    # a threshold below the live working set must NOT boot-loop: exceeded
    # within min_uptime_s, the RSS trigger disables itself (with a log)
    rec = Recycler(_FakeApp(), max_rss_mb=1, min_uptime_s=3600.0)
    assert rec.due_reason() == ""
    assert rec.max_rss_mb == 0  # disabled, not merely delayed
    rec = Recycler(_FakeApp(), max_rss_mb=1, min_uptime_s=0.0)
    assert "VmRSS" in rec.due_reason()


def test_budgets_off_by_default():
    rec = Recycler(_FakeApp(served=10**9))
    assert rec.due_reason() == ""


# -- integration ---------------------------------------------------------------


def _get_json(base, path, timeout=60):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return json.loads(r.read())


def test_recycle_generations_drop_no_requests(tmp_path):
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.wire.codec import Request, Response

    port = 0
    with socket.socket() as s:  # pick a free port (small race, fine in CI)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    proc = subprocess.Popen(
        [sys.executable, "-m", "interactive_vit_tpu.serving.server",
         "--platform", "cpu", "--models", "", "--port", str(port),
         "--graphs-dir", str(tmp_path / "graphs"),
         "--jit-cache", str(tmp_path / "jit_cache"),
         "--recycle-after-requests", "3", "--no-speculate",
         "--max-wait-ms", "1"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        # wait for generation 0 to come up
        deadline = time.monotonic() + 120
        while True:
            try:
                snap = _get_json(base, "/metrics", timeout=5)
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                assert proc.poll() is None, "server died during boot"
                time.sleep(0.5)
        assert snap["generation"] == 0
        pid0 = snap["pid"]

        x = np.linspace(-1.0, 1.0, 16, dtype=np.float32)

        def compute():
            g = Graph()
            n = g.add_node("cos", params={"A": "2", "b": "0"})
            g.add_input(x, n, "o")
            body = Request.encode(g)
            req = urllib.request.Request(base + "/compute", data=body,
                                         method="POST")
            # generous timeout: a request landing mid-recycle waits in the
            # listen backlog for the next generation's boot
            with urllib.request.urlopen(req, timeout=120) as r:
                outs = Response.decode(r.read())
            (out,) = (v for sub in outs.values() for v in sub.values())
            np.testing.assert_allclose(out, np.cos(2 * x), rtol=1e-6)

        # two recycle rounds: exceed the 3-request budget, then wait for
        # the 1 s monitor tick to recycle (the /metrics poll stalls through
        # the reboot in the listen backlog and answers from the next
        # generation) — every request in between must succeed
        generations = {(0, pid0)}
        for want_gen in (1, 2):
            for _ in range(4):
                compute()
            deadline = time.monotonic() + 90
            while True:
                snap = _get_json(base, "/metrics", timeout=120)
                generations.add((snap["generation"], snap["pid"]))
                if snap["generation"] >= want_gen:
                    break
                assert time.monotonic() < deadline, \
                    f"no recycle to gen {want_gen}: {generations}"
                time.sleep(0.5)
        gens = sorted(g for g, _ in generations)
        assert gens[-1] >= 2, f"never recycled twice: {generations}"
        # exec REPLACES the process image: the pid is stable by design
        # (supervisors keep tracking one child across recycles)
        assert {p for _, p in generations} == {pid0}
    finally:
        proc.kill()
        proc.wait(timeout=30)
