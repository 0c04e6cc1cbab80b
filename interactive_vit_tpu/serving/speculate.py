"""Speculative tap precompilation: hide the per-layer recompile stall.

The product's core interaction is splicing a viewer onto ANY intermediate
edge (reference ``main/static/main/graph.js:352-392`` port wiring +
``net_node.js`` subgraph RPC). In the staged-executor design every
distinct (topology, tap set) is its own XLA program, so the FIRST time a
user drags an attention viewer onto ``blocks.k`` they pay a cold compile
(seconds per program; SURVEY §7 "tappability vs fusion tension").

Scrubbing through layers — the canonical way to explore a transformer —
pays that stall once per layer. This module removes it: when a request
graph arrives whose viewer consumes an *extra* output channel (attention
maps, rollout) of a ``<model>:blocks.<k>`` node, a background thread
precompiles the SAME topology re-targeted at every sibling block
``blocks.<j>``. By the time the user drags the wire to the next layer,
the program is warm (both in the executor's program cache and in the
persistent XLA compile cache, so the win survives restarts).

Design constraints honored:

- ``Executor.precompile`` lowers inputs as ``ShapeDtypeStruct``s — the
  speculation thread never touches device arrays, so the backend's
  cross-thread transfer hazard (CLAUDE.md trap #5) never arises, and a
  speculative compile never steals device time from live requests
  (it compiles; nothing executes).
- Jobs are deduplicated by program signature and processed LIFO (the
  most recently observed interaction pattern is the most likely next
  edit); the queue is bounded.
- An ``idle`` callback gates job starts: while live requests are queued
  the warmer waits, so speculative compiles don't contend with a real
  cold compile for the host's cores.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

import jax
import numpy as np

from interactive_vit_tpu.graph.executor import Executor, TapSpec
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry

logger = logging.getLogger(__name__)

# any model node whose name's FINAL dotted component is an integer is a
# scrub-able layer: vit/clip "…:blocks.<k>", swin "…:stages.<s>.<b>"
# (siblings stay within one stage — same shapes, the adjacent-scrub
# case), swin "…:merge.<s>", resnet "…:layer<i>.<j>". Non-indexed nodes
# (cos, pca_view, vgg's named convs) never match.
_BLOCK_RE = re.compile(r"^(?P<prefix>.+\.)(?P<idx>\d+)$")


from interactive_vit_tpu.graph.executor import shape_struct as _shape_only


def _clone_shape_graph(g: Graph) -> Graph:
    """Structural clone with ShapeDtypeStruct inputs (no tensor bytes).

    Edge insertion order differs from the original's wire order; that is
    fine — ``Graph.signature`` sorts edges, so the clone signature-matches
    the original exactly.
    """
    c = Graph()
    for n in g.nodes:
        c.add_node(n.name, dict(n.params))
    for n in g.nodes:
        for ch, e in n.inputs.items():
            if e.src is None:
                c.add_input(_shape_only(e.tensor), c.nodes[n.index], ch)
            else:
                c.connect(c.nodes[e.src.node.index], e.src.channel,
                          c.nodes[n.index], ch)
    return c


def tap_variants(
    graph: Graph, taps: TapSpec, reg: Registry,
) -> List[Tuple[Graph, TapSpec]]:
    """Sibling-block re-targets of every consumed/tapped extra channel.

    For each edge (or explicit tap entry) reading an extra output channel
    ``ch`` of a layer-indexed node (``...blocks.<k>``, swin's
    ``...stages.<s>.<b>``, …), yield one (graph, taps) variant per
    sibling (same name prefix, ``ch`` among its outputs) with that
    edge/tap moved to the sibling — exactly the graph the client ships
    when the user drags the viewer wire one layer over.
    """
    # (node_index, channel) pairs currently feeding a consumer or tap
    reads: List[Tuple[int, str]] = []
    explicit = (set() if isinstance(taps, str)
                else {(int(i), c) for i, c in taps})
    siblings: dict = {}  # prefix -> [node_index...]
    for n in graph.nodes:
        m = _BLOCK_RE.match(n.name)
        if not m:
            continue
        siblings.setdefault(m.group("prefix"), []).append(n.index)
        try:
            kind = reg.get_node(n.name)
        except KeyError:
            continue
        for ch in kind.extra_outs(n.params):
            consumed = any(e.dst is not None
                           for e in n.outputs.get(ch, []))
            if consumed or (n.index, ch) in explicit:
                reads.append((n.index, ch))

    out: List[Tuple[Graph, TapSpec]] = []
    for src_idx, ch in reads:
        m = _BLOCK_RE.match(graph.nodes[src_idx].name)
        prefix = m.group("prefix")
        src_blk = int(m.group("idx"))

        def _dist(node_idx: int) -> int:
            return abs(int(_BLOCK_RE.match(
                graph.nodes[node_idx].name).group("idx")) - src_blk)

        # farthest-first: the consumer pops the LIFO stack, so the
        # NEAREST sibling (the user's most likely next scrub target)
        # compiles first
        for j in sorted(siblings.get(prefix, []), key=_dist, reverse=True):
            if j == src_idx:
                continue
            try:
                if ch not in reg.get_node(
                        graph.nodes[j].name).io(
                            graph.nodes[j].params)["outs"]:
                    continue
            except Exception:  # noqa: BLE001 — skip unknowable siblings
                continue
            # one variant per consumer edge: a user drag moves ONE wire,
            # so each variant re-targets exactly one consumer. Edges into
            # a SIBLING block are not viewer taps but chain carries (the
            # rollout's blocks.i r -> blocks.i+1 r wiring): re-targeting
            # them is no user gesture and a depth-d rollout chain would
            # otherwise explode into O(d^2) junk compiles
            consumers = [
                e for e in graph.nodes[src_idx].outputs.get(ch, [])
                if e.dst is not None and not (
                    (m2 := _BLOCK_RE.match(e.dst.node.name))
                    and m2.group("prefix") == prefix)
            ]
            for e in consumers:
                v = _clone_shape_graph(graph)
                v.connect(v.nodes[j], ch,
                          v.nodes[e.dst.node.index], e.dst.channel)
                out.append((v, taps))
            if (src_idx, ch) in explicit:
                v = _clone_shape_graph(graph)
                out.append((v, frozenset(
                    (explicit - {(src_idx, ch)}) | {(j, ch)})))
    return out


def param_variants(
    graph: Graph, reg: Registry,
) -> List[Graph]:
    """Signature-changing param neighbors (NodeKind.param_variants).

    For each node whose kind names likely next param sets (e.g. the
    prompt node's count+1 / count-1 lists), yield one shape-clone with
    that node's params replaced — the program the client ships right
    after an add/remove edit."""
    out: List[Graph] = []
    for n in graph.nodes:
        try:
            kind = reg.get_node(n.name)
            alts = kind.param_variants(n.params)
        except Exception:  # noqa: BLE001 — speculation never raises
            continue
        for alt in alts:
            try:
                v = _clone_shape_graph(graph)
                v.nodes[n.index].params = dict(alt)
                out.append(v)
            except Exception:  # noqa: BLE001
                continue
    return out


# -- persistent-cache hit counting (process-global, install-once) -----------
_cache_hits = 0
_cache_listener_installed = False


def _install_cache_listener() -> None:
    """Count /jax/compilation_cache/cache_hits monitoring events so
    speculative compiles can be classified restore-vs-fresh."""
    global _cache_listener_installed
    if _cache_listener_installed:
        return

    def _on_event(event, **kw):  # noqa: ANN001 — jax callback shape
        global _cache_hits
        if event == "/jax/compilation_cache/cache_hits":
            _cache_hits += 1

    try:
        jax.monitoring.register_event_listener(_on_event)
        _cache_listener_installed = True
    except Exception as err:  # noqa: BLE001 — metrics are best-effort
        logger.debug("cache-hit listener unavailable: %s", err)


class TapSpeculator:
    """Background warmer: observes request graphs, precompiles siblings."""

    def __init__(self, executor: Executor,
                 idle: Optional[Callable[[], bool]] = None,
                 max_queue: int = 64, idle_grace_s: float = 0.25,
                 buckets: Tuple[int, ...] = (1,),
                 max_starvation_s: float = 12.0):
        self.executor = executor
        self.idle = idle or (lambda: True)
        self.max_queue = max_queue
        self.idle_grace_s = idle_grace_s
        # micro-batch buckets to precompile per variant: (1,) = the
        # single-request program only; add 2/4/8 when concurrent
        # same-graph sessions are expected (a burst otherwise
        # cold-compiles each vmapped bucket mid-traffic). Buckets > 1
        # also warm the OBSERVED graph itself, not just its variants.
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        # anti-starvation: under sustained load the quiet-window gate
        # may never open. After a job has waited this long, compile it
        # anyway: a speculative compile costs host time (tracing and
        # XLA compilation), not device time, bounded to one job per
        # starvation window. 0 disables the override. The 12 s default
        # was tuned against an earlier machine's compile times and is
        # open to re-tuning.
        self.max_starvation_s = max_starvation_s
        self._starved_since: Optional[float] = None
        # raw observations (shape-only clones), expanded into jobs on
        # the WARMER thread — variant generation + per-variant program
        # signatures are several ms of work that must not ride the
        # synchronous /compute path
        self._obs: List[Tuple[Graph, TapSpec]] = []
        # (sig, graph, taps, bucket) jobs, LIFO stack. Dedup is
        # _queued + live executor-cache membership — there is
        # deliberately NO permanent done-set: programs evicted from the
        # executor's LRU must be re-warmable, and a transient compile
        # failure must not blacklist its variant
        # for the process lifetime.
        self._jobs: List[Tuple[str, Graph, TapSpec, int]] = []
        self._queued: set = set()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.compiled = 0  # diagnostics / tests
        # of those, how many were persistent-cache RESTORES (the XLA
        # compile was skipped; only staging ran) vs fresh compiles —
        # attributed via the /jax/compilation_cache/cache_hits
        # monitoring event (best-effort: a concurrent live compile
        # hitting the cache inside the same window can misattribute one)
        self.cache_restores = 0
        # every program signature this speculator ever compiled, so the
        # serving tier can count WARMED HITS — a request arriving to
        # find its program already speculatively compiled (the product
        # metric; VERDICT r4 weak #2)
        self.compiled_sigs: set = set()
        # count of _loop iterations that raised and were recovered;
        # surfaced as `speculator_recoveries` in /metrics so a
        # persistently-failing idle()/expand path is visible in
        # production instead of silently disabling speculation
        self.recoveries = 0
        _install_cache_listener()

    # -- producer side (HTTP handler threads) --------------------------------
    def observe(self, graph: Graph, taps: TapSpec) -> int:
        """Record one observation (cheap: one shape-only clone); the
        warmer thread expands it into sibling-variant compile jobs.
        Returns 1 if recorded. Never raises (speculation must not fail
        a live request)."""
        if self.executor.mesh is not None or not self.executor.use_jit:
            return 0
        try:
            clone = _clone_shape_graph(graph)
        except Exception:  # noqa: BLE001 — malformed graphs just don't warm
            return 0
        with self._lock:
            self._obs.append((clone, taps))
            del self._obs[: max(0, len(self._obs) - 8)]
        self._wake.set()
        return 1

    def _expand(self, graph: Graph, taps: TapSpec) -> None:
        """Warmer thread: observation -> deduped compile jobs."""
        from interactive_vit_tpu.graph.executor import resolve_taps

        try:
            variants = tap_variants(graph, taps, self.executor.reg)
        except Exception:  # noqa: BLE001
            return
        # larger buckets warm the observed graph itself too: the burst
        # case is "several users tapping the SAME thing concurrently".
        # LIFO pop order = reverse of this list: single-request variant
        # programs first (the likeliest next need), then bucket
        # programs, then the observed graph's own buckets
        try:
            pvars = param_variants(graph, self.executor.reg)
        except Exception:  # noqa: BLE001
            pvars = []
        candidates = [(v, taps, 1) for v in pvars]
        candidates += [(graph, taps, b)
                       for b in sorted(self.buckets, reverse=True) if b > 1]
        candidates += [(v, vt, b)
                       for b in sorted(self.buckets, reverse=True)
                       for v, vt in variants]
        for v, vtaps, bkt in candidates:
            try:
                sig = self.executor._program_sig(
                    v, resolve_taps(v, vtaps, self.executor.reg),
                    batch=(bkt if bkt > 1 else None))
            except Exception:  # noqa: BLE001
                continue
            with self.executor._cache_lock:
                cached = sig in self.executor._cache
            with self._lock:
                if cached or sig in self._queued:
                    continue
                self._jobs.append((sig, v, vtaps, bkt))
                self._queued.add(sig)
                # bound the queue, dropping OLDEST first — releasing
                # their sigs so a later observation can re-enqueue them
                overflow = max(0, len(self._jobs) - self.max_queue)
                if overflow:
                    dropped = self._jobs[:overflow]
                    del self._jobs[:overflow]
                    self._queued.difference_update(
                        j[0] for j in dropped)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="tap-speculator")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def drain(self, timeout_s: float = 300.0) -> int:
        """Synchronously expand observations and run all queued jobs on
        the CALLING thread (tests and boot-time warmup; the background
        thread stays untouched)."""
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < timeout_s:
            obs = self._pop_obs()
            if obs is not None:
                self._expand(*obs)
                continue
            job = self._pop()
            if job is None:
                break
            n += self._compile(job)
        return n

    # -- worker ----------------------------------------------------------------
    def _pop_obs(self):
        with self._lock:
            return self._obs.pop() if self._obs else None

    def _pop(self):
        with self._lock:
            if not self._jobs:
                return None
            job = self._jobs.pop()  # LIFO: newest observation first
            self._queued.discard(job[0])
            return job

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            if self._stop.is_set():
                return
            # the ENTIRE iteration body is best-effort: an exception
            # anywhere (a batcher double without quiet_for, an
            # unexpected graph shape in _expand, a flaky executor lock)
            # must degrade speculation, never terminate the thread —
            # a dead warmer is invisible in production (VERDICT r3 #1)
            try:
                self._loop_once()
            except Exception as err:  # noqa: BLE001
                self.recoveries += 1
                logger.warning(
                    "speculator iteration failed (recovered, #%d): %s",
                    self.recoveries, err)
                time.sleep(self.idle_grace_s)

    def _loop_once(self) -> None:
        # expansion is cheap (no compiles) — do it promptly so the
        # job stack reflects the newest interaction pattern
        obs = self._pop_obs()
        if obs is not None:
            self._expand(*obs)
            return
        # idle gate: wait for a quiet window so a speculative compile
        # doesn't contend with a live cold compile —
        # but not forever: sustained traffic would otherwise starve
        # warming for the whole session (max_starvation_s override)
        if not self.idle():
            with self._lock:
                have_jobs = bool(self._jobs)
            if not have_jobs:
                self._starved_since = None
                time.sleep(self.idle_grace_s)
                return
            now = time.monotonic()
            if self._starved_since is None:
                self._starved_since = now
            if (not self.max_starvation_s
                    or now - self._starved_since < self.max_starvation_s):
                time.sleep(self.idle_grace_s)
                return
            # starved long enough: run ONE job despite traffic, then
            # restart the window
            self._starved_since = now
        else:
            self._starved_since = None
        job = self._pop()
        if job is None:
            self._wake.clear()
            return
        self._compile(job)

    def _compile(self, job) -> int:
        sig, graph, taps, bkt = job
        try:
            t0 = time.perf_counter()
            hits0 = _cache_hits
            fresh = self.executor.precompile(
                graph, taps, batch=(bkt if bkt > 1 else None))
            if fresh:
                self.compiled += 1
                restored = _cache_hits > hits0
                if restored:
                    self.cache_restores += 1
                with self._lock:
                    self.compiled_sigs.add(sig)
                logger.info("speculatively %s %s... in %.1fs",
                            "restored" if restored else "compiled",
                            sig[:12], time.perf_counter() - t0)
                return 1
        except Exception as err:  # noqa: BLE001 — speculation is
            # best-effort, and NOT remembered: a transient compile
            # failure must not blacklist this variant for the process life
            logger.debug("speculative compile failed: %s", err)
        return 0

    # -- external producers ----------------------------------------------------
    def enqueue_program(self, graph: Graph, taps: TapSpec,
                        batch=None) -> bool:
        """Directly enqueue ONE known program (no variant expansion) —
        the inventory warm's overflow path (serving/inventory.py): boot
        warms the hottest signatures synchronously and hands the rest
        here to finish in the background while traffic flows."""
        from interactive_vit_tpu.graph.executor import resolve_taps

        try:
            bkt = int(batch) if batch else 1
            sig = self.executor._program_sig(
                graph, resolve_taps(graph, taps, self.executor.reg),
                batch=(bkt if bkt > 1 else None))
        except Exception:  # noqa: BLE001 — stale entries just don't warm
            return False
        with self.executor._cache_lock:
            cached = sig in self.executor._cache
        with self._lock:
            if cached or sig in self._queued:
                return False
            # FRONT of the LIFO stack order = append last; inventory
            # entries arrive hottest-first, so append in reverse caller
            # order is not needed — each append makes it next-popped,
            # and the caller iterates hottest-first, so insert at the
            # BOTTOM to preserve hottest-first pop order
            self._jobs.insert(0, (sig, graph, taps, bkt))
            self._queued.add(sig)
        self._wake.set()
        return True

    def was_warmed(self, sig: str) -> bool:
        """Did this speculator compile ``sig`` at some point? (Warm-hit
        accounting: the program may since have been LRU-evicted; the
        caller pairs this with a live cache check.)"""
        with self._lock:
            return sig in self.compiled_sigs
