"""Served-program inventory: warm the NEXT worker generation's caches.

Each fresh worker generation (serving/recycle.py) boots with an EMPTY
in-process program cache: every program signature the previous
generation served must re-stage (trace + lower + persistent-cache
deserialize) on first demand, and under sustained traffic clients eat a
seconds-long p50 until the whole working set is rebuilt.

This module closes the loop:

- ``ProgramInventory.record`` runs on the batcher worker thread at each
  group dispatch: first sight of a (program-signature, bucket) captures
  a SHAPE-ONLY description of the request graph (node names + params,
  wiring, input ShapeDtypeStructs, tap set, batch bucket) — no tensor
  bytes; later sights just bump the request count.
- ``Recycler.exec_next`` saves the inventory (plus the generation's
  speculation counters, so lifetime totals survive the exec) right
  before replacing the process.
- The next generation's boot loads the file and calls ``warm``:
  signatures re-stage through ``Executor.precompile`` in request-count
  order (hottest first) under a wall-clock budget; anything left over
  is handed to the speculative warmer's queue so it finishes in the
  background while traffic flows. With the persistent XLA cache on,
  each warm is staging + cache deserialize, not a full compile.

The reference has no analog (its Django server held no compiled state;
``/root/reference/main/views.py:30-42`` re-ran eager torch per request);
this is the serving tier protecting its own always-hot surface.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _taps_to_json(taps) -> Any:
    if isinstance(taps, str):
        return taps
    return sorted([int(i), str(c)] for i, c in taps)


def _taps_from_json(obj) -> Any:
    if isinstance(obj, str):
        return obj
    return frozenset((int(i), str(c)) for i, c in obj)


def graph_to_shape_json(graph) -> Dict[str, Any]:
    """Shape-only graph description (no tensor bytes)."""
    nodes = [{"name": n.name, "params": dict(n.params)}
             for n in graph.nodes]
    edges = []
    for n in graph.nodes:
        for ch, e in n.inputs.items():
            if e.src is not None:
                edges.append([e.src.node.index, e.src.channel,
                              n.index, ch])
    inputs = []
    for n, ch, e in graph.input_edges():
        t = e.tensor
        inputs.append({"node": n.index, "channel": ch,
                       "shape": [int(d) for d in t.shape],
                       "dtype": np.dtype(t.dtype).name})
    return {"nodes": nodes, "edges": edges, "inputs": inputs}


def graph_from_shape_json(obj) -> "Graph":
    """Rebuild a shape-only Graph (ShapeDtypeStruct inputs)."""
    import jax
    import jax.numpy as jnp

    from interactive_vit_tpu.graph.ir import Graph

    g = Graph()
    for n in obj["nodes"]:
        g.add_node(n["name"], dict(n["params"]))
    for s, sch, d, dch in obj["edges"]:
        g.connect(g.nodes[int(s)], sch, g.nodes[int(d)], dch)
    for spec in obj["inputs"]:
        g.add_input(
            jax.ShapeDtypeStruct(tuple(spec["shape"]),
                                 jnp.dtype(spec["dtype"])),
            g.nodes[int(spec["node"])], spec["channel"])
    return g


class ProgramInventory:
    """Thread-compatible record of every program signature served."""

    def __init__(self, path: str = ""):
        self.path = path
        self._lock = threading.Lock()
        # key -> entry dict; key = (group_sig, bucket)
        self._entries: Dict[Tuple[str, Optional[int]], Dict] = {}

    def record(self, graph, taps, batch: Optional[int], sig: str) -> None:
        """First sight captures the shape description; later sights
        count. Called per dispatched GROUP (batcher worker thread);
        never raises (inventory must not fail a live request)."""
        key = (sig, batch)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                hit["count"] += 1
                return
        try:
            entry = {"graph": graph_to_shape_json(graph),
                     "taps": _taps_to_json(taps),
                     "batch": batch, "count": 1, "sig": sig}
        except Exception as err:  # noqa: BLE001
            logger.debug("inventory record failed: %s", err)
            return
        with self._lock:
            self._entries.setdefault(key, entry)

    def seed(self, entries: List[Dict]) -> int:
        """Adopt the PREVIOUS generations' entries so coverage
        accumulates across recycles instead of shrinking to whatever
        each short-lived generation happened to serve (first r5 bench:
        26 -> 13 -> 14 warmed programs over successive generations).
        Counts are halved (floor 1) so stale popularity decays; entries
        re-served by this generation resume counting on top. Entries
        from pre-sig files are skipped."""
        n = 0
        with self._lock:
            for e in entries:
                sig = e.get("sig")
                if not sig:
                    continue
                key = (sig, e.get("batch"))
                if key not in self._entries:
                    d = dict(e)
                    d["count"] = max(1, int(e.get("count", 1)) // 2)
                    self._entries[key] = d
                    n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- persistence -----------------------------------------------------------
    def save(self, carry: Optional[Dict[str, int]] = None) -> bool:
        """Write entries (+ carried counters) to ``self.path``; atomic
        rename so a crash mid-write can't corrupt the next boot."""
        if not self.path:
            return False
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: -e["count"])
        doc = {"version": 1, "entries": entries,
               "carry_counters": dict(carry or {})}
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            return True
        except OSError as err:
            logger.warning("could not save inventory to %s: %s",
                           self.path, err)
            return False

    @staticmethod
    def load(path: str) -> Tuple[List[Dict], Dict[str, int]]:
        """(entries sorted hottest-first, carried counters)."""
        with open(path) as f:
            doc = json.load(f)
        entries = sorted(doc.get("entries", []),
                         key=lambda e: -e.get("count", 0))
        return entries, dict(doc.get("carry_counters", {}))


def warm(executor, entries: List[Dict], budget_s: float = 120.0,
         speculator=None, workers: int = 4) -> Dict[str, int]:
    """Precompile inventory entries hottest-first under a wall budget.

    Returns {"warmed": n, "deferred": m, "failed": k}. Entries that
    don't fit the budget go to the speculator's queue (background warm
    while traffic flows) when one is given, else they're dropped —
    they'll re-stage on demand exactly as before this feature.

    ``workers``: staging threads. ``Executor.precompile`` is documented
    thread-safe (ShapeDtypeStruct lowering, no device arrays, lock-
    guarded cache) and each warm is Python tracing (GIL) + an XLA
    compile (GIL released), so a few threads overlap the compiles —
    the whole warm happens while clients sit in the listen backlog.
    """
    import collections

    t0 = time.perf_counter()
    counts = {"warmed": 0, "failed": 0}
    clock = threading.Lock()
    q = collections.deque(entries)  # hottest-first pull queue

    def worker():
        while True:
            if time.perf_counter() - t0 > budget_s:
                return
            try:
                e = q.popleft()
            except IndexError:
                return
            try:
                g = graph_from_shape_json(e["graph"])
                executor.precompile(g, _taps_from_json(e["taps"]),
                                    batch=e.get("batch"))
                with clock:
                    counts["warmed"] += 1
            except Exception as err:  # noqa: BLE001 — a stale entry
                # (node kind renamed, shape policy changed) must not
                # block boot
                with clock:
                    counts["failed"] += 1
                logger.warning("inventory warm failed (%s): %s",
                               e.get("graph", {}).get("nodes", [{}])[0]
                               .get("name", "?"), str(err)[:200])

    threads = [threading.Thread(target=worker, name=f"inv-warm-{i}")
               for i in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    warmed, failed = counts["warmed"], counts["failed"]
    deferred = list(q)  # past-budget leftovers
    if deferred and speculator is not None:
        for e in deferred:
            try:
                g = graph_from_shape_json(e["graph"])
                speculator.enqueue_program(
                    g, _taps_from_json(e["taps"]), e.get("batch"))
            except Exception:  # noqa: BLE001
                pass
    logger.info(
        "inventory warm: %d compiled in %.1fs, %d deferred to the "
        "background warmer, %d failed", warmed,
        time.perf_counter() - t0, len(deferred), failed)
    return {"warmed": warmed, "deferred": len(deferred),
            "failed": failed}
