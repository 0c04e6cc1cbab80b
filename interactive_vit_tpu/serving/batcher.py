"""Continuous micro-batcher: concurrent graph evals into device batches.

The reference served one request per eval, strictly sequentially
(``/root/reference/main/views.py:30-42`` -> eager per-node torch loop). Under
concurrent interactive sessions that serializes everything. This batcher
(BASELINE config 5) instead:

* queues incoming (graph, taps) requests;
* groups consecutive requests by the executor's *program signature*
  (topology + static params + input shapes + tap set; dynamic param
  values are excluded — they stack as per-request captures);
* executes a group as ONE vmapped XLA program (``Executor.run_stacked``);
* resolves per-request futures with their slice of the results.

Single-request groups take the unbatched fast path (no vmap compile).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

from interactive_vit_tpu.graph.executor import Executor, TapSpec
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.serving.metrics import Metrics

logger = logging.getLogger(__name__)

_IDLE = object()  # sentinel: non-blocking poll found nothing


class _Item:
    __slots__ = ("graph", "taps", "future", "enqueued", "sig", "queue_s")

    def __init__(self, graph: Graph, taps: TapSpec, sig: str):
        self.graph = graph
        self.taps = taps
        self.sig = sig
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.queue_s = 0.0


class MicroBatcher:
    """Background worker turning a request stream into device micro-batches."""

    def __init__(
        self,
        executor: Executor,
        max_batch: int = 8,
        max_wait_ms: float = 3.0,
        metrics: Optional[Metrics] = None,
        pipeline_depth: int = 1,
    ):
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.metrics = metrics or Metrics()
        # how many dispatched groups may be in flight before the oldest
        # is materialized (device_get + future resolution). 1 = the
        # default (depth-1 pipeline: batch i's transfer overlaps batch
        # i+1's compute); >1 keeps more compute queued on the device at
        # the cost of result latency for the oldest group
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        # wall time of the newest submit OR result delivery, plus an
        # in-flight group counter: consumers (the speculative tap warmer)
        # gate background compiles on a QUIET PERIOD — an actively-
        # scrubbing user would otherwise interleave real cold compiles
        # behind speculative ones (measured on-chip: 6.7s -> 24s
        # compounding). Submit time alone is NOT enough (a 6s compile
        # makes the last submit "old" the moment its result lands), and
        # neither is activity time alone: a dispatched group leaves the
        # queue, so mid-compile the queue looks empty — the warmer then
        # races the real compile (measured: duplicate concurrent compiles
        # of the same program). Hence the explicit in-flight count.
        self.last_activity_t = 0.0
        self.inflight = 0
        # other-signature items deferred while collecting a group; consumed
        # FIRST next cycle (FIFO), so a minority signature can't be starved
        # by a steady majority stream. Worker-thread-only, no lock needed.
        self._backlog: List[_Item] = []
        # optional serving hook, called once per dispatched group on the
        # worker thread with (graph, taps, batch_or_None, group_len)
        # BEFORE dispatch: serving/app.py wires inventory recording (the
        # recycle-warm loop) + speculative warm-hit accounting through it
        self.on_dispatch = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        # the lock makes stop atomic w.r.t. submit: an item can never be
        # enqueued between the worker draining and the thread dying (it
        # would hang its HTTP handler until the compute timeout)
        with self._lock:
            if self._started and self._thread is not None:
                self._q.put(None)
                self._thread.join(timeout=5)
                self._started = False
                if not self._thread.is_alive():
                    # keep a still-running thread (join timed out mid-
                    # compile) so _start_locked won't spawn a SECOND
                    # worker over the same queue/backlog
                    self._thread = None

    def submit(self, graph: Graph, taps: TapSpec = "all") -> Future:
        """Enqueue one eval; returns a Future of {node: {ch: array}}.

        Grouping uses the executor's PROGRAM signature (dynamic params
        excluded): requests differing only in e.g. a noise seed or an
        edited conv matrix share one vmapped batch — ``run_stacked``
        stacks their dynamic captures per request (SURVEY §7
        "micro-batching heterogeneous graphs")."""
        # normalize one-shot iterables ONCE: sorted() below would exhaust
        # a generator and store an empty tap set on the item (the program
        # would compile with zero outputs and silently return {})
        if not isinstance(taps, str):
            taps = frozenset(taps)
        tap_key = taps if isinstance(taps, str) else str(sorted(taps))
        item = _Item(graph, taps, self.executor.group_sig(
            graph, extra=[tap_key]))
        with self._lock:
            if (not self._started and self._thread is not None
                    and self._thread.is_alive()):
                # stop()'s join timed out (worker wedged in a compile)
                # and the old worker is still exiting: an item enqueued
                # now could land AFTER its drain pass and hang its HTTP
                # handler until the compute timeout — fail fast instead
                raise RuntimeError(
                    "batcher is stopping (worker still exiting); retry")
            self._start_locked()
            self.last_activity_t = time.perf_counter()
            self._q.put(item)
        return item.future

    def quiet_for(self, seconds: float) -> bool:
        """True when nothing is queued, nothing is in flight, and no
        submit/result happened for ``seconds`` — the speculative
        warmer's idle gate."""
        return (self.inflight == 0 and self._q.empty()
                and not self._backlog
                and time.perf_counter() - self.last_activity_t >= seconds)

    # -- worker ----------------------------------------------------------------
    def _collect_group(self, first: _Item) -> List[_Item]:
        """Gather same-signature items up to max_batch within the window.

        Same-signature items already in the backlog join immediately;
        other signatures seen on the queue go to the BACK of the backlog
        (the front of next cycle's service order — arrival-order fair).
        """
        group = [first]
        keep: List[_Item] = []
        for it in self._backlog:
            if it.sig == first.sig and len(group) < self.max_batch:
                group.append(it)
            else:
                keep.append(it)
        self._backlog = keep
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:  # shutdown marker: push back and bail
                self._q.put(None)
                break
            if item.sig == first.sig:
                group.append(item)
            else:
                self._backlog.append(item)
        return group

    def _next_item(self, block: bool) -> Optional[_Item]:
        if self._backlog:
            return self._backlog.pop(0)
        try:
            return self._q.get() if block else self._q.get_nowait()
        except queue.Empty:
            return _IDLE

    def _loop(self) -> None:
        # pipelined dispatch (depth = self.pipeline_depth, default 1):
        # after dispatching batch i+1 (async — jax returns in-flight
        # arrays), materialize batch i, so i's device->host transfer and
        # future resolution overlap i+1's device compute. All dispatches
        # AND transfers stay on this one thread (some PJRT plugins
        # deadlock on cross-thread device_get).
        pending: List = []  # FIFO of (group, flat_device_results, t0)
        while True:
            item = self._next_item(block=not pending)
            if item is _IDLE:
                # queue idle: finish the in-flight batches now
                for p in pending:
                    self._materialize(p)
                pending = []
                continue
            if item is None:
                for p in pending:
                    self._materialize(p)
                self._drain_stopped()
                return
            group = self._collect_group(item)
            if pending:
                try:
                    # single-request groups dispatch via run() — their
                    # program is the UNBATCHED one (batch=None); passing
                    # 1 would probe the distinct stacked-bucket-1 sig
                    compiled = self.executor.is_compiled(
                        group[0].graph, group[0].taps,
                        len(group) if len(group) > 1 else None)
                except Exception:  # noqa: BLE001 — bad graph: _dispatch
                    # will fail the group's futures with the attributed
                    # error; a raise HERE would kill the worker thread and
                    # orphan both the in-flight batch and this group
                    compiled = False
                if not compiled:
                    # this dispatch will cold-compile (5-30s): resolve the
                    # already-finished batches first instead of stalling
                    for p in pending:
                        self._materialize(p)
                    pending = []
            dispatched = self._dispatch(group)
            if dispatched is not None:
                pending.append(dispatched)
            while len(pending) > self.pipeline_depth:
                self._materialize(pending.pop(0))

    def _drain_stopped(self) -> None:
        """Fail anything still queued at shutdown — a pending Future that
        is never resolved hangs its HTTP handler thread forever."""
        err = RuntimeError("batcher stopped")
        leftovers = list(self._backlog)
        self._backlog = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                leftovers.append(it)
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(err)

    def _dispatch(self, group: List[_Item]):
        """Launch a group on the device; returns the in-flight handle or
        None if staging/dispatch failed (futures already failed)."""
        t0 = time.perf_counter()
        self.last_activity_t = t0
        self.inflight += 1
        for it in group:
            it.queue_s = t0 - it.enqueued
            self.metrics.queue_latency.observe(it.queue_s)
        if self.on_dispatch is not None:
            try:
                self.on_dispatch(group[0].graph, group[0].taps,
                                 len(group) if len(group) > 1 else None,
                                 len(group))
            except Exception:  # noqa: BLE001 — accounting hooks must
                # never fail a live group
                logger.debug("dispatch hook failed", exc_info=True)
        try:
            if len(group) == 1:
                flat = self.executor.run(group[0].graph, group[0].taps,
                                         defer=True)
            else:
                flat = self.executor.run_stacked(
                    [it.graph for it in group], group[0].taps, defer=True
                )
            return (group, flat, t0)
        except Exception as err:  # noqa: BLE001 — fail the whole group
            logger.exception("batch dispatch failed")
            self.metrics.inc("batch_errors")
            self.inflight -= 1
            self.last_activity_t = time.perf_counter()
            for it in group:
                if not it.future.done():
                    it.future.set_exception(err)
            return None

    def _materialize(self, pending) -> None:
        if pending is None:
            return
        group, flat, t0 = pending
        try:
            import jax

            flat = jax.device_get(flat)
            if len(group) == 1:
                results = [Executor.split_single(flat)]
            else:
                results = Executor.split_stacked(flat, len(group))
            compute_s = time.perf_counter() - t0
            self.metrics.compute_latency.observe(compute_s)
            self.metrics.batch_sizes.observe(len(group))
            self.metrics.inc("batches")
            self.metrics.inc("batched_requests", len(group))
            for it, res in zip(group, results):
                # per-request phase attribution (X-IVT-Timing): plain
                # attributes on the Future, read by App.compute after
                # result() — no result-shape change for callers
                it.future.ivt_timing = {
                    "queue_ms": round(it.queue_s * 1e3, 2),
                    "compute_ms": round(compute_s * 1e3, 2),
                    "batch": len(group),
                }
                it.future.set_result(res)
                self.metrics.request_latency.observe(
                    time.perf_counter() - it.enqueued
                )
        except Exception as err:  # noqa: BLE001 — device errors surface here
            logger.exception("batch failed")
            self.metrics.inc("batch_errors")
            for it in group:
                if not it.future.done():
                    it.future.set_exception(err)
        finally:
            # only AFTER the device_get + future resolution: a multi-MB
            # maps tap takes a while to transfer, and decrementing at
            # entry would open the quiet gate mid-request
            self.inflight -= 1
            self.last_activity_t = time.perf_counter()
