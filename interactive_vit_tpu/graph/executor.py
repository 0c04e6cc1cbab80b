"""Staging graph executor: one graph -> one jitted XLA program.

The reference executed graphs eagerly, one torch submodule at a time
(``/root/reference/main/context.py:143-147``) and returned *every* node's
every output to the client (``main/message.py:80-83``). On an
accelerator that design wastes the compiler: intermediates bounce through
host memory and nothing fuses. This executor instead:

* topo-sorts the graph and **traces all node functions into a single Python
  closure**, which is jitted once per (topology, params, input-shapes,
  tap-set) signature and cached;
* exposes the *tapped* edges as explicit jit outputs — XLA dead-code
  eliminates everything not tapped, so "view one attention map" compiles to a
  program that computes only what feeds that map;
* attributes failures to a specific node (the client-side ``TargettedError``
  contract, ``main/static/main/nodes/net_node.js:8-21``) by validating IO
  before staging and wrapping each node's trace in a ``NodeError``;
* keeps an eager per-node debug path (``run_eager``) with the reference
  client's fault-isolation semantics (``graph.js:644-651``): a failing node
  doesn't kill the rest of the graph, downstream nodes report the upstream
  error.

Tap sets
--------
``taps="all"``      every output channel of every node (wire-protocol parity).
``taps="primary"``  every output EXCEPT unconsumed expensive extras
                    (attention maps) — the serving default.
``taps="sinks"``    only output channels with no consumer inside the graph.
``taps={(i,ch)}``   an explicit set — the interactive fast path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.graph.ir import Graph, GraphError, effective_params
from interactive_vit_tpu.graph.registry import Registry, registry

logger = logging.getLogger(__name__)

TapSpec = Union[str, Iterable[Tuple[int, str]]]


def mesh_out_spec(shape, mesh, batched: bool):
    """PartitionSpec for a mesh-mode entry output.

    Stacked (vmapped) programs emit a leading bucket dim that the executor
    rounds to a multiple of the data axis — shard it over "data", matching
    the input placement (``Executor._place_inputs``). Everything else
    replicates: taps go straight to the host wire codec.
    """
    from jax.sharding import PartitionSpec as P

    nd_data = mesh.shape.get("data", 1)
    if batched and len(shape) >= 1 and shape[0] and shape[0] % nd_data == 0:
        return P("data")
    return P()


def _jit(fn, *example_args, mesh=None, batched=False):
    """jit; in mesh mode every output gets a NamedSharding (data-sharded
    batch dim for stacked programs, replicated taps otherwise)."""
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding

    shapes = jax.eval_shape(fn, *example_args)
    sh = jax.tree.map(
        lambda s: NamedSharding(mesh, mesh_out_spec(s.shape, mesh, batched)),
        shapes)
    return jax.jit(fn, out_shardings=sh)


class NodeError(Exception):
    """An error attributed to one graph node (TargettedError contract)."""

    def __init__(self, node_index: int, node_name: str, message: str):
        super().__init__(f"node {node_index} ({node_name}): {message}")
        self.node_index = node_index
        self.node_name = node_name
        self.message = message


def shape_struct(t, lead=()) -> "jax.ShapeDtypeStruct":
    """ShapeDtypeStruct mirroring ``t`` (optionally with leading dims).

    THE single copy of the tensor->struct rule: the speculative warmer's
    shape-only graph clones must signature- and lower-match the real
    requests, so the construction cannot be allowed to drift between
    ``Executor.precompile`` and ``serving/speculate``."""
    dt = t.dtype if hasattr(t, "dtype") else np.asarray(t).dtype
    return jax.ShapeDtypeStruct(tuple(lead) + tuple(np.shape(t)), dt)


def _tap_key(taps: TapSpec) -> str:
    if isinstance(taps, str):
        return taps
    return "|".join(f"{i}:{ch}" for i, ch in sorted(taps))


def resolve_taps(
    graph: Graph, taps: TapSpec, reg: Optional[Registry] = None
) -> Set[Tuple[int, str]]:
    """Expand a tap spec into a concrete set of (node_index, channel)."""
    if taps == "all":
        out: Set[Tuple[int, str]] = set()
        reg = reg or registry()
        for n in graph.nodes:
            kind = reg.get_node(n.name)
            for ch in kind.io(n.params)["outs"]:
                out.add((n.index, ch))
        return out
    if taps == "primary":
        # all outputs minus UNCONSUMED extras: reference's return-everything
        # contract at reference cost (its nodes only had primary channels);
        # expensive optional taps (attention maps) ship only when wired or
        # explicitly requested
        reg = reg or registry()
        out = set()
        consumed: Set[Tuple[int, str]] = set()
        for n in graph.nodes:
            for e in n.inputs.values():
                if e.src is not None:
                    consumed.add((e.src.node.index, e.src.channel))
        for n in graph.nodes:
            kind = reg.get_node(n.name)
            extras = set(kind.extra_outs(n.params))
            for ch in kind.io(n.params)["outs"]:
                if ch not in extras or (n.index, ch) in consumed:
                    out.add((n.index, ch))
        return out
    if taps == "sinks":
        consumed = set()
        for n in graph.nodes:
            for e in n.inputs.values():
                if e.src is not None:
                    consumed.add((e.src.node.index, e.src.channel))
        return resolve_taps(graph, "all", reg) - consumed
    # explicit tap set: validate every (node, channel) now — _stage's
    # output filter would otherwise silently DROP unknown keys and the
    # client would get a partial response with HTTP 200 and no diagnostic
    # (the per-node attribution contract requires a structured error)
    out = set(taps)  # type: ignore[arg-type]
    reg = reg or registry()
    for i, ch in out:
        if not isinstance(i, int) or i < 0 or i >= len(graph.nodes):
            raise GraphError(f"tap references nonexistent node {i}")
        n = graph.nodes[i]
        kind = reg.get_node(n.name)
        if ch not in kind.io(n.params)["outs"]:
            raise NodeError(
                i, n.name,
                f"tap channel {ch!r} is not an output of this node "
                f"(outs: {kind.io(n.params)['outs']})",
            )
    return out


class GradSpec:
    """One gradient node's resolved differentiation plan.

    ``wrt_key``  env key of the leaf: ``("in", node, ch)`` for a graph
                 input, ``(node, ch)`` for an intermediate activation
                 (Grad-CAM-style wrt).
    ``src_key``  env key of the tensor the scalar target reduces.
    ``anc``      the src's full ancestor cone, topo order (the eager
                 debug paths evaluate it to build the base env; PP
                 folding must leave all of it unfolded).
    ``replay``   the subset of ``anc`` that transitively DEPENDS on the
                 wrt leaf, topo order — the nodes re-traced inside
                 jax.grad; everything else reads its already-computed
                 value.
    """

    __slots__ = ("wrt_key", "src_key", "anc", "replay")

    def __init__(self, wrt_key, src_key, anc, replay):
        self.wrt_key = wrt_key
        self.src_key = src_key
        self.anc = anc
        self.replay = replay


def _grad_specs(graph: Graph, order, input_edges, node_kinds,
                only: Optional[int] = None) -> Dict[int, GradSpec]:
    """Resolve every gradient node's ``GradSpec``.

    Gradient node kinds (``NodeKind.grad_node``, e.g. saliency) need part
    of the graph replayed as a CLOSED function of one leaf tensor so
    ``jax.grad`` can differentiate through it. The leaf is either a graph
    input (``grad_wrt`` -> ("input", k)) or any upstream node's output
    (("node", idx, ch) — the Grad-CAM case). Shared by ``_stage`` and the
    eager debug paths so the wiring validation (and its NodeError text)
    cannot drift between them.

    ``only``: resolve just that node's spec — the eager debug paths use
    it so one misconfigured gradient node fails with ITS OWN attribution
    instead of poisoning every other gradient node's evaluation
    (per-node fault isolation is the debug paths' contract)."""
    specs: Dict[int, GradSpec] = {}
    for n in graph.nodes:
        kind = node_kinds[n.index]
        if not getattr(kind, "grad_node", False):
            continue
        if only is not None and n.index != only:
            continue
        try:
            wspec = kind.grad_wrt(n.params)
        except Exception as err:  # noqa: BLE001 — attribution contract
            raise NodeError(n.index, n.name, str(err)) from err
        if wspec[0] == "input":
            k = wspec[1]
            if k < 0 or k >= len(input_edges):
                raise NodeError(
                    n.index, n.name,
                    f"wrt={k} but the graph has {len(input_edges)} "
                    f"input(s)")
            wnode, wch, _we = input_edges[k]
            wrt_key: Tuple[Any, ...] = ("in", wnode.index, wch)
            wrt_label = f"graph input {k}"
        else:
            _kind, widx, wch = wspec
            if widx < 0 or widx >= len(graph.nodes):
                raise NodeError(
                    n.index, n.name, f"wrt node {widx} does not exist")
            wk = node_kinds[graph.nodes[widx].index]
            if wch not in wk.io(graph.nodes[widx].params)["outs"]:
                raise NodeError(
                    n.index, n.name,
                    f"wrt node {widx} has no output channel {wch!r}")
            wrt_key = (widx, wch)
            wrt_label = f"node {widx} channel {wch!r}"
        e = n.inputs["o"]  # validate() enforced presence
        if e.src is None:
            src_key: Tuple[Any, ...] = ("in", n.index, "o")
            anc: List[Any] = []
        else:
            src_key = (e.src.node.index, e.src.channel)
            anc_set: Set[int] = set()
            stack = [e.src.node]
            while stack:
                m = stack.pop()
                if m.index in anc_set:
                    continue
                anc_set.add(m.index)
                for _ch2, e2 in m.inputs.items():
                    if e2.src is not None:
                        stack.append(e2.src.node)
            anc = [m for m in order if m.index in anc_set]
        # dependence-filtered replay: a node depends on the leaf if any
        # input edge reads the leaf key, or reads ANY output of an
        # already-dependent node (dependence is node-granular: recomputing
        # a node refreshes all its channels)
        dep: Set[int] = set()

        def reads_leaf(m) -> bool:
            for _ch2, e2 in m.inputs.items():
                if e2.src is None:
                    if ("in", m.index, _ch2) == wrt_key:
                        return True
                else:
                    sk = (e2.src.node.index, e2.src.channel)
                    if sk == wrt_key or e2.src.node.index in dep:
                        return True
            return False

        replay = []
        for m in anc:
            if m.index == wrt_key[0] and wrt_key[0] != "in":
                continue  # the leaf's producer is never recomputed
            if reads_leaf(m):
                dep.add(m.index)
                replay.append(m)
        reaches = (src_key == wrt_key
                   or (src_key[0] != "in" and src_key[0] in dep))
        if not reaches:
            raise NodeError(
                n.index, n.name,
                f"the wired tensor does not depend on {wrt_label} — "
                f"its gradient would be identically zero")
        specs[n.index] = GradSpec(wrt_key, src_key, anc, replay)
    return specs


class ExecStats:
    """Per-run timing (decode/compile/execute split is a BASELINE metric)."""

    def __init__(self) -> None:
        self.stage_s: float = 0.0
        self.compile_s: float = 0.0
        self.execute_s: float = 0.0
        self.cache_hit: bool = False

    def as_dict(self) -> Dict[str, float]:
        return {
            "stage_s": self.stage_s,
            "compile_s": self.compile_s,
            "execute_s": self.execute_s,
            "cache_hit": self.cache_hit,
        }


class Executor:
    """Stages, compiles (with caching), and runs graphs."""

    # LRU bound on compiled programs: long-running interactive serving sees
    # unbounded distinct (graph, shapes, taps) signatures; each compiled
    # program pins device executables + host memory.
    MAX_CACHE_ENTRIES = 64

    def __init__(self, reg: Optional[Registry] = None, use_jit: bool = True,
                 max_cache_entries: Optional[int] = None, mesh=None):
        from collections import OrderedDict

        self.reg = reg or registry()
        self.use_jit = use_jit
        self.max_cache_entries = max_cache_entries or self.MAX_CACHE_ENTRIES
        # Multi-device serving: a jax.sharding.Mesh with ("data",
        # "model") axes. Captures are TP-sharded per
        # parallel/mesh.param_spec (Megatron split for transformer
        # blocks, replicated otherwise) and run_stacked's micro-batch is
        # sharded over "data"; XLA GSPMD inserts the collectives. Node fns
        # must be GSPMD-partitionable in mesh mode — the servers pass the
        # plain attention path (the shard_map'd ring/Ulysses impls are the
        # long-sequence option).
        self.mesh = mesh
        # signature -> (compiled fn, output keys, captures) — LRU-ordered.
        # Guarded by _cache_lock: the speculative tap warmer (precompile)
        # inserts entries from a background thread while the serving
        # worker reads/inserts on its own thread.
        self._cache: "OrderedDict[str, Tuple[Any, List, Dict]]" = OrderedDict()
        self._cache_lock = threading.Lock()
        # content-addressed device-resident input cache: interactive graph
        # edits re-evaluate with the SAME image, so a repeat request pays
        # no host-to-device transfer. Key = (blake2b(bytes), shape,
        # dtype); LRU by byte budget.
        self._input_cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self._input_cache_bytes = 0
        self.input_cache_budget = 256 * 1024 * 1024
        # (node name, dynamic param values) -> placed captures: cache-hit
        # refresh must not pay a device transfer for UNCHANGED values
        self._dyn_cap_cache: Dict[tuple, Any] = {}
        # (node key, per-row value keys) -> placed STACKED captures: the
        # batcher's steady state re-dispatches groups with identical
        # dynamic values every few ms — rebuilding + re-uploading the
        # stack each time would add a host-to-device transfer per group
        # (don't add per-request transfers)
        self._stacked_dyn_cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self.last_stats = ExecStats()
        # node-index lists of the chains folded into pipeline schedules by
        # the most recent _stage (diagnostics + tests)
        self.last_pp_segments: List[List[int]] = []

    def _device_input(self, t, sharding=None) -> Any:
        """Upload an input tensor once; reuse the device buffer on repeats.

        ``sharding`` participates in the cache key so mesh-placed uploads
        (replicated single-request inputs) are cached too: interactive
        re-evals must never re-upload an unchanged image."""
        import hashlib

        arr = np.ascontiguousarray(np.asarray(t))
        key = (hashlib.blake2b(arr.tobytes(), digest_size=16).digest(),
               arr.shape, str(arr.dtype), repr(sharding))
        hit = self._input_cache.get(key)
        if hit is not None:
            self._input_cache.move_to_end(key)
            return hit
        dev = (jax.device_put(arr) if sharding is None
               else jax.device_put(arr, sharding))
        self._input_cache[key] = dev
        self._input_cache_bytes += arr.nbytes
        while self._input_cache_bytes > self.input_cache_budget:
            _, old = self._input_cache.popitem(last=False)
            self._input_cache_bytes -= old.nbytes
        return dev

    def _place_captures(self, caps_arg: Dict[str, Any]) -> Dict[str, Any]:
        """TP-shard (or replicate) capture pytrees onto the mesh."""
        if self.mesh is None or not caps_arg:
            return caps_arg
        from interactive_vit_tpu.parallel.mesh import param_shardings

        return jax.device_put(
            caps_arg, param_shardings(caps_arg, self.mesh))

    def _place_inputs(self, inputs, batched: bool):
        """Replicate single-request inputs / shard stacked batches on
        "data" across the mesh.

        Single-request (non-batched) placements go through the
        content-addressed input cache, so the same image is not
        uploaded again per request.
        Stacked batches are freshly-stacked arrays (different bytes per
        group), so caching them would only churn the LRU."""
        if self.mesh is None:
            return inputs
        from jax.sharding import NamedSharding, PartitionSpec as P

        nbatch = self.mesh.shape["data"]

        def put(x):
            # Host numpy goes STRAIGHT to _device_input: a jnp.asarray
            # here would device_put to the default device only for
            # _device_input's np.asarray to pull it back to host to hash
            # — an upload + download per request even on cache hits.
            if batched and np.shape(x)[0] % nbatch == 0:
                return jax.device_put(
                    jnp.asarray(x), NamedSharding(self.mesh, P("data")))
            return self._device_input(x, NamedSharding(self.mesh, P()))

        return tuple(put(x) for x in inputs)

    def _cache_get(self, sig: str):
        with self._cache_lock:
            hit = self._cache.get(sig)
            if hit is not None:
                self._cache.move_to_end(sig)
            return hit

    def _stacked_bucket(self, k: int) -> int:
        """Power-of-two batch bucket, rounded up to the mesh "data" axis
        size (sub-meshes like data=3 or 6 are legal, so power-of-two alone
        does not guarantee divisibility)."""
        bucket = 1 << (k - 1).bit_length()
        if self.mesh is not None:
            nd = self.mesh.shape["data"]
            bucket = -(-bucket // nd) * nd
        return bucket

    def _sig_param_filter(self, n):
        """Drop each kind's dynamic params from the signature: their
        values ride as runtime captures (NodeKind.dynamic_params), so an
        interactive edit re-keys the cached program, no recompile.

        A kind whose dynamic params also determine capture SHAPES in a
        coarser way contributes its shape-class instead
        (NodeKind.dynamic_sig — e.g. the prompt node keys on prompt
        COUNT while the wording stays dynamic)."""
        try:
            kind = self.reg.get_node(n.name)
        except KeyError:
            return n.params
        dyn = kind.dynamic_params()
        if not dyn:
            return n.params
        filtered = {k: v for k, v in n.params.items() if k not in dyn}
        try:
            dsig = kind.dynamic_sig(n.params)
        except Exception as err:  # noqa: BLE001 — attribution contract:
            # a malformed dynamic param (e.g. prompts that don't parse)
            # must name its node even though the signature is computed
            # before staging
            raise NodeError(n.index, n.name, str(err)) from err
        if dsig is not None:
            filtered["__dyn_sig__"] = dsig
        return filtered

    def _program_sig(self, graph: Graph, tap_set,
                     batch: Optional[int] = None) -> str:
        """THE cache signature — single source for run / run_stacked /
        is_compiled (a drift between them silently breaks the batcher's
        pipelining heuristic: always-False wastes the depth-1 overlap,
        wrongly-True stalls finished results behind cold compiles)."""
        extra = [_tap_key(tap_set), self.use_jit]
        # ANY stacked program (k=1 included) gets the marker: run() and
        # run_stacked([g]) compile incompatible programs (unbatched vs
        # vmapped [1,...]) and must never share a cache entry
        if batch is not None:
            extra += ["stacked", self._stacked_bucket(batch)]
        return graph.signature(extra=extra,
                               param_filter=self._sig_param_filter)

    def _refresh_dynamic_caps(self, graph: Graph, caps_arg):
        """Cache-hit path: rebuild captures for nodes with dynamic params
        so edited values reach the cached program (the signature excluded
        them on purpose). Returns caps_arg, copied only when needed."""
        changed = {}
        for n in graph.nodes:
            try:
                kind = self.reg.get_node(n.name)
            except KeyError:
                continue
            dyn = kind.dynamic_params()
            if not dyn:
                continue
            if str(n.index) not in caps_arg:
                # PP folding popped this node's captures into a __pp stack
                # (executor folding never folds dynamic kinds, but a plugin
                # kind could declare both) — re-inserting the key would
                # corrupt the AOT executable's argument structure
                continue
            key = self._dyn_value_key(n, dyn)
            hit = self._dyn_cap_cache.get(key)
            if hit is None:
                try:
                    hit = kind.captures(n.params)
                except Exception as err:  # noqa: BLE001 — attribution
                    raise NodeError(n.index, n.name, str(err)) from err
                if self.mesh is not None:
                    # place ONCE per distinct value, memoized: a blocking
                    # device_put per cache-hit request would add a host
                    # round trip to the hot path
                    hit = self._place_captures({"x": hit})["x"]
                self._dyn_cap_cache[key] = hit
                while len(self._dyn_cap_cache) > 256:
                    self._dyn_cap_cache.pop(
                        next(iter(self._dyn_cap_cache)))
            changed[str(n.index)] = hit
        if not changed:
            return caps_arg
        fresh = dict(caps_arg)
        fresh.update(changed)
        return fresh

    def group_sig(self, graph: Graph, extra=()) -> str:
        """Batching signature: dynamic params EXCLUDED (their values stack
        as per-request captures in ``run_stacked``), so concurrent requests
        differing only in a dynamic edit (conv matrix, noise seed, cos A/b)
        share one vmapped batch (SURVEY §7 "micro-batching heterogeneous
        graphs")."""
        return graph.signature(extra=list(extra),
                               param_filter=self._sig_param_filter)

    @staticmethod
    def _dyn_value_key(n, dyn) -> tuple:
        """Content key for one node's dynamic-param VALUES — the single
        definition both the single-run refresh cache and the stacked
        capture cache share (drift between them silently re-uploads on
        every hit)."""
        return (n.name, tuple(sorted((k, n.params.get(k)) for k in dyn)))

    def _dyn_cap_keys(self, graph: Graph, caps_arg) -> frozenset:
        """caps_arg keys owned by dynamic-param node kinds (the keys whose
        values vary per request inside a stacked batch)."""
        keys = set()
        for n in graph.nodes:
            try:
                kind = self.reg.get_node(n.name)
            except KeyError:
                continue
            if kind.dynamic_params() and str(n.index) in caps_arg:
                keys.add(str(n.index))
        return frozenset(keys)

    def _stacked_dyn_caps(self, graphs, bucket: int, dyn_keys,
                          base_caps=None):
        """Per-request dynamic captures stacked on a leading batch axis.

        Bucket padding replicates request 0 (matching the padded inputs).
        Dynamic captures are contract-bound to a stable structure/shape/
        dtype (registry.NodeKind.dynamic_params), so stacking across a
        same-program-signature group is always well-formed.

        Kinds that name dynamic_capture_keys() stack ONLY those entries;
        their static entries (big weights) come from ``base_caps`` (the
        staged program's device-resident captures) and broadcast in the
        vmap instead of stacking k copies."""
        idxs = list(range(len(graphs))) + [0] * (bucket - len(graphs))
        # POSITIONAL node lookup: group membership only guarantees equal
        # program signatures, and node INDICES of edge-less nodes don't
        # participate in the signature — g0's caps key maps to a list
        # position, and every graph's same-position node is the row
        g0_pos = {str(n.index): i for i, n in enumerate(graphs[0].nodes)}
        out = {}
        for key in sorted(dyn_keys):
            pos = g0_pos[key]
            rows = [graphs[gi].nodes[pos] for gi in idxs]
            kind = self.reg.get_node(rows[0].name)
            dyn = kind.dynamic_params()
            dck = kind.dynamic_capture_keys()
            # content-addressed: the batcher's steady state re-dispatches
            # identical value stacks every few ms — a cache hit must cost
            # zero host work and zero device transfers
            cache_key = (key, tuple(
                self._dyn_value_key(n, dyn) for n in rows
            ))
            hit = self._stacked_dyn_cache.get(cache_key)
            if hit is None:
                per = []
                for n in rows:
                    try:
                        caps = self.reg.get_node(n.name).captures(n.params)
                    except Exception as err:  # noqa: BLE001 — attribution
                        raise NodeError(n.index, n.name, str(err)) from err
                    if dck is not None:
                        caps = {k: v for k, v in caps.items() if k in dck}
                    per.append(caps)
                hit = jax.tree.map(
                    lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                    *per)
                if self.mesh is not None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    # replicated: tiny per-request values consumed in vmap
                    hit = jax.device_put(
                        hit, NamedSharding(self.mesh, P()))
                self._stacked_dyn_cache[cache_key] = hit
                while len(self._stacked_dyn_cache) > 128:
                    self._stacked_dyn_cache.popitem(last=False)
            else:
                self._stacked_dyn_cache.move_to_end(cache_key)
            if dck is not None:
                # merge: static entries stay the staged program's
                # device-resident buffers (broadcast), dynamic ones stack
                out[key] = {**(base_caps or {}).get(key, {}), **hit}
            else:
                out[key] = hit
        return out

    def _stacked_caps_axes(self, g0, caps_arg, dyn_keys):
        """vmap in_axes pytree for the stacked captures: 0 for stacked
        per-request values, None for broadcast weights; a mixed capture
        dict (NodeKind.dynamic_capture_keys) gets per-entry axes."""
        by_key = {str(n.index): n for n in g0.nodes}
        axes = {}
        for k in caps_arg:
            if k not in dyn_keys:
                axes[k] = None
                continue
            dck = self.reg.get_node(by_key[k].name).dynamic_capture_keys()
            if dck is None:
                axes[k] = 0
            else:
                axes[k] = {sub: (0 if sub in dck else None)
                           for sub in caps_arg[k]}
        return axes

    def is_compiled(self, graph: Graph, taps: TapSpec,
                    batch: Optional[int] = None) -> bool:
        """True if (graph, taps, batch-bucket) has a cached program — the
        batcher asks before pipelining a dispatch behind finished results
        (a cold compile would stall them for seconds)."""
        tap_set = resolve_taps(graph, taps, self.reg)
        with self._cache_lock:
            return self._program_sig(graph, tap_set, batch) in self._cache

    def precompile(self, graph: Graph, taps: TapSpec = "primary",
                   batch: Optional[int] = None) -> bool:
        """Compile ``(graph, taps)`` into the program cache WITHOUT executing.

        The speculative tap warmer's entry point (serving/speculate.py):
        inputs are lowered as ``jax.ShapeDtypeStruct``s, so no device
        transfer and no device execution happens — only staging + AOT
        compilation. Safe to call from a background thread concurrently
        with ``run()``: the program cache is lock-guarded, jit compilation
        is thread-safe, and no device arrays are produced (the backend's
        cross-thread transfer hazard — CLAUDE.md trap #5 — never arises).

        ``batch`` > 1 precompiles the VMAPPED bucket program
        ``run_stacked`` would build for a ``batch``-request group (bucket
        rounding included), so a burst of concurrent same-signature
        sessions doesn't cold-compile mid-traffic. Dynamic-capture slots
        are stored as ShapeDtypeStructs — safe because ``run_stacked``'s
        cache-hit path rebuilds ALL dynamic capture rows for the actual
        group before calling the program.

        Mesh mode is refused: capture placement does ``device_put``s,
        which must stay on the serving worker thread on this backend.

        Returns True if a new program was compiled, False if it was
        already cached (or jit/mesh mode makes precompilation moot).
        """
        if not self.use_jit or self.mesh is not None:
            return False
        self.validate(graph)
        tap_set = resolve_taps(graph, taps, self.reg)
        sig = self._program_sig(graph, tap_set, batch=batch)
        with self._cache_lock:
            if sig in self._cache:
                return False
        staged, out_keys, caps_arg = self._stage(graph, tap_set)
        spec = shape_struct
        inputs = tuple(spec(e.tensor) for _, _, e in graph.input_edges())
        if batch is None or batch <= 1:
            fn = _jit(staged, inputs, caps_arg, mesh=None, batched=False)
            fn = fn.lower(inputs, caps_arg).compile()
        else:
            bucket = self._stacked_bucket(batch)
            dyn_keys = self._dyn_cap_keys(graph, caps_arg)
            caps_arg = dict(caps_arg)
            for dk in dyn_keys:
                caps_arg[dk] = jax.tree.map(
                    lambda x: spec(x, lead=(bucket,)), caps_arg[dk])
            caps_axes = {k: (0 if k in dyn_keys else None)
                         for k in caps_arg}
            stacked = tuple(spec(s, lead=(bucket,)) for s in inputs)
            vmapped = jax.vmap(staged, in_axes=(0, caps_axes), out_axes=0)
            fn = _jit(vmapped, stacked, caps_arg, mesh=None, batched=True)
            fn = fn.lower(stacked, caps_arg).compile()
        self._cache_put(sig, (fn, out_keys, caps_arg))
        return True

    def _cache_put(self, sig: str, entry) -> None:
        with self._cache_lock:
            self._cache[sig] = entry
            self._cache.move_to_end(sig)
            while len(self._cache) > self.max_cache_entries:
                self._cache.popitem(last=False)

    # -- validation -----------------------------------------------------------
    def validate(self, graph: Graph) -> None:
        """Pre-stage structural validation with per-node error attribution."""
        graph.order()  # raises GraphError on cycles
        for n in graph.nodes:
            try:
                kind = self.reg.get_node(n.name)
            except KeyError as e:
                raise NodeError(n.index, n.name, str(e)) from e
            io = kind.io(n.params)
            for ch in n.inputs:
                if ch not in io["ins"]:
                    raise NodeError(
                        n.index, n.name, f"unknown input channel {ch!r}"
                    )
            for ch, edges in n.outputs.items():
                if any(e.dst is not None for e in edges) and ch not in io["outs"]:
                    raise NodeError(
                        n.index, n.name, f"unknown output channel {ch!r}"
                    )
            # optional_inputs: True = all optional, or a set of channel
            # names (only those may be unwired)
            optional = getattr(kind, "optional_inputs", False)
            if optional is not True:
                skip = optional if isinstance(optional, (set, frozenset)) \
                    else frozenset()
                for ch in io["ins"]:
                    if ch not in n.inputs and ch not in skip:
                        raise NodeError(n.index, n.name, f"missing input {ch!r}")

    # -- pipeline folding ---------------------------------------------------------
    def _pp_stages(self) -> int:
        """Pipeline-parallel stage count (mesh "stage" axis; 0 = off)."""
        if self.mesh is not None and "stage" in self.mesh.axis_names:
            s = self.mesh.shape["stage"]
            return s if s > 1 else 0
        return 0

    def _find_pp_segments(
        self, order, graph: Graph, node_kinds, tap_set, captures,
        protected=frozenset(),
    ) -> List[List[Any]]:
        """Maximal foldable chains of same-fold-group layer nodes.

        A chain n_0 -> ... -> n_k folds into one GPipe schedule
        (``parallel/pipeline.py``) iff every node shares a ``fold_group``,
        each interior link is exactly one o->o edge with fan-out 1, no
        node is tapped on an EXTRA channel or has a wired extra, and every
        node has captures. Interior PRIMARY ("o") taps are fine: the pipe
        emits the tapped layers' activations alongside the chain output
        (``pipeline_apply_stacked(tap_layers=...)``) — tapping a mid-chain
        block no longer disengages the fold (VERDICT r2 weak #7). Chains
        are trimmed to the largest multiple of the stage count; the
        remainder runs sequentially (correctness is unchanged either way —
        folding is purely an execution strategy).
        """
        n_stages = self._pp_stages()
        # a tap on an extra channel (attention maps etc.) requires the
        # node's own fn with wants — such a node can't fold at all, while a
        # node tapped only on "o" may still END a segment (the pipe emits
        # the last node's "o")
        extra_tapped = {i for i, ch in tap_set if ch != "o"}
        segments: List[List[Any]] = []
        in_segment: Set[int] = set()

        def foldable(n) -> bool:
            kind = node_kinds[n.index]
            # an extra-channel OUTPUT edge (r/attn/cls wired into a consumer)
            # disqualifies the node even as a chain TAIL: the fold emits only
            # the last node's "o", so a consumed extra channel would be
            # missing from env (raw KeyError, unattributed). Mirrors how
            # effective_params treats wired extras as wants.
            extra_consumed = any(
                e.dst is not None
                for ch, es in n.outputs.items() if ch != "o"
                for e in es
            )
            return (
                getattr(kind, "fold_group", None) is not None
                # a gradient node's ancestor cone replays node-by-node
                # inside jax.grad — folding would pop its per-node captures
                # into a __pp stack the replay can't see
                and n.index not in protected
                and captures.get(n.index) is not None
                # dynamic-param kinds can't fold: the stacked __pp capture
                # is never refreshed on cache hits, so edits would be
                # silently dropped
                and not kind.dynamic_params()
                and set(n.inputs.keys()) <= {"o"}
                and n.index not in extra_tapped
                and not extra_consumed
            )

        def links_to(a, b) -> bool:
            """a's ONLY output consumption is one o->o edge into b."""
            edges = [e for ch, es in a.outputs.items() for e in es
                     if e.dst is not None]
            return (
                len(edges) == 1
                and edges[0].src.channel == "o"
                and edges[0].dst.node.index == b.index
                and edges[0].dst.channel == "o"
            )

        for n in order:
            if n.index in in_segment or not foldable(n):
                continue
            group = node_kinds[n.index].fold_group
            chain = [n]
            cur = n
            while True:
                nxt_edges = [e for ch, es in cur.outputs.items()
                             for e in es if e.dst is not None]
                if len(nxt_edges) != 1:
                    break
                nxt = nxt_edges[0].dst.node
                if (
                    nxt.index in in_segment
                    or not foldable(nxt)
                    or node_kinds[nxt.index].fold_group != group
                    or not links_to(cur, nxt)
                    or set(nxt.inputs.keys()) != {"o"}
                ):
                    break
                chain.append(nxt)
                cur = nxt
            keep = (len(chain) // n_stages) * n_stages
            if keep >= n_stages and keep >= 2:
                seg = chain[:keep]
                segments.append(seg)
                in_segment.update(m.index for m in seg)
        return segments

    # -- staging ----------------------------------------------------------------
    def _stage(
        self, graph: Graph, tap_set: Set[Tuple[int, str]]
    ) -> Tuple[Any, List[Tuple[int, str]], Dict[str, Any]]:
        """Build the traceable closure over the whole graph; returns
        ``(staged_fn, out_keys, captures_arg)``."""
        order = graph.order()
        input_edges = graph.input_edges()
        out_keys = sorted(tap_set)
        reg = self.reg

        # Freeze per-node metadata outside the closure (trace-time safety).
        node_kinds = {n.index: reg.get_node(n.name) for n in graph.nodes}

        grad_specs = _grad_specs(graph, order, input_edges, node_kinds)
        grad_protected: Set[int] = set()  # nodes PP folding must not touch
        # extra channel wants induced by node-wrt gradients: the leaf
        # producer must actually EMIT the wrt channel into env
        grad_wants: Set[Tuple[int, str]] = set()
        for gi, spec in grad_specs.items():
            grad_protected.add(gi)
            grad_protected.update(m.index for m in spec.anc)
            if spec.wrt_key[0] != "in":
                grad_protected.add(spec.wrt_key[0])
                grad_wants.add((spec.wrt_key[0], spec.wrt_key[1]))
        # Captured pytrees (model weights) become jit ARGUMENTS, so they stay
        # device-resident buffers instead of being baked into the HLO.
        captures = {}
        for n in graph.nodes:
            try:
                captures[n.index] = node_kinds[n.index].captures(n.params)
            except Exception as err:  # noqa: BLE001 — attribution contract:
                # a bad param decode (e.g. conv2d h edited while the old
                # matrix is still 3x3) must name its node, not surface raw
                raise NodeError(n.index, n.name, str(err)) from err
        caps_arg = {
            str(i): c for i, c in captures.items() if c is not None
        }
        # Per-node effective params: inject "__taps__" (ir.effective_params).
        # Node kinds with *expensive optional outputs* (e.g. flash attention,
        # where emitting the N x N maps is a materially different kernel)
        # read it to skip work; ordinary kinds ignore it. It participates in
        # the cache signature via the tap-set key.
        eff_params: Dict[int, Dict[str, str]] = {
            n.index: effective_params(n, tap_set | grad_wants)
            for n in graph.nodes
        }

        # Pipeline folding (mesh "stage" axis): untapped chains of uniform
        # layer nodes execute as ONE GPipe schedule; their captures ride
        # stacked on a leading layer dim, stage-sharded by _place_captures.
        segments = (
            self._find_pp_segments(order, graph, node_kinds, tap_set,
                                   captures, protected=grad_protected)
            if self._pp_stages() else []
        )
        seg_start: Dict[int, Tuple[int, List[Any], Any]] = {}
        folded: Set[int] = set()
        for sid, seg in enumerate(segments):
            key = f"__pp{sid}"
            caps_arg[key] = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[captures[m.index] for m in seg],
            )
            for m in seg:
                caps_arg.pop(str(m.index), None)
                folded.add(m.index)
            seg_start[seg[0].index] = (
                sid, seg, node_kinds[seg[0].index].fold_fn()
            )
        self.last_pp_segments = [[m.index for m in seg] for seg in segments]

        def staged(inputs: Tuple[Any, ...], caps: Dict[str, Any]) -> Dict[str, Any]:
            # env: (node_index, channel) -> traced array
            env: Dict[Tuple[int, str], Any] = {}
            for (node, ch, _e), arr in zip(input_edges, inputs):
                env[("in", node.index, ch)] = arr  # type: ignore[index]

            def eval_one(n, env, caps, in_replay=False):
                """Evaluate one (non-PP-folded) node into env.

                Shared by the main topo loop and the gradient replay below
                — a grad node's ancestor cone re-evaluates through this
                same function, so nested grad nodes (saliency of a
                saliency) compose by recursion. ``in_replay``: the node is
                being re-traced inside jax.grad — its math must be
                differentiable, so ``grad_safe_fn`` (the XLA twin for
                kernel-backed layers) replaces ``fn``."""
                kind = node_kinds[n.index]
                if n.index in grad_specs:
                    spec = grad_specs[n.index]

                    # forward-only grad kinds (occlusion) never
                    # differentiate the replay, so kernel-backed fns stay
                    # in place — no grad twin needed. Unless THIS node is
                    # itself inside an outer differentiated replay: then
                    # its forwards are traced under the outer jax.grad
                    # and must stay differentiable.
                    replay_diff = (getattr(kind, "differentiates", True)
                                   or in_replay)

                    def forward(xv, _spec=spec, _diff=replay_diff):
                        # snapshot everything computed so far; replace the
                        # leaf with the tracer; re-trace only the nodes
                        # that depend on it (topo order guarantees each
                        # replayed value is refreshed before it is read)
                        env2 = dict(env)
                        env2[_spec.wrt_key] = xv
                        if _spec.src_key == _spec.wrt_key:
                            return xv
                        for m in _spec.replay:
                            eval_one(m, env2, caps, in_replay=_diff)
                        return env2[_spec.src_key]

                    try:
                        with jax.named_scope(
                            f"n{n.index}_{n.name.replace(':', '.')}"
                        ):
                            outs = kind.grad_fn(eff_params[n.index])(
                                forward, env[spec.wrt_key],
                                caps.get(str(n.index)))
                    except NodeError:
                        raise
                    except Exception as err:  # noqa: BLE001
                        raise NodeError(n.index, n.name, str(err)) from err
                    for ch, v in outs.items():
                        env[(n.index, ch)] = v
                    return
                ins: Dict[str, Any] = {}
                for ch, e in n.inputs.items():
                    if e.src is None:
                        ins[ch] = env[("in", n.index, ch)]  # type: ignore[index]
                    else:
                        ins[ch] = env[(e.src.node.index, e.src.channel)]
                fn_of = (kind.grad_safe_fn if in_replay
                         and hasattr(kind, "grad_safe_fn") else kind.fn)
                try:
                    with jax.named_scope(
                        f"n{n.index}_{n.name.replace(':', '.')}"
                    ):
                        if str(n.index) in caps:
                            outs = fn_of(eff_params[n.index])(
                                ins, caps[str(n.index)])
                        else:
                            outs = fn_of(eff_params[n.index])(ins)
                except NodeError:
                    raise
                except Exception as err:  # noqa: BLE001 — re-attribute
                    raise NodeError(n.index, n.name, str(err)) from err
                for ch, v in outs.items():
                    env[(n.index, ch)] = v

            for n in order:
                if n.index in seg_start:
                    from interactive_vit_tpu.parallel.pipeline import (
                        pipeline_apply_stacked,
                    )

                    sid, seg, layer_fn = seg_start[n.index]
                    e = n.inputs["o"]
                    x = (env[("in", n.index, "o")] if e.src is None
                         else env[(e.src.node.index, e.src.channel)])
                    # interior "o" taps ride out of the pipe as extra
                    # emissions (tap positions are static per tap-set, and
                    # the tap set keys the compile cache)
                    tap_pos = tuple(
                        k for k, m in enumerate(seg[:-1])
                        if (m.index, "o") in tap_set
                    )
                    try:
                        with jax.named_scope(
                            f"pp{sid}_n{seg[0].index}-{seg[-1].index}"
                        ):
                            y = pipeline_apply_stacked(
                                caps[f"__pp{sid}"], x, layer_fn, self.mesh,
                                n_layers=len(seg), tap_layers=tap_pos,
                            )
                    except NodeError:
                        raise
                    except Exception as err:  # noqa: BLE001
                        raise NodeError(n.index, n.name, str(err)) from err
                    if tap_pos:
                        y, seg_taps = y
                        for k in tap_pos:
                            env[(seg[k].index, "o")] = seg_taps[k]
                    env[(seg[-1].index, "o")] = y
                    continue
                if n.index in folded:
                    continue
                eval_one(n, env, caps)

            return {f"{i}/{ch}": env[(i, ch)] for i, ch in out_keys if (i, ch) in env}

        return staged, out_keys, caps_arg

    # -- the production path ------------------------------------------------------
    def run(
        self, graph: Graph, taps: TapSpec = "all", to_host: bool = True,
        defer: bool = False,
    ):
        """Stage+compile+execute; returns {node_index: {channel: array}}.

        ``to_host=True`` (default) materializes outputs to numpy IN THE
        CALLING THREAD via one batched ``jax.device_get``: the serving
        worker owns the transfer, so a result never crosses threads
        before it is on the host (some PJRT plugins deadlock on
        cross-thread device-to-host copies). Pass ``to_host=False`` for
        device-resident results in single-threaded pipelines (bench loops).
        ``defer=True`` returns the raw in-flight output dict without any
        host sync — the micro-batcher's pipelining hook: dispatch batch
        i+1, then ``split_single(jax.device_get(...))`` batch i so its
        host transfer rides while i+1 computes.
        """
        stats = ExecStats()
        self.validate(graph)
        tap_set = resolve_taps(graph, taps, self.reg)
        sig = self._program_sig(graph, tap_set)

        inputs = tuple(e.tensor for _, _, e in graph.input_edges())
        if self.mesh is None:
            inputs = tuple(self._device_input(t) for t in inputs)
        else:
            inputs = self._place_inputs(inputs, batched=False)

        t0 = time.perf_counter()
        hit = self._cache_get(sig)
        if hit is not None:
            fn, out_keys, caps_arg = hit
            caps_arg = self._refresh_dynamic_caps(graph, caps_arg)
            stats.cache_hit = True
            stats.stage_s = time.perf_counter() - t0
        else:
            staged, out_keys, caps_arg = self._stage(graph, tap_set)
            caps_arg = self._place_captures(caps_arg)
            if self.use_jit:
                fn = _jit(staged, inputs, caps_arg, mesh=self.mesh,
                          batched=False)
                stats.stage_s = time.perf_counter() - t0
                # explicit AOT compile so stats separate compile from execute
                # (the decode/compile/execute split is a BASELINE metric)
                t0 = time.perf_counter()
                fn = fn.lower(inputs, caps_arg).compile()
                stats.compile_s = time.perf_counter() - t0
            else:
                fn = staged
                stats.stage_s = time.perf_counter() - t0
            self._cache_put(sig, (fn, out_keys, caps_arg))

        t0 = time.perf_counter()
        flat = fn(inputs, caps_arg)
        if defer:
            # async handle: computation is in flight; the CALLING thread
            # must finish with ``split_single(jax.device_get(flat))``
            # (cross-thread transfers deadlock on this backend)
            self.last_stats = stats
            return flat
        flat = jax.device_get(flat) if to_host else jax.block_until_ready(flat)
        stats.execute_s = time.perf_counter() - t0

        self.last_stats = stats
        return self.split_single(flat)

    @staticmethod
    def split_single(flat) -> Dict[int, Dict[str, np.ndarray]]:
        """{"i/ch": arr} -> {i: {ch: arr}}."""
        result: Dict[int, Dict[str, np.ndarray]] = {}
        for key, val in flat.items():
            idx_s, ch = key.split("/", 1)
            result.setdefault(int(idx_s), {})[ch] = val
        return result

    @staticmethod
    def split_stacked(flat, k: int) -> List[Dict[int, Dict[str, np.ndarray]]]:
        """Stacked {"i/ch": [bucket, ...]} -> k per-request result dicts."""
        results: List[Dict[int, Dict[str, np.ndarray]]] = []
        for j in range(k):
            res: Dict[int, Dict[str, np.ndarray]] = {}
            for key, val in flat.items():
                idx_s, ch = key.split("/", 1)
                res.setdefault(int(idx_s), {})[ch] = val[j]
            results.append(res)
        return results

    # -- micro-batched path ---------------------------------------------------
    def run_stacked(
        self, graphs: List[Graph], taps: TapSpec = "all",
        to_host: bool = True, defer: bool = False,
    ):
        """Run K structurally-identical graphs as ONE vmapped program.

        The serving micro-batcher's engine (BASELINE config 5): concurrent
        interactive requests that share a PROGRAM signature differ only in
        input values and dynamic-param values (noise seed, conv matrix,
        cos A/b) — inputs stack on axis 0, dynamic captures stack as
        per-request capture rows (vmap ``in_axes`` 0), everything else
        (weights) broadcasts. Batch size is bucketed to powers of two
        (padding by repeating the first request) to bound compile count.
        """
        assert graphs, "empty batch"
        g0 = graphs[0]
        self.validate(g0)
        # PROGRAM signature (dynamic params excluded): graphs differing
        # only in dynamic values (noise seed, conv matrix, cos A/b) batch
        # together — their values stack as per-request captures below
        psig0 = self.group_sig(g0)
        for g in graphs[1:]:
            if self.group_sig(g) != psig0:
                raise ValueError("run_stacked: mixed graph signatures")

        tap_set = resolve_taps(g0, taps, self.reg)
        k = len(graphs)
        bucket = self._stacked_bucket(k)
        sig = self._program_sig(g0, tap_set, batch=k)

        per_graph = [
            tuple(e.tensor for _, _, e in g.input_edges()) for g in graphs
        ]
        if self.mesh is None:
            # upload each distinct input once (content-addressed), stack on
            # device: bucket padding replicates request 0 without re-upload
            per_graph = [
                tuple(self._device_input(t) for t in pg) for pg in per_graph
            ]
        # pad to bucket with copies of request 0
        per_graph = per_graph + [per_graph[0]] * (bucket - k)
        stacked = tuple(
            jnp.stack([pg[i] for pg in per_graph])
            for i in range(len(per_graph[0]))
        )
        stacked = self._place_inputs(stacked, batched=True)

        stats = ExecStats()
        t0 = time.perf_counter()
        hit = self._cache_get(sig)
        if hit is not None:
            fn, out_keys, caps_arg = hit
            # per-request dynamic values: rebuild the stacked captures for
            # THIS group (the cached ones belong to the group that compiled
            # the program)
            dyn_keys = self._dyn_cap_keys(g0, caps_arg)
            if dyn_keys:
                caps_arg = dict(caps_arg)
                caps_arg.update(self._stacked_dyn_caps(
                    graphs, bucket, dyn_keys, base_caps=caps_arg))
            stats.cache_hit = True
        else:
            staged, out_keys, caps_arg = self._stage(g0, tap_set)
            dyn_keys = self._dyn_cap_keys(g0, caps_arg)
            caps_arg = self._place_captures(caps_arg)
            if dyn_keys:
                caps_arg = dict(caps_arg)
                caps_arg.update(self._stacked_dyn_caps(
                    graphs, bucket, dyn_keys, base_caps=caps_arg))
            # dynamic captures carry a leading batch axis (per-request
            # values); everything else (weights) broadcasts — per-ENTRY
            # for kinds that name dynamic_capture_keys (mixed dicts)
            caps_axes = self._stacked_caps_axes(g0, caps_arg, dyn_keys)
            vmapped = jax.vmap(staged, in_axes=(0, caps_axes), out_axes=0)
            if not self.use_jit:
                fn = vmapped
            else:
                fn = _jit(vmapped, stacked, caps_arg, mesh=self.mesh,
                          batched=True)
                stats.stage_s = time.perf_counter() - t0
                # AOT compile: (a) the decode/compile/execute split is a
                # BASELINE metric; (b) the compiled executable drops the
                # staged closure, which otherwise pins the first batch's
                # Graph objects (and their request tensors) in the LRU
                t0 = time.perf_counter()
                fn = fn.lower(stacked, caps_arg).compile()
                stats.compile_s = time.perf_counter() - t0
            self._cache_put(sig, (fn, out_keys, caps_arg))
        stats.stage_s = stats.stage_s or (time.perf_counter() - t0)

        t0 = time.perf_counter()
        flat = fn(stacked, caps_arg)
        if defer:
            self.last_stats = stats
            return flat
        flat = jax.device_get(flat) if to_host else jax.block_until_ready(flat)
        stats.execute_s = time.perf_counter() - t0
        self.last_stats = stats
        return self.split_stacked(flat, k)

    # -- the debug path -----------------------------------------------------------
    def _eager_grad_fn(self, graph: Graph, n):
        """Build one gradient node's standalone evaluation for the eager
        debug paths: ``(gfn, inputs, caps_arg, pre)`` with
        ``gfn(inputs, caps, pre) -> output dict``.

        Uses the same ancestor-cone resolution ``_stage`` does (the shared
        ``_grad_specs``); captures ride as function arguments so the
        jitted variant (``run_timed_eager``) doesn't bake model weights
        into the HLO. ``pre`` carries the ancestor activations the eager
        loop already computed (also a jit argument): only the
        wrt-DEPENDENT replay re-traces, instead of paying the whole
        ancestor forward per gradient node — on an eager/debug path over
        a remote backend that re-run is the dominant cost. ``pre`` is
        None (and the cone re-evaluates from the graph inputs) only if
        the wrt leaf's channel wasn't among the already-computed values
        (an unwired extra channel as the Grad-CAM target)."""
        from interactive_vit_tpu.graph.ir import effective_params

        order = graph.order()
        input_edges = graph.input_edges()
        node_kinds = {m.index: self.reg.get_node(m.name)
                      for m in graph.nodes}
        spec = _grad_specs(graph, order, input_edges, node_kinds,
                           only=n.index)[n.index]
        # node-wrt gradients need the leaf producer to emit the wrt channel
        wants = ({(spec.wrt_key[0], spec.wrt_key[1])}
                 if spec.wrt_key[0] != "in" else set())
        eff = {m.index: effective_params(m, wants)
               for m in list(spec.anc) + [n]}
        caps_arg: Dict[str, Any] = {}
        for m in list(spec.anc) + [n]:
            c = node_kinds[m.index].captures(eff[m.index])
            if c is not None:
                caps_arg[str(m.index)] = c
        inputs = tuple(e.tensor for _, _, e in input_edges)
        # already-computed ancestor activations (the eager loop runs in
        # topo order, so every anc node carries a pinout by now); keys
        # stringified for jit-arg pytree friendliness
        pre: Optional[Dict[str, Any]] = {}
        for m in spec.anc:
            for ch, v in m.get_pinout().as_dict().items():
                pre[f"{m.index}:{ch}"] = v
        if (spec.wrt_key[0] != "in"
                and f"{spec.wrt_key[0]}:{spec.wrt_key[1]}" not in pre):
            pre = None  # wrt channel not computed: full-cone fallback

        def gfn(inputs, caps, pre=None):
            env = {("in", m.index, ch): arr
                   for (m, ch, _e), arr in zip(input_edges, inputs)}
            if pre is not None:
                for key, v in pre.items():
                    idx, ch = key.split(":", 1)
                    env[(int(idx), ch)] = v

            def eval_into(m, env, in_replay=False):
                kind = node_kinds[m.index]
                if getattr(kind, "grad_node", False):
                    # only reachable when a grad node sits INSIDE another's
                    # wrt-dependent replay (pre-seeding covers the plain
                    # upstream case); the staged path composes these by
                    # recursion — keep the debug path simple and explicit
                    raise NodeError(
                        n.index, n.name,
                        f"node {m.index} ({m.name}) is a gradient node "
                        f"inside this node's differentiation cone — "
                        f"nested gradients evaluate on the staged path "
                        f"(/compute), not the eager debug path")
                fn_of = (kind.grad_safe_fn if in_replay
                         and hasattr(kind, "grad_safe_fn") else kind.fn)
                ins = {
                    ch: (env[("in", m.index, ch)] if e.src is None
                         else env[(e.src.node.index, e.src.channel)])
                    for ch, e in m.inputs.items()
                }
                if str(m.index) in caps:
                    out = fn_of(eff[m.index])(ins, caps[str(m.index)])
                else:
                    out = fn_of(eff[m.index])(ins)
                for ch, v in out.items():
                    env[(m.index, ch)] = v

            if pre is None:
                # base pass: the full ancestor cone from the graph inputs
                for m in spec.anc:
                    eval_into(m, env)

            # forward-only grad kinds (occlusion) never differentiate the
            # replay, so kernel-backed fns stay in place — no grad twin
            replay_diff = getattr(node_kinds[n.index], "differentiates",
                                  True)

            def forward(xv):
                env2 = dict(env)
                env2[spec.wrt_key] = xv
                if spec.src_key == spec.wrt_key:
                    return xv
                for m in spec.replay:
                    eval_into(m, env2, in_replay=replay_diff)
                return env2[spec.src_key]

            return node_kinds[n.index].grad_fn(eff[n.index])(
                forward, env[spec.wrt_key], caps.get(str(n.index)))

        return gfn, inputs, caps_arg, pre

    def run_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, Dict[str, np.ndarray]], Dict[int, str]]:
        """Eager per-node evaluation with fault isolation.

        Returns (outputs, errors). A failing node's descendants are skipped
        with an "eval error upstream" marker — the client graph engine's
        semantics (``graph.js:498-514,644-651``).
        """
        outputs: Dict[int, Dict[str, np.ndarray]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()

        for n in graph.order():
            upstream_failed = any(
                e.src is not None and e.src.node.index in failed
                for e in n.inputs.values()
            )
            if upstream_failed:
                failed.add(n.index)
                errors[n.index] = "eval error upstream"
                continue
            try:
                kind = self.reg.get_node(n.name)
                if getattr(kind, "grad_node", False):
                    from interactive_vit_tpu.graph.ir import Pinout

                    gfn, g_in, g_caps, g_pre = self._eager_grad_fn(graph, n)
                    pinout = Pinout(gfn(g_in, g_caps, g_pre))
                else:
                    pinout = kind.compute(effective_params(n), n.get_pinin())
                n.set_pinout(pinout)
                outputs[n.index] = pinout.as_dict()
            except Exception as err:  # noqa: BLE001 — per-node isolation
                failed.add(n.index)
                errors[n.index] = str(err)
        return outputs, errors

    def run_timed_eager(
        self, graph: Graph
    ) -> Tuple[Dict[int, float], Dict[int, Dict[str, List[int]]],
               Dict[int, str]]:
        """Per-node JITTED evaluation with steady-state wall timings.

        The ``/debug_eval`` engine. Lives beside ``run_eager`` so the
        per-node fault-isolation semantics ("eval error upstream"
        propagation, ``__taps__`` injection via ``effective_params``)
        cannot drift between the debug paths. Per-node jit, not op-by-op
        eager: each eager op is a tiny compile + dispatch. Returns
        (timings_ms, output_shapes, errors).
        """
        from interactive_vit_tpu.graph.ir import Pinout

        timings: Dict[int, float] = {}
        shapes: Dict[int, Dict[str, List[int]]] = {}
        errors: Dict[int, str] = {}
        failed: Set[int] = set()

        for n in graph.order():
            if any(e.src is not None and e.src.node.index in failed
                   for e in n.inputs.values()):
                failed.add(n.index)
                errors[n.index] = "eval error upstream"
                continue
            try:
                kind = self.reg.get_node(n.name)
                eff = effective_params(n)
                if getattr(kind, "grad_node", False):
                    # gradient nodes time their MARGINAL program (the
                    # wrt-dependent replay forward + backward + render);
                    # upstream activations arrive precomputed as jit args
                    # (pre), like captures — no constant bloat
                    fn, ins, caps, pre = self._eager_grad_fn(graph, n)
                    jitted = jax.jit(fn)
                    args = (ins, caps, pre)
                else:
                    fn = kind.fn(eff)
                    caps = kind.captures(eff)
                    jitted = jax.jit(fn)
                    ins = n.get_pinin().as_dict()
                    args = (ins,) if caps is None else (ins, caps)
                out = jitted(*args)  # compile + first run
                jax.block_until_ready(out)
                t0 = time.perf_counter()
                out = jitted(*args)  # timed steady-state run
                jax.block_until_ready(out)
                timings[n.index] = (time.perf_counter() - t0) * 1e3
                n.set_pinout(Pinout(out))
                shapes[n.index] = {ch: list(t.shape)
                                   for ch, t in out.items()}
            except Exception as err:  # noqa: BLE001 — per-node isolation
                failed.add(n.index)
                errors[n.index] = str(err)
        return timings, shapes, errors

    def cache_info(self) -> Dict[str, int]:
        with self._cache_lock:
            return {"entries": len(self._cache)}

    def clear_cache(self) -> None:
        # under the lock: a concurrent _cache_get between .get and
        # .move_to_end would otherwise see the dict cleared under it
        with self._cache_lock:
            self._cache.clear()
