"""Client/server partition-decision fixtures (VERDICT r3 #2).

``node_fixtures.json`` pins per-kind op VALUES; this file pins the
routing DECISION: for each representative graph, {the pure graph
description, the HAND-AUTHORED expected local node set, the expected
ready set, the exact request the server receives (JSON + bytes)}. The
rule lives in ``frontend/js/partition.js`` (pure, shared with the live
``graph.js`` evaluate path) and is mirrored line-for-line by
``interactive_vit_tpu/wire/partition.py``; a behavior change in either
breaks these fixtures. ``tests/test_partition_fixtures.py`` replays them
through the Python mirror in CI; ``frontend/js/wire.test.mjs`` replays
the same file through the REAL JS rule whenever a JS runtime exists.

``expected_local`` / ``expected_req`` below are hand-derived from the
rule's spec (graph.js docstrings; reference behavior
``/root/reference/main/static/main/gpu.js:144-283`` +
``net_node.js:346-369``) — the generator ASSERTS the implementation
reproduces them, so a silent rule regression cannot regenerate green
fixtures.

Regenerate: ``python tests/fixtures/make_partition_fixtures.py``.
"""

import base64
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # repo root
sys.path.insert(0, HERE)

from make_node_fixtures import wire_spec  # noqa: E402
from interactive_vit_tpu.wire import partition as P  # noqa: E402
from interactive_vit_tpu.wire.codec import (  # noqa: E402
    REQUEST_MAGIC, encode_message,
)

# input channels per client kind (frontend/js/nodes.js addInput calls);
# net_node ins come from the server IO description (registry lookup)
CLIENT_INS = {
    "img_src": [], "const": [], "noise": [],
    "img_view": ["R", "G", "B", "o"], "multi_view": ["o"],
    "category": ["o"], "attn_view": ["attn", "r"], "overlay": ["o", "r"],
    "cos": ["o"], "binop": ["a", "b"], "slice": ["o"], "shuffle": ["o"],
    "conv2d": ["o"], "resize": ["o"],
}


def _registry():
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    reg = Registry()
    register_builtin(reg)
    make_vit_model("vit_t16").register(reg)
    return reg


def _img(seed, shape=(3, 8, 8)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def N(kind, **fields):
    return {"kind": kind, **fields}


def E(src, sch, dst, dch):
    return {"src": {"node": src, "channel": sch},
            "dst": {"node": dst, "channel": dch}}


def scenarios():
    """name -> {desc, instances, edges, sources, expected_local,
    expected_req, eval, ...}. Expectations are HAND-AUTHORED."""
    return {
        # the whole graph is viewer-local: zero round trips
        "all_local_slice": {
            "desc": "img_src→slice→img_view: slice evaluates client-side,"
                    " NO server request",
            "instances": [N("img_src"),
                          N("slice", fixed=[{"dim": 0, "val": 1}],
                            free=[{"in_dim": 1, "out_dim": 0},
                                  {"in_dim": 2, "out_dim": 1}]),
                          N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o")],
            "sources": {0: _img(1)},
            "expected_local": [1],
            "expected_req": [],
        },
        "local_chain_conv_resize": {
            "desc": "img_src→conv2d→resize→img_view: whole local chain,"
                    " NO server request",
            "instances": [
                N("img_src"),
                N("conv2d", matrix=base64.b64encode(np.asarray(
                    [0.0] * 4 + [1.0] + [0.0] * 4,
                    "<f4").tobytes()).decode(), w=3, h=3),
                N("resize", dims=[4, 4]),
                N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(2, "o", 3, "o")],
            "sources": {0: _img(2)},
            "expected_local": [1, 2],
            "expected_req": [],
        },
        # independent local + server branches off one source: the local
        # branch stays client-side, the source tensor ships ONCE
        "mixed_local_and_server": {
            "desc": "img_src feeds slice→img_view (local) AND"
                    " pca_view→img_view (server): only pca_view in the"
                    " request",
            "instances": [N("img_src"),
                          N("slice", fixed=[{"dim": 0, "val": 0}],
                            free=[{"in_dim": 1, "out_dim": 0},
                                  {"in_dim": 2, "out_dim": 1}]),
                          N("img_view"),
                          N("net_node", endpoint="pca_view",
                            params={"skip": "1"}),
                          N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(0, "o", 3, "o"), E(3, "o", 4, "o")],
            "sources": {0: _img(3, (1, 17, 16))},
            "expected_local": [1],
            "expected_req": [3],
            "eval": True,
        },
        # a local-CAPABLE op whose consumer is a server node must compute
        # server-side (shipping its output would cost a round trip anyway)
        "local_ancestor_feeds_server": {
            "desc": "img_src→cos→pca_view→img_view: cos is local-capable"
                    " but feeds the server, so BOTH go in the request",
            "instances": [N("img_src"), N("cos", A="2.0", b="0.5"),
                          N("net_node", endpoint="pca_view",
                            params={"skip": "1"}),
                          N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(2, "o", 3, "o")],
            "sources": {0: _img(4, (1, 17, 16))},
            "expected_local": [],
            "expected_req": [1, 2],
            "eval": True,
        },
        # diamond: one branch to a viewer, one to a server node — the
        # shared ancestor stays server-side (no split evaluation)
        "diamond_viewer_and_server": {
            "desc": "conv2d feeds img_view AND a server cos: conv2d"
                    " computes server-side despite the viewer branch",
            "instances": [
                N("img_src"),
                N("conv2d", matrix=base64.b64encode(np.asarray(
                    [0.0] * 4 + [1.0] + [0.0] * 4,
                    "<f4").tobytes()).decode(), w=3, h=3),
                N("img_view"),
                N("net_node", endpoint="cos",
                  params={"A": "1.5", "b": "0.0"}),
                N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(1, "o", 3, "o"), E(3, "o", 4, "o")],
            "sources": {0: _img(5)},
            "expected_local": [],
            "expected_req": [1, 3],
            "eval": True,
        },
        # a half-wired branch is EXCLUDED from the request (per-node
        # isolation: it must not 400 the whole eval) while an independent
        # complete branch still evaluates — here fully locally
        "not_ready_excluded": {
            "desc": "unfed img_src→slice (not ready, excluded) beside"
                    " const→img_view (local): NO server request",
            "instances": [N("img_src"),
                          N("slice", fixed=[{"dim": 0, "val": 0}],
                            free=[{"in_dim": 1, "out_dim": 0},
                                  {"in_dim": 2, "out_dim": 1}]),
                          N("img_view"),
                          N("const", value=2.5, dims=[4, 6]),
                          N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(3, "o", 4, "o")],
            "sources": {},  # img_src holds NO tensor
            "expected_local": [3],
            "expected_req": [],
        },
        # noise is server-side by design (seeded jax.random — the client
        # has no local impl, LOCAL_KINDS excludes it)
        "noise_is_server": {
            "desc": "noise→multi_view: noise has no local impl, goes to"
                    " the server with a tap",
            "instances": [N("noise", dims=[2, 5, 5], seed=7),
                          N("multi_view")],
            "edges": [E(0, "o", 1, "o")],
            "sources": {},
            "expected_local": [],
            "expected_req": [0],
            "eval": True,
        },
        # the local branch's PARTITION is independent of a failing server
        # branch: slice stays local, the bad node errors with wire-index
        # attribution (the "node <i>" contract the client UI parses)
        "local_branch_beside_failing_server": {
            "desc": "img_src→slice→img_view (local) beside a server cos"
                    " with unparseable params (errors, attributed)",
            "instances": [N("img_src"),
                          N("slice", fixed=[{"dim": 0, "val": 1}],
                            free=[{"in_dim": 1, "out_dim": 0},
                                  {"in_dim": 2, "out_dim": 1}]),
                          N("img_view"),
                          N("net_node", endpoint="cos",
                            params={"A": "oops", "b": "0"}),
                          N("img_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "o", 2, "o"),
                      E(0, "o", 3, "o"), E(3, "o", 4, "o")],
            "sources": {0: _img(6)},
            "expected_local": [1],
            "expected_req": [3],
            "eval": True,
            "expect_error_req_node": 0,  # wire index of the cos node
        },
        # localops raises LocalFallback on broadcast binop: the WHOLE
        # pass falls back to the server. Static partition says local;
        # the fallback request (local set cleared) is also pinned — the
        # exact bytes the server receives after the fallback.
        "broadcast_binop_fallback": {
            "desc": "const[4,6] * const[1,6] → binop → img_view:"
                    " statically local, but localops LocalFallback"
                    " (broadcast) sends the whole pass server-side",
            "instances": [N("const", value=2.0, dims=[4, 6]),
                          N("const", value=3.0, dims=[1, 6]),
                          N("binop", op="*"),
                          N("img_view")],
            "edges": [E(0, "o", 2, "a"), E(1, "o", 2, "b"),
                      E(2, "c", 3, "o")],
            "sources": {},
            "expected_local": [0, 1, 2],
            "expected_req": [],
            "fallback": True,
            "fallback_expected_req": [0, 1, 2],
        },
        # the rollout carry "r" is the ONE optional input channel: a
        # block node with "r" unwired is still ready/requestable
        "optional_r_unwired": {
            "desc": "img_src→vit_t16:blocks.0 with 'r' unwired and an"
                    " attn tap: the block is ready, 'r' optionality"
                    " pinned",
            "instances": [N("img_src"),
                          N("net_node", endpoint="vit_t16:blocks.0",
                            params={}),
                          N("attn_view")],
            "edges": [E(0, "o", 1, "o"), E(1, "attn", 2, "attn")],
            "sources": {0: _img(7, (1, 17, 192))},
            "expected_local": [],
            "expected_req": [1],
            # eval=False: block weights are model-init-dependent; the
            # fixture pins partition + bytes only
        },
    }


def describe(instances, edges, sources, reg):
    """Scenario spec -> the pure graph description partition.js and the
    Python mirror consume (graph.js Context.describe())."""
    nodes = []
    for i, inst in enumerate(instances):
        kind = inst["kind"]
        if kind == "net_node":
            ins = reg.get_node(inst["endpoint"]).io(
                inst.get("params", {}))["ins"]
        else:
            ins = CLIENT_INS[kind]
        nodes.append({
            "kind": kind,
            "source": kind in P.SOURCE_KINDS,
            "viewer": kind in P.VIEWER_KINDS,
            "has_tensor": kind in P.SOURCE_KINDS and i in sources,
            "ins": list(ins),
        })
    return nodes, edges


def build_request(instances, plan, sources, resp_dtype="f32"):
    """plan (original indices) -> (request_json, bytes) exactly as
    graph.js evaluate() ships it (compact JSON, wireSpec params)."""
    nodes_json = [wire_spec(instances[i]) for i in plan["req"]]
    req_json = {"nodes": nodes_json, "edges": plan["edges"],
                "taps": plan["taps"]}
    if resp_dtype != "f32":
        req_json["resp_dtype"] = resp_dtype
    tensors = [sources[i] for i in plan["tensors"]]
    raw = encode_message(REQUEST_MAGIC, req_json, tensors, compact=True)
    return req_json, bytes(raw)


def main():
    # CPU-canonical fixtures (in-process platform override)
    import jax

    jax.config.update("jax_platforms", "cpu")
    reg = _registry()
    out = {}
    for name, sc in scenarios().items():
        nodes, edges = describe(sc["instances"], sc["edges"],
                                sc["sources"], reg)
        ready, local, plan = P.partition(nodes, edges)
        assert sorted(local) == sc["expected_local"], (
            name, sorted(local), sc["expected_local"])
        assert plan["req"] == sc["expected_req"], (name, plan)
        entry = {
            "desc": sc["desc"],
            "graph": {"nodes": nodes, "edges": edges},
            "instances": sc["instances"],
            "sources_b64": {
                str(i): {"shape": list(t.shape),
                         "b64": base64.b64encode(
                             np.ascontiguousarray(t, "<f4").tobytes()
                         ).decode()}
                for i, t in sc["sources"].items()},
            "expected_ready": ready,
            "expected_local": sorted(local),
            "plan": plan,
        }
        if plan["req"]:
            req_json, raw = build_request(
                sc["instances"], plan, sc["sources"])
            entry["request_json"] = req_json
            entry["request_b64"] = base64.b64encode(raw).decode()
        else:
            entry["no_request"] = True
        if sc.get("fallback"):
            # the LocalFallback path: graph.js clears the local set and
            # re-plans — pin the exact fallback request bytes
            fplan = P.plan_request(nodes, edges, ready, set())
            assert fplan["req"] == sc["fallback_expected_req"], (
                name, fplan)
            freq_json, fraw = build_request(
                sc["instances"], fplan, sc["sources"])
            entry["fallback_plan"] = fplan
            entry["fallback_request_json"] = freq_json
            entry["fallback_request_b64"] = base64.b64encode(
                fraw).decode()
        if sc.get("eval"):
            entry["eval"] = True
        if "expect_error_req_node" in sc:
            entry["expect_error_req_node"] = sc["expect_error_req_node"]
        out[name] = entry

    path = os.path.join(HERE, "partition_fixtures.json")
    with open(path, "w") as f:
        # insertion order is LOAD-BEARING: the committed request bytes
        # reflect JS JSON.stringify key order ({node, channel} taps,
        # {out_port, in_port|tensor} edges) — sort_keys would break the
        # replay's byte-exact re-encoding
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {len(out)} scenarios")


if __name__ == "__main__":
    main()
