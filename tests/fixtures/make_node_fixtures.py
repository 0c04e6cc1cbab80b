"""Per-node-kind cross-language contract fixtures (VERDICT r2 #1).

No JS runtime exists in this image, so the frontend cannot be executed.
These fixtures pin, for EVERY client node kind, the full contract tuple:

    {saved instance JSON, client-built request bytes,
     expected routed outputs, server response bytes (f32 + bf16)}

The request bytes are produced by ``client_request_bytes`` below — a
line-by-line Python transcription of the client's request builder
(``frontend/js/graph.js:314-384`` evaluate() + the per-kind ``wireSpec``
methods in ``frontend/js/nodes.js``), emitting byte-identical output to
``frontend/js/wire.js:20-44`` (compact JSON.stringify separators). The
Python replay (``tests/test_node_contracts.py``) asserts the server stack
accepts + evaluates them; ``frontend/js/wire.test.mjs`` replays the same
fixtures from the JS side whenever a JS runtime appears.

Regenerate: ``python tests/fixtures/make_node_fixtures.py`` (CPU backend).
"""

import base64
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # repo root

from interactive_vit_tpu.wire.codec import (  # noqa: E402
    REQUEST_MAGIC, Response, encode_message,
)

# client-side role tables (frontend/js/nodes.js: isSource/isViewer)
SOURCES = {"img_src"}
VIEWERS = {"img_view", "multi_view", "category", "attn_view", "overlay"}


def _js(v):
    """JS ``JSON.stringify`` of a param value (compact separators)."""
    return v if isinstance(v, str) else json.dumps(v, separators=(",", ":"))


def wire_spec(inst):
    """The client's per-kind ``wireSpec()``: instance -> {endpoint, params}.

    Mirrors frontend/js/nodes.js (cos:505, binop:539, slice:598,
    shuffle:640, const:672, noise:709, conv2d:773, resize:805,
    net_node:986). Numeric fields go through String()/JSON.stringify —
    ``_js`` reproduces that byte-for-byte for ints, short floats, lists
    and {dim,val}/{in_dim,out_dim} objects."""
    kind = inst["kind"]
    if kind == "net_node":
        return {"endpoint": inst["endpoint"],
                "params": dict(inst.get("params", {}))}
    params = {k: _js(v) for k, v in inst.items() if k != "kind"}
    return {"endpoint": kind, "params": params}


def client_request_bytes(saved, source_tensors, resp_dtype="f32"):
    """graph.js evaluate() in Python: saved graph -> (request bytes, meta).

    ``source_tensors``: {node_index: np.ndarray} for each img_src.
    Returns (bytes, req_json, tensors) — the exact client wire message
    (compact JSON; tensor dedupe by identity; viewer edges -> taps;
    source edges -> tensor refs), assuming every node is ready."""
    nodes = [n["instance"] for n in saved["nodes"]]
    # reqNodes = non-source, non-viewer (graph.js:318-320)
    req_index = {}
    for i, inst in enumerate(nodes):
        if inst["kind"] not in SOURCES and inst["kind"] not in VIEWERS:
            req_index[i] = len(req_index)
    nodes_json = [wire_spec(nodes[i]) for i in req_index]

    taps = []
    for e in saved["edges"]:
        si, sc = e["in_port"]["node"], e["in_port"]["channel"]
        di = e["out_port"]["node"]
        if nodes[di]["kind"] in VIEWERS and si in req_index:
            taps.append({"node": req_index[si], "channel": sc})

    edges_json = []
    tensors = []
    tensor_index = {}
    for e in saved["edges"]:
        si, sc = e["in_port"]["node"], e["in_port"]["channel"]
        di, dc = e["out_port"]["node"], e["out_port"]["channel"]
        if di not in req_index:
            continue  # viewer inputs come from taps
        if si in req_index:
            edges_json.append({
                "out_port": {"node": req_index[di], "channel": dc},
                "in_port": {"node": req_index[si], "channel": sc},
            })
        elif nodes[si]["kind"] in SOURCES:
            ti = tensor_index.get(si)
            if ti is None:
                ti = len(tensors)
                tensors.append(source_tensors[si])
                tensor_index[si] = ti
            edges_json.append({
                "out_port": {"node": req_index[di], "channel": dc},
                "tensor": ti,
            })

    req_json = {"nodes": nodes_json, "edges": edges_json, "taps": taps}
    if resp_dtype != "f32":
        req_json["resp_dtype"] = resp_dtype
    raw = encode_message(REQUEST_MAGIC, req_json, tensors, compact=True)
    return bytes(raw), req_json, tensors


def _node(kind, pos=(0, 0), **fields):
    inst = {"kind": kind, **fields}
    return {"instance": inst, "pos": {"x": pos[0], "y": pos[1]}}


def _edge(src, sch, dst, dch):
    # reference schema quirk: in_port = SOURCE (wire/schema.py:15-17)
    return {"in_port": {"node": src, "channel": sch},
            "out_port": {"node": dst, "channel": dch}}


def _img(seed, shape=(3, 8, 8)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _conv_b64(mat):
    return base64.b64encode(np.asarray(mat, "<f4").tobytes()).decode()


def scenarios():
    """One contract scenario per client node kind."""
    ident = [0.0] * 4 + [1.0] + [0.0] * 4
    return {
        # compute kinds: img_src -> kind -> img_view
        "cos": {
            "saved": {"nodes": [_node("img_src"),
                                _node("cos", A="2.0", b="0.5"),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(1)},
        },
        "binop": {
            "saved": {"nodes": [_node("img_src"), _node("img_src"),
                                _node("binop", op="*"),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 2, "a"),
                                _edge(1, "o", 2, "b"),
                                _edge(2, "c", 3, "o")]},
            "sources": {0: _img(2), 1: _img(3)},
        },
        "slice": {
            "saved": {"nodes": [_node("img_src"),
                                _node("slice",
                                      fixed=[{"dim": 0, "val": 1}],
                                      free=[{"in_dim": 1, "out_dim": 0},
                                            {"in_dim": 2, "out_dim": 1}]),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(4)},
        },
        "shuffle": {
            "saved": {"nodes": [_node("img_src"),
                                _node("shuffle", fixed=[],
                                      free=[{"in_dim": 2, "out_dim": 0},
                                            {"in_dim": 0, "out_dim": 1},
                                            {"in_dim": 1, "out_dim": 2}]),
                                _node("multi_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(5)},
        },
        "const": {
            "saved": {"nodes": [_node("const", value=2.5, dims=[4, 6]),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o")]},
            "sources": {},
        },
        "noise": {
            "saved": {"nodes": [_node("noise", dims=[2, 5, 5], seed=7),
                                _node("multi_view")],
                      "edges": [_edge(0, "o", 1, "o")]},
            "sources": {},
        },
        "conv2d": {
            "saved": {"nodes": [_node("img_src"),
                                _node("conv2d", matrix=_conv_b64(ident),
                                      w=3, h=3),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(6)},
        },
        "resize": {
            "saved": {"nodes": [_node("img_src"),
                                _node("resize", dims=[4, 4]),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(7)},
        },
        # dense-feature endpoints spawn as NetNodes (app.js:119-127)
        "pca_view": {
            "saved": {"nodes": [_node("img_src"),
                                _node("net_node", endpoint="pca_view",
                                      params={"skip": "1"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(8, (1, 17, 16))},
        },
        "patch_sim": {
            "saved": {"nodes": [_node("img_src"),
                                _node("net_node", endpoint="patch_sim",
                                      params={"row": "1", "col": "2"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(9, (1, 17, 16))},
        },
        # zero-shot similarity join (CLIP image x text embeddings): a
        # server-only kind spawned as a NetNode (app.js tool list)
        "similarity": {
            "saved": {"nodes": [_node("noise", dims=[2, 8], seed=5),
                                _node("noise", dims=[3, 8], seed=6),
                                _node("net_node", endpoint="similarity",
                                      params={"scale": "10"}),
                                _node("category",
                                      cats=["alpha", "beta", "gamma"])],
                      "edges": [_edge(0, "o", 2, "a"),
                                _edge(1, "o", 2, "b"),
                                _edge(2, "o", 3, "o")]},
            "sources": {},
        },
        # input-gradient saliency (server-only: jax.grad through the staged
        # program — a capability the reference's no_grad server lacked);
        # spawned as a NetNode (app.js tool list). grad*input of
        # sum(cos(1.5x+0.25)) wrt the image, rendered as a heatmap
        "saliency": {
            "saved": {"nodes": [_node("img_src"),
                                _node("cos", A="1.5", b="0.25"),
                                _node("net_node", endpoint="saliency",
                                      params={"target": "sum",
                                              "mode": "gradxinput"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o"),
                                _edge(2, "o", 3, "o")]},
            "sources": {0: _img(16, (3, 4, 4))},
        },
        # gradient-ascent feature visualization (server-only, like
        # saliency): optimize the image to maximize sum(cos(1.5x+0.25))
        "dream": {
            "saved": {"nodes": [_node("img_src"),
                                _node("cos", A="1.5", b="0.25"),
                                _node("net_node", endpoint="dream",
                                      params={"target": "sum",
                                              "steps": "8", "lr": "0.2"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o"),
                                _edge(2, "o", 3, "o")]},
            "sources": {0: _img(17, (3, 4, 4))},
        },
        # occlusion sensitivity (server-only, forward-only sliding-mask
        # attribution; spawned as a NetNode like saliency/dream): score
        # drop of sum(cos(1.5x+0.25)) under a 2x2 occluder
        "occlusion": {
            "saved": {"nodes": [_node("img_src"),
                                _node("cos", A="1.5", b="0.25"),
                                _node("net_node", endpoint="occlusion",
                                      params={"target": "sum",
                                              "patch": "2",
                                              "stride": "2"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o"),
                                _edge(2, "o", 3, "o")]},
            "sources": {0: _img(21, (3, 4, 4))},
        },
        # a real model layer endpoint as net_node: cos via the registry
        "net_node": {
            "saved": {"nodes": [_node("img_src"),
                                _node("net_node", endpoint="cos",
                                      params={"A": "1.5", "b": "0.0"}),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(10)},
        },
        # viewer kinds: the contract is their TAP wiring (they never join
        # reqNodes; their input edges become taps on the producing node)
        "img_view_compositing": {
            "saved": {"nodes": [_node("img_src"),
                                _node("slice",
                                      fixed=[{"dim": 0, "val": 0}],
                                      free=[{"in_dim": 1, "out_dim": 0},
                                            {"in_dim": 2, "out_dim": 1}]),
                                _node("slice",
                                      fixed=[{"dim": 0, "val": 1}],
                                      free=[{"in_dim": 1, "out_dim": 0},
                                            {"in_dim": 2, "out_dim": 1}]),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(0, "o", 2, "o"),
                                _edge(1, "o", 3, "R"),
                                _edge(2, "o", 3, "G")]},
            "sources": {0: _img(11)},
        },
        "category": {
            "saved": {"nodes": [_node("img_src"),
                                _node("cos", A="1.0", b="0.0"),
                                _node("category",
                                      cats=["alpha", "beta", "gamma"])],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o")]},
            "sources": {0: _img(12, (3,))},
        },
        "attn_view": {
            "saved": {"nodes": [_node("noise", dims=[1, 2, 4, 4], seed=1),
                                _node("noise", dims=[1, 4, 4], seed=2),
                                _node("attn_view")],
                      "edges": [_edge(0, "o", 2, "attn"),
                                _edge(1, "o", 2, "r")]},
            "sources": {},
        },
        "overlay": {
            "saved": {"nodes": [_node("img_src"),
                                _node("noise", dims=[1, 4, 4], seed=3),
                                _node("overlay")],
                      "edges": [_edge(1, "o", 2, "r")]},
            # img_src -> overlay.o is a source->viewer edge: client-local,
            # never on the wire (graph.js:339) — only the noise tap ships
            "sources": {0: _img(13)},
        },
        # img_src -> img_view alone: nothing to compute, NO request (the
        # client short-circuits, graph.js:373-376); pinned as tap-only
        # scenario with zero req nodes
        "img_src": {
            "saved": {"nodes": [_node("img_src"), _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o")]},
            "sources": {0: _img(14)},
            "no_request": True,
        },
        # multi_view is exercised by shuffle above; pin its direct wiring
        "multi_view": {
            "saved": {"nodes": [_node("noise", dims=[3, 4, 4], seed=4),
                                _node("multi_view")],
                      "edges": [_edge(0, "o", 1, "o")]},
            "sources": {},
        },
        # the error-attribution contract (VERDICT r2 #8): a failing node
        # must produce "node <i> (<name>): ..." naming ITS wire index; the
        # client parses that to pin the full text on the node (hover) and
        # labels only DOWNSTREAM nodes "eval error upstream"
        "error_contract": {
            "saved": {"nodes": [_node("img_src"),
                                _node("conv2d", matrix=_conv_b64(ident),
                                      w=3, h=5),  # 5x3 decl, 3x3 matrix
                                _node("cos", A="1.0", b="0.0"),
                                _node("img_view")],
                      "edges": [_edge(0, "o", 1, "o"),
                                _edge(1, "o", 2, "o"),
                                _edge(2, "o", 3, "o")]},
            "sources": {0: _img(15)},
            "error": True,
        },
    }


def build():
    import jax

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.wire.codec import Request

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg)

    out = {}
    for name, sc in scenarios().items():
        entry = {"saved": sc["saved"]}
        if sc.get("no_request"):
            raw, req_json, tensors = client_request_bytes(
                sc["saved"], sc["sources"])
            assert not req_json["nodes"], name
            entry["no_request"] = True
            out[name] = entry
            continue
        raw, req_json, tensors = client_request_bytes(
            sc["saved"], sc["sources"])
        entry["request_b64"] = base64.b64encode(raw).decode()
        entry["request_json"] = req_json

        if sc.get("error"):
            from interactive_vit_tpu.graph.executor import NodeError

            req = Request()
            req.decode(raw)
            try:
                ex.run(req.graph, taps=req.taps or "primary")
                raise AssertionError(f"{name}: expected NodeError")
            except NodeError as err:
                entry["error"] = {
                    "node_index": err.node_index,
                    "node_name": err.node_name,
                    "text": str(err),
                }
            out[name] = entry
            continue

        req = Request()
        req.decode(raw)
        taps = req.taps if req.taps else "primary"
        outs = ex.run(req.graph, taps=taps)
        outs = {i: {ch: np.asarray(v) for ch, v in sub.items()}
                for i, sub in outs.items()}
        entry["expected"] = {
            f"{i}/{ch}": {"dims": list(v.shape),
                          "values": [round(float(x), 6)
                                     for x in v.ravel().tolist()]}
            for i, sub in sorted(outs.items())
            for ch, v in sorted(sub.items())
        }
        entry["response_b64"] = base64.b64encode(
            bytes(Response(outs).encode())).decode()
        entry["response_bf16_b64"] = base64.b64encode(
            bytes(Response(outs).encode(dtype="bf16"))).decode()
        out[name] = entry
    return out


if __name__ == "__main__":
    # CPU-canonical fixtures (in-process platform override)
    import jax

    jax.config.update("jax_platforms", "cpu")
    fixtures = build()
    with open(os.path.join(HERE, "node_fixtures.json"), "w") as f:
        json.dump(fixtures, f, indent=1)
    sizes = {k: len(v.get("request_b64", "")) for k, v in fixtures.items()}
    print(f"wrote {len(fixtures)} node contract fixtures: "
          f"{sorted(fixtures)}")
