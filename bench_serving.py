"""Serving benchmark (BASELINE config 5): concurrent interactive sessions.

Boots the full serving stack in-process (HTTP server + micro-batcher +
staged executor on the real chip), then drives it with N synthetic clients,
each repeatedly evaluating the auto-generated ViT graph with a fresh random
image over the binary wire protocol — the reference's interactive loop
(SURVEY.md §3.3) under load.

Prints ONE JSON line: p50 per-request latency (the "interactive under load"
metric; BASELINE.md row 4) plus throughput/percentiles on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="vit_t16")
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--duration", type=float, default=30.0)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument(
        "--taps", default="viewer", choices=["viewer", "primary", "features"],
        help="viewer = tap only the classifier output (what an interactive "
             "session renders); primary = reference-style all intermediates; "
             "features = splice pca_view + patch_sim onto the norm output "
             "(the DINO dense-feature session) and tap their rendered maps",
    )
    parser.add_argument(
        "--resp-dtype", default="f32", choices=["f32", "bf16"],
        help="negotiated response block dtype (bf16 halves tap bytes on "
             "the wire; docs/wire_protocol.md extension)",
    )
    parser.add_argument(
        "--distinct-dynamic", action="store_true",
        help="give every client its own patch_sim (row, col) query "
             "(requires --taps features): proves dynamic-param variants "
             "share vmapped batches (mean_batch stays > 1)",
    )
    args = parser.parse_args()
    if args.distinct_dynamic and args.taps != "features":
        parser.error("--distinct-dynamic requires --taps features "
                     "(patch_sim is the dynamic-param node)")

    import numpy as np

    from interactive_vit_tpu.serving.server import build_app
    from interactive_vit_tpu.wire.codec import (
        REQUEST_MAGIC, Response, encode_message,
    )

    import tempfile

    app = build_app(models=(args.model,), graphs_dir=tempfile.mkdtemp(
                        prefix="ivt_bench_graphs_"),
                    max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                    dtype_name=args.dtype)
    httpd = app.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    # the generated model chain as a wire request (what the frontend sends)
    obj = app.graphs.load(args.model + ".json")
    insts = [n["instance"] for n in obj["nodes"]
             if n["instance"]["kind"] == "net_node"]
    nodes_json = [{"endpoint": i["endpoint"], "params": i.get("params", {})}
                  for i in insts]
    edges_json = [{"out_port": {"node": 0, "channel": "o"}, "tensor": 0}]
    for i in range(1, len(nodes_json)):
        edges_json.append({"out_port": {"node": i, "channel": "o"},
                           "in_port": {"node": i - 1, "channel": "o"}})
    graph_json = {"nodes": nodes_json, "edges": edges_json}
    if args.resp_dtype != "f32":
        graph_json["resp_dtype"] = args.resp_dtype
    if args.taps == "viewer":
        # what the frontend sends: only the edge feeding the category viewer
        graph_json["taps"] = [
            {"node": len(nodes_json) - 1, "channel": "o"}
        ]
    elif args.taps == "features":
        # the DINO dense-feature session: PCA + similarity views spliced
        # onto the final-norm tokens, plus the embedding
        norm_i = next(i for i, n in enumerate(nodes_json)
                      if n["endpoint"].endswith(":norm"))
        pca_i, sim_i = len(nodes_json), len(nodes_json) + 1
        nodes_json.append({"endpoint": "pca_view", "params": {"skip": "1"}})
        nodes_json.append({"endpoint": "patch_sim",
                           "params": {"row": "-1", "col": "-1"}})
        edges_json.append({"out_port": {"node": pca_i, "channel": "o"},
                           "in_port": {"node": norm_i, "channel": "o"}})
        edges_json.append({"out_port": {"node": sim_i, "channel": "o"},
                           "in_port": {"node": norm_i, "channel": "o"}})
        graph_json["taps"] = [
            {"node": pca_i, "channel": "o"},
            {"node": sim_i, "channel": "o"},
            {"node": norm_i + 1, "channel": "o"},  # head embedding
        ]

    def make_request(seed: int, cid: int = 0) -> bytes:
        img = np.random.default_rng(seed).random((3, 224, 224),
                                                 dtype=np.float32)
        gj = graph_json
        if args.distinct_dynamic:
            # per-client patch_sim query: same PROGRAM signature, distinct
            # dynamic values — run_stacked stacks them per request
            import copy

            gj = copy.deepcopy(graph_json)
            gj["nodes"][sim_i]["params"]["row"] = str(1 + cid % 13)
            gj["nodes"][sim_i]["params"]["col"] = str(1 + (cid * 5) % 13)
        return encode_message(REQUEST_MAGIC, gj, [img])

    # Warm every compile-cache entry the run will hit: the single-request
    # program plus one vmapped program per power-of-two batch bucket.
    def one_request(body):
        urllib.request.urlopen(
            urllib.request.Request(base + "/compute", data=body,
                                   method="POST"), timeout=600).read()

    # Deterministic warmup: compile the single-request program and every
    # power-of-two vmapped bucket by calling the executor directly (thread
    # races in the batcher can skip a bucket and leave a multi-second
    # compile inside the timed window).
    from interactive_vit_tpu.wire.codec import Request as WireRequest

    def decoded_graph(seed):
        r = WireRequest()
        r.decode(bytes(make_request(seed)))
        return r

    taps = decoded_graph(0).taps or "primary"
    t0 = time.perf_counter()
    app.executor.run(decoded_graph(0).graph, taps=taps)
    print(f"warmed single in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    bucket = 2
    while bucket <= args.max_batch:
        t0 = time.perf_counter()
        graphs = [decoded_graph(i).graph for i in range(bucket)]
        app.executor.run_stacked(graphs, taps=taps)
        print(f"warmed bucket {bucket} in {time.perf_counter() - t0:.1f}s "
              f"(exec cache: {app.executor.cache_info()})", file=sys.stderr)
        bucket *= 2

    latencies: list = []
    errors = [0]
    lock = threading.Lock()
    stop_at = time.perf_counter() + args.duration

    def client(cid: int) -> None:
        i = 0
        while time.perf_counter() < stop_at:
            body = make_request(cid * 100003 + i, cid)
            t0 = time.perf_counter()
            try:
                raw = urllib.request.urlopen(
                    urllib.request.Request(base + "/compute", data=body,
                                           method="POST"), timeout=120).read()
                Response.decode(bytes(raw))
                with lock:
                    latencies.append(time.perf_counter() - t0)
            except Exception:  # noqa: BLE001
                with lock:
                    errors[0] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(args.clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    httpd.shutdown()
    app.batcher.stop()

    lat = sorted(latencies)
    if not lat:
        print(json.dumps({"metric": "serving p50", "value": -1,
                          "unit": "ms", "vs_baseline": 0}))
        return
    p50 = lat[len(lat) // 2] * 1e3
    p95 = lat[int(len(lat) * 0.95)] * 1e3
    rps = len(lat) / wall
    snap = app.metrics.snapshot()
    print(
        f"clients={args.clients} requests={len(lat)} errors={errors[0]} "
        f"p50={p50:.1f}ms p95={p95:.1f}ms rate={rps:.1f} req/s "
        f"mean_batch={snap['mean_batch_size']:.2f} "
        f"server_compute_p50={snap['compute_p50_ms']:.1f}ms",
        file=sys.stderr,
    )
    # the latency-attribution table: server-side phases vs the client wall
    # clock — the difference is network RTT + client work
    server_sum = (snap["decode_p50_ms"] + snap["queue_p50_ms"]
                  + snap["compute_p50_ms"] + snap["encode_p50_ms"])
    print(
        "latency breakdown (p50 ms): "
        f"decode={snap['decode_p50_ms']:.2f} "
        f"queue={snap['queue_p50_ms']:.2f} "
        f"compute={snap['compute_p50_ms']:.2f} "
        f"encode={snap['encode_p50_ms']:.2f} "
        f"| server total={server_sum:.1f} "
        f"| client wall p50={p50:.1f} "
        f"| rtt+client={p50 - server_sum:.1f} "
        f"(resp_dtype={args.resp_dtype}, "
        f"resp bytes/req={snap['counters'].get('response_bytes', 0) // max(1, snap['counters'].get('compute_requests', 1))})",
        file=sys.stderr,
    )
    # "interactive under load": BASELINE fixes no number; report p50 with
    # vs_baseline = fraction of a 200ms interactive budget used (lower=better).
    # server_compute_p50_ms isolates the server's own work from the
    # client and network share of the wall p50.
    print(json.dumps({
        "metric": f"p50 per-request latency, {args.clients} concurrent "
                  f"interactive sessions ({args.model} full-chain eval, "
                  f"taps={args.taps})",
        "value": round(p50, 1),
        "unit": "ms",
        "vs_baseline": round(p50 / 200.0, 4),
        "server_compute_p50_ms": round(snap["compute_p50_ms"], 2),
        "mean_batch_size": round(snap["mean_batch_size"], 2),
        "rate_rps": round(rps, 1),
    }))


if __name__ == "__main__":
    main()
