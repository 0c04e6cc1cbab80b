"""Server entry point: ``python -m interactive_vit_tpu.serving.server``.

Boot sequence parity with the reference (``manage.py runserver`` importing
``main.context`` which scanned plugins and loaded model weights at import,
SURVEY.md §3.1): register builtin ops, scan plugin dirs, register the
configured model variants (generating their graph JSONs into the library),
then serve.
"""

from __future__ import annotations

import argparse
import logging
import os

from interactive_vit_tpu.graph.registry import registry, scan_plugins
from interactive_vit_tpu.ops.dispatch import POLICIES
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.serving.app import App

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def load_model_params(variant: str, path: str, layout: str = "auto"):
    """Load real weights for ``variant`` from any supported checkpoint form:
    an orbax directory (our native format, written by tools/convert), a
    ``.safetensors`` file (torch-free), or a torch ``.pth``. File formats go
    through the layout converters (``tools/convert.convert``)."""
    if os.path.isdir(path):
        from interactive_vit_tpu.utils.checkpoint import load_params

        return load_params(path)
    from interactive_vit_tpu.tools.convert import convert, load_state_dict

    return convert(variant, layout, load_state_dict(path))


def build_app(
    models=("vit_t16",),
    graphs_dir: str = None,
    frontend_dir: str = None,
    plugin_dirs=(),
    max_batch: int = 8,
    max_wait_ms: float = 3.0,
    seed: int = 0,
    attn_impl_name: str = "auto",
    dtype_name: str = "float32",
    mesh_spec: str = "",
    compute_timeout_s: float = 120.0,
    ckpts=None,
    ckpt_layout: str = "auto",
    speculate: bool = True,
    speculate_buckets=(1,),
    inventory_path: str = "",
    pipeline_depth: int = 1,
) -> App:
    reg = registry()
    register_builtin(reg)
    for d in plugin_dirs:
        scan_plugins([d], reg)

    mesh = None
    if mesh_spec:
        # multi-device serving: "data=2,model=2". Captures TP-shard per
        # parallel/mesh.param_spec; micro-batches shard over "data".
        # Pallas kernels are not GSPMD-partitioned, so mesh mode serves
        # through the plain attention path.
        from interactive_vit_tpu.parallel.mesh import make_mesh

        axes = dict(kv.split("=") for kv in mesh_spec.split(","))
        mesh = make_mesh({k: int(v) for k, v in axes.items()})
        attn_impl_name = "reference"
        logger.info("serving on mesh %s", dict(mesh.shape))

    graphs_dir = graphs_dir or os.path.join(_REPO_ROOT, "static/graphs")
    frontend_dir = frontend_dir or os.path.join(_REPO_ROOT, "frontend")
    app = App(
        reg=reg,
        graphs_dir=graphs_dir,
        frontend_dir=frontend_dir if os.path.isdir(frontend_dir) else None,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        mesh=mesh,
        compute_timeout_s=compute_timeout_s,
        speculate=speculate,
        speculate_buckets=speculate_buckets,
        inventory_path=inventory_path,
        pipeline_depth=pipeline_depth,
    )

    from interactive_vit_tpu.models.autoregister import make_model
    from interactive_vit_tpu.ops.dispatch import default_attn_impl

    import jax.numpy as jnp

    # serving dtype: f32 = exact (parity contract); bfloat16 = the fast
    # interactive path (taps carry bf16 noise ~1e-3, invisible in the UI);
    # int8 = weight-only quantization over bf16 activations (halves weight
    # streaming — the small-batch interactive bottleneck; ops/quant.py);
    # int8w8a8 = dynamic activation quantization too (int8 x int8 -> int32
    # MLP dots, opt-in accuracy class)
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "int8": jnp.bfloat16, "int8w8a8": jnp.bfloat16}[dtype_name]
    quantize = {"int8": "w8", "int8w8a8": "w8a8"}.get(dtype_name, False)
    attn_impl = default_attn_impl(attn_impl_name)
    ckpts = dict(ckpts or {})
    for variant in models:
        params = None
        if variant in ckpts:
            params = load_model_params(variant, ckpts[variant], ckpt_layout)
            if dtype is not jnp.float32:
                import jax

                params = jax.tree.map(
                    lambda x: jnp.asarray(x, dtype), params)
            logger.info("loaded %s weights from %s", variant, ckpts[variant])
        # with a TP axis, re-pack qkv columns head-major so the mesh
        # column sharding is head-aligned (parallel/mesh.py)
        tp = (mesh is not None and
              dict(zip(mesh.axis_names,
                       mesh.devices.shape)).get("model", 1) > 1)
        model = make_model(variant, params=params, seed=seed,
                           attn_impl=attn_impl, dtype=dtype,
                           quantize=quantize, tp_layout=tp)
        model.register(reg, app.graphs)
        logger.info("registered model %s (%d nodes)", variant,
                    len(model.layers))
        # classifier chains also get the gradient-tap demo graph
        # (saliency heatmap + dream feature-vis wired off the head)
        sal_name = f"{variant}_saliency.json"
        if (any(ln.endswith(":head") for ln in model.list_node_names())
                and not app.graphs.exists(sal_name)):
            try:
                app.graphs.save(sal_name,
                                model.generate_saliency_graph_json())
                logger.info("generated graph %s", sal_name)
            except Exception as e:  # noqa: BLE001 — parity: log, continue
                logger.error("could not generate %s: %s", sal_name, e)
    if {"clip_b32", "clip_text_b32"} <= set(models) and \
            not app.graphs.exists("clip_zeroshot.json"):
        # both towers served: generate the zero-shot classification demo
        # (image chain + prompt chain joined at the similarity node)
        from interactive_vit_tpu.models.clip_text_plugin import (
            generate_zeroshot_graph_json,
        )

        try:
            app.graphs.save("clip_zeroshot.json",
                            generate_zeroshot_graph_json())
            logger.info("generated graph clip_zeroshot.json")
        except Exception as e:  # noqa: BLE001 — parity: log and continue
            logger.error("could not generate clip_zeroshot: %s", e)
    unused = set(ckpts) - set(models)
    if unused:
        # a typo'd --ckpt key would otherwise serve RANDOM-INIT weights
        # with no hint — garbage classifications that look like a model
        # bug instead of a flag mistake
        raise ValueError(
            f"--ckpt given for models not being served: {sorted(unused)} "
            f"(serving {sorted(models)})"
        )
    return app


def warmup(app: App, models, batch_sizes=(1,)) -> None:
    """Pre-compile each model's full-chain program at boot.

    With the persistent compilation cache this is a one-time cost per
    (model, batch) signature; afterwards the first user request is served
    at steady-state latency instead of paying a compile.
    """
    import numpy as np

    from interactive_vit_tpu.wire.schema import graph_from_json

    for variant in models:
        try:
            obj = app.graphs.load(variant + ".json")
        except FileNotFoundError:
            continue
        for bs in batch_sizes:
            # canonical 224px single-image signature (other input shapes
            # still compile on first sight — the persistent cache then
            # remembers them across restarts)
            graphs = []
            for _ in range(bs):
                gi = graph_from_json(obj)
                gi.add_input(np.zeros((3, 224, 224), np.float32),
                             gi.nodes[0], "o")
                graphs.append(gi)
            import time as _t

            t0 = _t.perf_counter()
            if bs == 1:
                app.executor.run(graphs[0], taps="primary")
            else:
                app.executor.run_stacked(graphs, taps="primary")
            logger.info("warmed %s batch=%d in %.1fs", variant, bs,
                        _t.perf_counter() - t0)


def main() -> None:
    parser = argparse.ArgumentParser(description="interactive_vit_tpu server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--models", default="vit_t16",
                        help="comma-separated ViT variants to register")
    parser.add_argument("--graphs-dir", default=None)
    parser.add_argument("--frontend-dir", default=None)
    parser.add_argument("--plugin-dirs", default="",
                        help="comma-separated extra plugin dirs to scan")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=3.0)
    parser.add_argument("--pipeline-depth", type=int, default=1,
                        help="in-flight dispatch groups before the "
                             "oldest is materialized (depth-1 overlaps "
                             "transfer with the next group's compute; "
                             "deeper keeps more compute queued at the "
                             "cost of oldest-result latency)")
    parser.add_argument("--compute-timeout-s", type=float, default=120.0,
                        help="per-request /compute deadline; a wedged "
                             "device returns 503 instead of hanging the "
                             "handler thread")
    parser.add_argument("--attn", default="auto",
                        choices=list(POLICIES),
                        help="attention policy (ops/dispatch.py): 'auto' "
                             "= the GPU kernels where they apply, else "
                             "the plain path; 'reference' = always the "
                             "plain path")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "int8", "int8w8a8"],
                        help="model weight/compute dtype (bfloat16 = fast "
                             "interactive path; int8 = weight-only "
                             "quantized serving over bf16 activations; "
                             "int8w8a8 = dynamic-activation int8 MLP "
                             "matmuls, opt-in accuracy class)")
    parser.add_argument("--ckpt", action="append", default=[],
                        metavar="MODEL=PATH",
                        help="serve MODEL with real weights from PATH (an "
                             "orbax dir from tools/convert, a .safetensors "
                             "file, or a torch .pth); repeatable")
    parser.add_argument("--ckpt-layout", default="auto",
                        choices=["auto", "torchvision", "timm", "openai"],
                        help="state-dict naming of file checkpoints "
                             "('auto' sniffs key prefixes)")
    parser.add_argument("--mesh", default="",
                        help="multi-device serving mesh, e.g. "
                             "'data=2,model=2' (add 'stage=N' for "
                             "pipeline-parallel serving of untapped block "
                             "chains); empty = single device")
    parser.add_argument("--platform", default="default",
                        choices=["default", "cpu"],
                        help="'cpu' forces the CPU backend in-process "
                             "(frontend/dev work without an accelerator); "
                             "'default' uses whatever JAX selects")
    parser.add_argument("--jit-cache", default=None,
                        help="persistent compilation cache dir ('' = off; "
                             "default: $JAX_COMPILATION_CACHE_DIR, else "
                             "<repo>/.jax_cache — utils/compile_cache.py)")
    parser.add_argument("--speculate-buckets", default="1",
                        help="comma-separated micro-batch buckets the "
                             "tap warmer precompiles per variant (e.g. "
                             "'1,4,8' when concurrent same-graph "
                             "sessions are expected; default single-"
                             "request programs only)")
    parser.add_argument("--no-speculate", action="store_true",
                        help="disable the speculative tap warmer (the "
                             "background thread that precompiles "
                             "sibling-block re-targets of viewer taps so "
                             "layer scrubbing never stalls on a compile)")
    parser.add_argument("--recycle-after-requests", type=int, default=0,
                        metavar="N",
                        help="recycle the worker process after N /compute "
                             "requests (gunicorn max_requests analog; "
                             "0 = never). The listen socket survives the "
                             "exec, so requests arriving mid-restart queue "
                             "instead of failing (serving/recycle.py)")
    parser.add_argument("--recycle-rss-mb", type=int, default=0,
                        metavar="MB",
                        help="recycle the worker when VmRSS exceeds MB "
                             "(0 = never): bounds the worker's lifetime "
                             "against any host-memory growth (a leaking "
                             "device plugin or library)")
    parser.add_argument("--warmup", action="store_true",
                        help="pre-compile each model's full-chain program "
                             "at boot (first request then runs at steady "
                             "state)")
    parser.add_argument("--warm-inventory", default="auto",
                        metavar="PATH",
                        help="served-program inventory file: each worker "
                             "generation records every program signature "
                             "it serves, saves the file at recycle, and "
                             "the next generation warms that exact set at "
                             "boot — killing the post-recycle re-staging "
                             "latency surge (serving/inventory.py). "
                             "'auto' (default) = $TMPDIR/ivt_warm_"
                             "inventory_<port>.json when recycling is on, "
                             "else off; "
                             "'' disables")
    parser.add_argument("--warm-budget-s", type=float, default=120.0,
                        help="wall budget for the synchronous part of the "
                             "inventory warm at boot (hottest signatures "
                             "first; the rest warm in the background via "
                             "the speculator while traffic flows)")
    parser.add_argument("--from-export", default="", metavar="DIR",
                        help="serve AOT artifact(s) (ivt-export output; comma-separated) "
                             "instead of live models: NO registry, NO "
                             "model zoo, NO plugin code — the StableHLO "
                             "program + captures boot directly "
                             "(serving/export_app.py)")
    parser.add_argument("--export-selftest", action="store_true",
                        help="with --from-export: verify each artifact "
                             "(seeded replay vs recorded output stats, "
                             "graph/export.ExportedGraph.selftest) "
                             "before serving; refuse to boot on a "
                             "corrupt artifact")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.platform == "cpu":
        # in-process platform override (before first backend use)
        import jax

        jax.config.update("jax_platforms", "cpu")
    from interactive_vit_tpu.utils import compile_cache

    compile_cache.enable(args.jit_cache)
    if args.from_export:
        from interactive_vit_tpu.serving.export_app import (
            ExportApp, MultiExportApp,
        )

        dirs = [d for d in args.from_export.split(",") if d]
        if len(dirs) == 1:
            xapp = ExportApp(dirs[0], frontend_dir=args.frontend_dir)
        else:
            xapp = MultiExportApp(dirs, frontend_dir=args.frontend_dir)
        logger.info("artifact(s) %s loaded in %.2fs; serving with no "
                    "model code", xapp.artifact_dir, xapp.boot_load_s)
        if args.export_selftest:
            units = getattr(xapp, "units", [xapp])
            for u in units:
                res = u.art.selftest()
                logger.info("selftest %s: ok=%s (%d outputs, worst "
                            "rel=%.2e)", u.artifact_dir, res["ok"],
                            res["checked"], res["worst"]["rel"])
                if not res["ok"]:
                    raise SystemExit(
                        f"artifact {u.artifact_dir} failed selftest: "
                        f"{res['worst']}")
        xapp.serve(args.host, args.port)
        return
    recycling_on = (args.recycle_after_requests > 0
                    or args.recycle_rss_mb > 0)
    inv_path = args.warm_inventory
    if inv_path == "auto":
        import tempfile

        inv_path = (os.path.join(tempfile.gettempdir(),
                                 f"ivt_warm_inventory_{args.port}.json")
                    if recycling_on else "")
    app = build_app(
        models=[m for m in args.models.split(",") if m],
        graphs_dir=args.graphs_dir,
        frontend_dir=args.frontend_dir,
        plugin_dirs=[d for d in args.plugin_dirs.split(",") if d],
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        attn_impl_name=args.attn,
        dtype_name=args.dtype,
        mesh_spec=args.mesh,
        compute_timeout_s=args.compute_timeout_s,
        ckpts=dict(kv.split("=", 1) for kv in args.ckpt),
        ckpt_layout=args.ckpt_layout,
        speculate=not args.no_speculate,
        speculate_buckets=tuple(
            int(b) for b in args.speculate_buckets.split(",") if b),
        inventory_path=inv_path,
        pipeline_depth=args.pipeline_depth,
    )
    if inv_path and os.path.exists(inv_path) and app.generation > 0:
        # a recycled generation: warm exactly what the previous one
        # served (hottest first, bounded; overflow to the background
        # warmer) BEFORE taking the backlog — the fresh process would
        # otherwise re-stage every signature on demand and clients eat
        # a seconds-long p50 until it's done (VERDICT r4 weak #1)
        from interactive_vit_tpu.serving import inventory as inv_mod

        try:
            entries, carried = inv_mod.ProgramInventory.load(inv_path)
            app.load_carried(carried)
            # accumulate coverage: this generation's inventory starts
            # from the union of all previous generations' entries
            # (decayed counts), so the warm set grows with the workload
            # instead of shrinking to one short generation's slice
            app.inventory.seed(entries)
            stats = inv_mod.warm(app.executor, entries,
                                 budget_s=args.warm_budget_s,
                                 speculator=app.speculator)
            app.metrics.inc("inventory_warmed", stats["warmed"])
            app.metrics.inc("inventory_deferred", stats["deferred"])
            app.metrics.inc("inventory_warm_failed", stats["failed"])
            logger.info("generation %d warmed %d/%d inventory programs "
                        "(%d deferred)", app.generation,
                        stats["warmed"], len(entries), stats["deferred"])
        except Exception as e:  # noqa: BLE001 — cold boot, as before
            logger.warning("inventory warm skipped: %s", e)
    if args.warmup:
        # warm every power-of-two micro-batch bucket up to --max-batch:
        # the batcher groups concurrent requests into those buckets, so a
        # first concurrent burst would otherwise pay a cold compile per
        # bucket mid-traffic (the persistent cache makes this one-time)
        buckets = [1]
        while buckets[-1] * 2 <= args.max_batch:
            buckets.append(buckets[-1] * 2)
        warmup(app, [m for m in args.models.split(",") if m],
               batch_sizes=tuple(buckets))

    import socket as socket_mod

    recycling = recycling_on
    inherited = os.environ.pop("IVT_INHERIT_SOCKET", None)
    sock = None
    if inherited is not None:
        # previous generation handed us its listening socket across exec;
        # connections that arrived during our boot are waiting in its
        # backlog right now
        sock = socket_mod.socket(fileno=int(inherited))
        logger.info("generation %d adopted listen socket %s",
                    app.generation, sock.getsockname())
    elif recycling:
        sock = socket_mod.create_server((args.host, args.port), backlog=128)
    if recycling:
        from interactive_vit_tpu.serving.recycle import Recycler

        httpd = app.serve(args.host, args.port, background=True, sock=sock)
        logger.info(
            "serving on %s:%d (generation %d; recycle after %d requests / "
            "%d MB RSS)", args.host, sock.getsockname()[1], app.generation,
            args.recycle_after_requests, args.recycle_rss_mb)
        rec = Recycler(app, max_compute_requests=args.recycle_after_requests,
                       max_rss_mb=args.recycle_rss_mb)
        rec.start(httpd)
        rec._thread.join()  # returns once the accept loop has stopped
        # NOTE: no httpd.server_close() — it would close the listen socket
        # we are about to hand to the next generation
        rec.exec_next(sock)  # does not return
    else:
        app.serve(args.host, args.port, sock=sock)


if __name__ == "__main__":
    main()
