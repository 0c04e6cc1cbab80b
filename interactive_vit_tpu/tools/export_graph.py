"""AOT graph exporter CLI: saved graph JSON -> deployable artifact.

The reference has no deployment story at all — a saved graph is topology
only (``/root/reference/main/views.py:21-30``) and serving always needs
the live torch model zoo. ``ivt-export`` compiles the whole tapped graph
into ONE serialized StableHLO program (``graph/export.py``) plus its
weights/dynamic-params, producing a directory that any jax install can
run with no model code, no registry, and no plugins:

    ivt-export vit_t16 --taps primary --batch 8 --out /tmp/vit_t16_aot
    ivt-export static/graphs/dino_s16.json --ckpt dino_s16=w.safetensors \
        --out /tmp/dino_aot --check

``--check`` reloads the artifact and verifies numeric parity against the
live executor on random inputs before declaring success (deploy gates
should be self-verifying).

Run an artifact headlessly:

    ivt-run-exported /tmp/vit_t16_aot input.npy --out /tmp/taps
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional


def _parse_shape(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def _unfed_inputs(g, reg):
    """Unfed required 'o' inputs in deterministic wiring order — the ONE
    iteration both the export wiring and the --check re-wiring use, so
    the check's feed list can never misalign with the exported input
    order."""
    out = []
    for n in g.nodes:
        kind = reg.get_node(n.name)
        if getattr(kind, "optional_inputs", False):
            continue
        for ch in kind.io(n.params)["ins"]:
            if ch == "o" and ch not in n.inputs:
                out.append((n, ch))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("graph", help="graph JSON path, or a name in "
                                  "static/graphs")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--taps", default="primary",
                    choices=["primary", "all", "sinks"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=1,
                    help="input batch size baked into the program")
    ap.add_argument("--image-shape", default="3,224,224",
                    help="C,H,W fed to every unfed image input")
    ap.add_argument("--platforms", default="",
                    help="comma-separated lowering targets (e.g. cuda,cpu); "
                         "default = current backend. Pallas-kernel node "
                         "fns lower only for their native platform.")
    ap.add_argument("--ckpt", action="append", default=[],
                    metavar="VARIANT=PATH",
                    help="real weights (ivt-server --ckpt contract); "
                         "repeatable")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and verify parity against "
                         "the live executor on random inputs")
    ap.add_argument("--mesh", default="",
                    help="export a mesh-sharded program, e.g. "
                         "'data=4,model=2' (ivt-server --mesh contract); "
                         "the artifact then requires that many devices "
                         "to load")
    ap.add_argument("--graphs-dir", default=None)
    ap.add_argument("--plugin-dirs", default="")
    ap.add_argument("--platform", default="default",
                    choices=["default", "cpu"],
                    help="cpu = in-process CPU backend override")
    args = ap.parse_args(argv)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from interactive_vit_tpu.graph.executor import Executor, shape_struct
    from interactive_vit_tpu.graph.export import export_graph, load_artifact
    from interactive_vit_tpu.graph.registry import Registry, scan_plugins
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.tools.run_graph import (
        _model_variants, _register_models,
    )
    from interactive_vit_tpu.wire.schema import graph_from_json

    path = args.graph
    if not os.path.exists(path):
        root = args.graphs_dir or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "static", "graphs")
        cand = os.path.join(root, path if path.endswith(".json")
                            else path + ".json")
        if not os.path.exists(cand):
            print(f"graph not found: {args.graph}", file=sys.stderr)
            return 2
        path = cand
    obj = json.load(open(path))

    reg = Registry()
    register_builtin(reg)
    dirs = [d for d in args.plugin_dirs.split(",") if d]
    if dirs:
        scan_plugins(dirs, reg)
    endpoints = {
        n["instance"].get("endpoint") or n["instance"]["kind"]
        for n in obj["nodes"]
    }
    mesh = None
    if args.mesh:
        from interactive_vit_tpu.parallel.mesh import make_mesh

        axes = dict(kv.split("=") for kv in args.mesh.split(","))
        mesh = make_mesh({k: int(v) for k, v in axes.items()})
    # mesh mode mirrors the server's registration: head-major qkv when
    # a TP axis exists (serving/server.py build_app)
    tp = (mesh is not None and
          dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1) > 1)
    _register_models(reg, _model_variants(endpoints), args.dtype,
                     ckpts=dict(kv.split("=", 1) for kv in args.ckpt),
                     tp_layout=tp)

    g = graph_from_json(obj)
    img_shape = (args.batch,) + _parse_shape(args.image_shape)
    unfed = _unfed_inputs(g, reg)
    for n, ch in unfed:
        g.add_input(shape_struct(np.zeros(img_shape, np.float32)), n, ch)
    if unfed:
        print(f"wired {len(unfed)} image input(s) of shape "
              f"{list(img_shape)}", file=sys.stderr)

    ex = Executor(reg=reg, mesh=mesh)
    platforms = [p for p in args.platforms.split(",") if p] or None
    manifest = export_graph(
        g, args.out, taps=args.taps, executor=ex, platforms=platforms,
        provenance={"graph": os.path.basename(path),
                    "dtype": args.dtype, "taps": args.taps},
        client_graph=obj)
    size = sum(
        os.path.getsize(os.path.join(args.out, f))
        for f in os.listdir(args.out))
    print(f"exported {len(manifest['out_keys'])} outputs for platforms "
          f"{manifest['platforms']} -> {args.out} "
          f"({size / 1e6:.1f} MB)", file=sys.stderr)

    if args.check:
        art = load_artifact(args.out)
        rng = np.random.default_rng(0)
        feeds = [rng.random(s["shape"], np.float32).astype(s["dtype"])
                 for s in art.input_specs]
        got = art(*feeds)
        # live executor on the same inputs (same wiring order by
        # construction: _unfed_inputs is the one iteration)
        g2 = graph_from_json(obj)
        for (n, ch), feed in zip(_unfed_inputs(g2, reg), feeds):
            g2.add_input(np.asarray(feed), n, ch)
        want = ex.run(g2, taps=args.taps)
        worst = 0.0
        for i, chans in want.items():
            for ch, v in chans.items():
                a, b = np.asarray(v, np.float32), np.asarray(
                    got[i][ch], np.float32)
                worst = max(worst, float(np.max(np.abs(a - b))))
        tol = 1e-5 if args.dtype == "float32" else 2e-2
        if worst > tol:
            print(f"CHECK FAILED: max |live - exported| = {worst:.3e} "
                  f"> {tol}", file=sys.stderr)
            return 1
        print(f"check ok: max |live - exported| = {worst:.3e}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
