"""Headless graph runner: evaluate a saved graph on an image, dump taps.

The reference's only way to evaluate a graph was interactively in a
browser (``/root/reference/main/static/main/load.js:4-66`` drives
``Context.do_eval``). This CLI runs the SAME saved-graph JSON through the
staged executor with no browser in the loop — for scripting, batch
jobs, CI, and demoing the product on machines without a display:

    ivt-run static/graphs/dino_s16.json --image cat.png --out /tmp/taps
    ivt-run demo_noise --taps all --out /tmp/taps

Outputs one ``.npy`` per tapped (node, channel); image-shaped taps
([3,H,W] / [B,3,H,W] in [0,1], e.g. ``pca_view``/``patch_sim`` maps) and
2-D heatmaps are also rendered to ``.png``.

Model node kinds are auto-registered from the graph's endpoints
(``vit_*``/``dino_*``/``clip_b32``/``vgg16`` prefixes), mirroring the
serving boot (``serving/server.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Set


def _load_image(path: str) -> "np.ndarray":
    """Decode to CHW f32 in [0,1] — the ImgSource contract
    (``/root/reference/main/static/main/nodes/img_source_node.js:82-101``:
    canvas RGBA -> f32 CHW / 255)."""
    import numpy as np
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0  # HWC
    return arr.transpose(2, 0, 1)  # CHW


def _model_variants(endpoints: Set[str]) -> Set[str]:
    return {e.split(":", 1)[0] for e in endpoints if ":" in e}


def _register_models(reg, variants: Set[str], dtype_name: str, lib=None,
                     ckpts: Optional[Dict[str, str]] = None, **model_kw):
    """Register every model family a graph references — the ONE
    variant dispatch (``models/autoregister.make_model``), so this
    runner can never fall behind the server's model list again.
    ``ckpts``: variant -> checkpoint path (orbax dir / safetensors /
    torch .pth, same contract as ``ivt-server --ckpt``)."""
    import jax.numpy as jnp

    from interactive_vit_tpu.models.autoregister import (
        known_variants, make_model,
    )

    dtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    known = set(known_variants())
    for v in sorted(variants):
        # plain-ViT names accept an @<pixels> resolution suffix
        # (models/vit.resolve_variant); bad suffixes on known bases must
        # error inside make_model, not silently skip
        if v not in known and v.partition("@")[0] not in known:
            # only GENUINELY unknown prefixes are skippable (a plugin may
            # provide them); construction errors for known variants must
            # surface as themselves, not as this warning
            print(f"warning: unknown model prefix {v!r} — relying on "
                  f"builtin/plugin kinds", file=sys.stderr)
            continue
        params = None
        if ckpts and v in ckpts:
            from interactive_vit_tpu.serving.server import load_model_params

            params = load_model_params(v, ckpts[v])
            if dtype is not jnp.float32:
                import jax

                params = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                                      params)
        make_model(v, params=params, dtype=dtype,
                   **model_kw).register(reg, lib)


def _save_png(path: str, a: "np.ndarray") -> bool:
    """Render [3,H,W] / [1,3,H,W] (RGB in [0,1]) or [H,W] / leading-1
    heatmaps; returns False for shapes that aren't image-like."""
    import numpy as np
    from PIL import Image

    x = np.asarray(a, dtype=np.float32)
    while x.ndim > 2 and x.shape[0] == 1:
        x = x[0]
    if x.ndim == 3 and x.shape[0] == 3:
        img = (np.clip(x, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(img).save(path)
        return True
    # square 2-D maps only (attention/rollout/similarity); rectangular
    # token matrices stay .npy-only
    if x.ndim == 2 and x.shape[0] == x.shape[1] and x.shape[0] >= 2:
        lo, hi = float(x.min()), float(x.max())
        g = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
        Image.fromarray((g * 255).astype(np.uint8), mode="L").save(path)
        return True
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("graph", help="graph JSON path, or a name in --graphs-dir")
    ap.add_argument("--image", help="input image bound to every img_src node")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--taps", default="primary",
                    choices=["primary", "all", "sinks"],
                    help="tap policy (graph/executor.py docstring)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--graphs-dir", default=None)
    ap.add_argument("--plugin-dirs", default="",
                    help="comma-separated plugin dirs (same contract as "
                         "the server)")
    ap.add_argument("--ckpt", action="append", default=[],
                    metavar="VARIANT=PATH",
                    help="load real weights for a model family (same "
                         "contract as ivt-server --ckpt); repeatable")
    ap.add_argument("--platform", default="default",
                    choices=["default", "cpu"],
                    help="cpu = in-process CPU backend override")
    args = ap.parse_args(argv)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.ops.node_ops import register_builtin
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

    from interactive_vit_tpu.graph.registry import scan_plugins

    reg = Registry()
    register_builtin(reg)
    dirs = [d for d in args.plugin_dirs.split(",") if d]
    if dirs:
        scan_plugins(dirs, reg)
    endpoints = {
        n["instance"].get("endpoint") or n["instance"]["kind"]
        for n in obj["nodes"]
    }
    _register_models(reg, _model_variants(endpoints), args.dtype,
                     ckpts=dict(kv.split("=", 1) for kv in args.ckpt))

    g = graph_from_json(obj)
    image: Optional[np.ndarray] = (
        _load_image(args.image) if args.image else None
    )
    n_src = 0
    # nodes some OTHER node consumes: an input-less sink (a dangling
    # img_view/category left over from UI editing) must NOT demand an
    # image — the executor tolerates its missing input, and binding the
    # raw image to a viewer would add bogus outputs to the manifest
    consumed = {e.src.node.index for n in g.nodes
                for e in n.inputs.values() if e.src is not None}
    for n in g.nodes:
        # bind the image to every unwired "o" input at a graph root:
        # explicit img_src nodes, and the bare `<model>:transform` heads
        # of generated graphs (the UI wires an ImgSource there by hand,
        # `/root/reference/main/static/main/index.js:17-53`; headless
        # runs bind it directly so every static/graphs/*.json evaluates)
        def _root_wants_image(n=n):
            if n.inputs:
                return False
            if n.index not in consumed and len(g.nodes) > 1:
                return False  # dangling sink, nothing downstream
            try:
                ins = reg.get_node(n.name).io(n.params).get("ins", ())
            except Exception:
                return False  # unknown kind: executor attributes the error
            return "o" in ins

        needs_image = n.name == "img_src" or _root_wants_image()
        if needs_image and "o" not in n.inputs:
            if image is None:
                print(f"graph needs an image at node {n.index} "
                      f"({n.name}); pass --image", file=sys.stderr)
                return 2
            g.add_input(image, n, "o")
            n_src += 1

    ex = Executor(reg=reg)
    outs = ex.run(g, taps=args.taps)
    st = ex.last_stats
    print(f"evaluated {len(g.nodes)} nodes ({n_src} image inputs) in "
          f"{st.execute_s * 1e3:.1f} ms (compile {st.compile_s * 1e3:.1f} ms)",
          file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)
    manifest: Dict[str, Dict] = {}
    for i, chans in sorted(outs.items()):
        for ch, v in chans.items():
            a = np.asarray(v)
            stem = f"{i:03d}_{g.nodes[i].name.replace(':', '.')}_{ch}"
            np.save(os.path.join(args.out, stem + ".npy"), a)
            png = _save_png(os.path.join(args.out, stem + ".png"), a)
            manifest[stem] = {"node": i, "name": g.nodes[i].name,
                              "channel": ch, "shape": list(a.shape),
                              "png": png}
            print(f"  {stem}  {a.shape}" + ("  [png]" if png else ""),
                  file=sys.stderr)
    json.dump(manifest, open(os.path.join(args.out, "manifest.json"), "w"),
              indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
