"""Run an AOT-exported graph artifact headlessly (no model code needed).

Counterpart of ``ivt-run`` for artifacts produced by ``ivt-export``: the
math ships inside the artifact's StableHLO program, so this runner
imports no model zoo, no node registry, and no plugins — only jax and
the artifact bytes (``graph/export.py`` docstring).

    ivt-run-exported /tmp/vit_t16_aot input.npy --out /tmp/taps
    ivt-run-exported /tmp/vit_t16_aot --image cat.png --out /tmp/taps
    ivt-run-exported /tmp/vit_t16_aot input.npy --set-cap "17:class=281"
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("artifact", help="artifact directory (ivt-export --out)")
    ap.add_argument("inputs", nargs="*",
                    help=".npy files, one per program input (batch dim "
                         "must match the exported shape)")
    ap.add_argument("--image", help="image file fed (resized/broadcast to "
                                    "the exported input shape) to every "
                                    "program input instead of .npy files")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--set-cap", action="append", default=[],
                    metavar="NODE:NAME=VALUE",
                    help="edit a dynamic capture before running (e.g. "
                         "'17:class=281'); repeatable")
    ap.add_argument("--platform", default="default",
                    choices=["default", "cpu"],
                    help="cpu = in-process CPU backend override")
    ap.add_argument("--selftest", action="store_true",
                    help="verify artifact integrity (seeded replay vs "
                         "the manifest's recorded output statistics — "
                         "no model code needed) and exit 0/1")
    args = ap.parse_args(argv)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from interactive_vit_tpu.graph.export import ExportError, load_artifact

    try:
        art = load_artifact(args.artifact)
    except ExportError as err:
        print(f"cannot load artifact: {err}", file=sys.stderr)
        return 2

    if args.selftest:
        try:
            res = art.selftest()
        except ExportError as err:
            print(f"selftest unavailable: {err}", file=sys.stderr)
            return 2
        print(json.dumps(res))
        return 0 if res["ok"] else 1

    specs = art.input_specs
    if args.image:
        from interactive_vit_tpu.tools.run_graph import _load_image

        img = _load_image(args.image)  # [3,H,W] in [0,1]
        feeds = []
        for s in specs:
            shp = s["shape"]
            if len(shp) == 4 and shp[1] == 3:
                import jax
                import jax.numpy as jnp

                r = jax.image.resize(jnp.asarray(img), (3,) + tuple(shp[2:]),
                                     method="bilinear")
                feeds.append(np.broadcast_to(
                    np.asarray(r)[None], shp).astype(s["dtype"]))
            else:
                print(f"input {s['name']}:{s['channel']} has non-image "
                      f"shape {shp}; pass a .npy for it", file=sys.stderr)
                return 2
    else:
        if len(args.inputs) != len(specs):
            print(f"program takes {len(specs)} inputs "
                  f"({[(s['name'], s['shape']) for s in specs]}), "
                  f"got {len(args.inputs)} .npy files", file=sys.stderr)
            return 2
        feeds = [np.load(p) for p in args.inputs]

    for spec in args.set_cap:
        try:
            key, val = spec.split("=", 1)
            node, name = key.split(":", 1)
            art.set_cap(int(node), name, float(val) if "." in val
                        else int(val))
        except (ValueError, ExportError) as err:
            print(f"bad --set-cap {spec!r}: {err}", file=sys.stderr)
            return 2

    try:
        outs = art(*feeds)
    except ExportError as err:
        print(f"run failed: {err}", file=sys.stderr)
        return 1

    from interactive_vit_tpu.tools.run_graph import _save_png

    os.makedirs(args.out, exist_ok=True)
    for i, chans in sorted(outs.items()):
        for ch, v in chans.items():
            a = np.asarray(v)
            stem = f"{i:03d}_{ch}"
            np.save(os.path.join(args.out, stem + ".npy"), a)
            png = _save_png(os.path.join(args.out, stem + ".png"), a)
            print(f"  {stem}  {a.shape}" + ("  [png]" if png else ""),
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
