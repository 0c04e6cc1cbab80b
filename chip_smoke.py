"""On-card smoke test: the served tappable graph on one NVIDIA GPU.

    python chip_smoke.py           # phases device, serve, parity, kernels
    python chip_smoke.py --four    # phases device, four (needs 4 GPUs)

Everything runs in ONE JAX process: the server (``serving/server.build_app``
+ ``App.serve``) and its HTTP clients, which are threads speaking the wire
codec over ``urllib``. Phases:

device   a GPU is the default device (no CPU fallback); prints the card,
         its power limit, JAX, XLA_FLAGS, the compile cache, the codec.
serve    vit_b16 + vgg16 in bfloat16 behind HTTP: concurrent vit_b16
         requests tapping the logits, all 12 attention maps and the
         rollout; one vgg16 request on the reference's own saved graph
         (its convolutions go to cuDNN); one request on the
         vit_b16_saliency.json graph generated at boot (gradient replays
         through the differentiable twins); /list_graphs, /load_graph,
         /description.
parity   served float32 against the monolithic ``vit.forward`` at
         HIGHEST precision (max-abs <= 1e-4, the repo's contract), and
         the served bfloat16 taps of the serve phase against the same
         reference within BF16_TOL (see there).
kernels  each GPU attention path that dispatch picks, checked against
         ``attention_reference`` at real widths (vit_b16 and vit_l16@384),
         and ViT-H/14's head dim 80, which the probs kernel does not take.
four     vit_b16 served on a data=2,model=2 mesh of 4 GPUs: bf16 compared
         tap for tap with the same requests on one device and with the
         f32 reference, and f32 with the f32 reference (see phase_four).

Any failing phase ends the run with exit code 1 and no result line; the
last line of a passing run is one JSON object with the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "interactive_vit_tpu"
VARIANT = "vit_b16"

#: bfloat16 vs the f32 reference. bf16 keeps 8 significant bits (relative
#: rounding 2^-9 ~ 0.2%); the weights are bf16-rounded and every layer
#: boundary rounds the activations again, in another summation order, so
#: over 12 residual blocks the logits drift ~1% of their range (measured
#: 0.031-0.036 against a logit range of 3.2-3.6 on three seeded images
#: with XLA's CPU backend) and the maps by ~3e-3 absolute. The limits give
#: about five times that headroom.
BF16_TOL = {"logits_rel": 0.05, "maps_abs": 1.5e-2, "rollout_rel": 0.05}
F32_TOL = 1e-4
#: (B, H, N, Dh) -> the implementation dispatch must pick with the maps
#: wanted and without: vit_b16 @224 B=96, vit_l16 @384 B=16, and
#: vit_h14's head dim 80 (not a power of two: the plain path with maps)
KERNEL_CASES = (((96, 12, 197, 64), {True: "gpu_probs", False: "cudnn"}),
                ((16, 16, 577, 64), {True: "gpu_probs", False: "cudnn"}),
                ((16, 16, 257, 80), {True: "reference", False: "cudnn"}))
MESH = "data=2,model=2"


class PhaseError(AssertionError):
    """A check of a phase failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def select_phases(four: bool) -> list:
    """Phase names in run order: --four runs only the mesh path (and
    the device check it needs)."""
    return ["device", "four"] if four else [
        "device", "serve", "parity", "kernels"]


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def run_phases(phases, state: dict, log=print) -> bool:
    """Run ``[(name, fn)]`` in order; stop at the first failure."""
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn(state)
        except Exception:  # noqa: BLE001 — reported, then exit non-zero
            log(traceback.format_exc().rstrip())
            log(f"== phase {name}: FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            return False
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    return True


# -- helpers -----------------------------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi listed no card")
    return "; ".join(lines)


def _url(base, path, body=None):
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body else "GET")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        status, raw = r.status, r.read()
    return status, raw, (time.perf_counter() - t0) * 1e3


def _graphs_copy() -> str:
    """A scratch copy of static/graphs: boot writes generated graphs
    (the saliency demo) into the library, never into the checkout."""
    d = tempfile.mkdtemp(prefix="ivt_smoke_graphs_")
    shutil.copytree(os.path.join(REPO, "static", "graphs"), d,
                    dirs_exist_ok=True)
    return d


def _image(seed: int):
    import numpy as np

    return np.random.default_rng(seed).random((3, 224, 224),
                                              dtype=np.float32)


def model_cfg():
    from interactive_vit_tpu.models import vit

    return vit.VARIANTS[VARIANT]


def maps_request(img) -> bytes:
    """The vit chain with taps on the logits, every block's attention
    maps and the rollout carried along the blocks' "r" channel."""
    from interactive_vit_tpu.wire.codec import REQUEST_MAGIC, encode_message

    depth = model_cfg().depth
    names = (["transform", "embed"] + [f"blocks.{i}" for i in range(depth)]
             + ["norm", "head"])
    nodes = [{"endpoint": f"{VARIANT}:{n}", "params": {}} for n in names]
    edges = [{"out_port": {"node": 0, "channel": "o"}, "tensor": 0}]
    for i in range(1, len(nodes)):
        edges.append({"out_port": {"node": i, "channel": "o"},
                      "in_port": {"node": i - 1, "channel": "o"}})
    first, last = 2, 2 + depth - 1
    for i in range(first, last):
        edges.append({"out_port": {"node": i + 1, "channel": "r"},
                      "in_port": {"node": i, "channel": "r"}})
    taps = ([{"node": len(nodes) - 1, "channel": "o"}]
            + [{"node": i, "channel": "attn"} for i in range(first, last + 1)]
            + [{"node": last, "channel": "r"}])
    return encode_message(REQUEST_MAGIC,
                          {"nodes": nodes, "edges": edges, "taps": taps},
                          [img])


def split_maps_response(out: dict):
    """-> (logits [1,K], [depth x [1,H,N,N]], rollout [1,N,N]), float32."""
    import numpy as np

    depth = model_cfg().depth
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    logits = f(out[depth + 3]["o"])
    maps = [f(out[i]["attn"]) for i in range(2, 2 + depth)]
    return logits, maps, f(out[2 + depth - 1]["r"])


def check_maps_taps(logits, maps, rollout):
    import numpy as np

    cfg = model_cfg()
    n, heads = cfg.tokens, cfg.heads
    check(logits.shape == (1, cfg.num_classes),
          f"logits shape {logits.shape}")
    check(len(maps) == cfg.depth, f"{len(maps)} attention maps")
    for i, m in enumerate(maps):
        check(m.shape == (1, heads, n, n), f"map {i} shape {m.shape}")
        check(bool(np.isfinite(m).all()), f"map {i} not finite")
        rows = m.sum(-1)
        check(float(np.abs(rows - 1).max()) < 2e-2,
              f"map {i} rows sum to {rows.min()}..{rows.max()}")
    check(rollout.shape == (1, n, n), f"rollout shape {rollout.shape}")
    check(bool(np.isfinite(logits).all() and np.isfinite(rollout).all()),
          "logits/rollout not finite")


def post_concurrently(base: str, bodies):
    """POST every body from its own thread; -> [(status, raw, ms)]."""
    res = [None] * len(bodies)

    def go(i):
        try:
            res[i] = _url(base, "/compute", bodies[i])
        except Exception as e:  # noqa: BLE001 — surfaced below
            res[i] = e

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for r in res:
        if isinstance(r, Exception):
            raise r
    return res


class Served:
    """build_app + App.serve on a free port, torn down on exit."""

    def __init__(self, **kw):
        from interactive_vit_tpu.serving.server import build_app

        kw.setdefault("speculate", False)
        self.app = build_app(**kw)
        self.httpd = self.app.serve("127.0.0.1", 0, background=True)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.batcher.stop()


# -- phases ------------------------------------------------------------------


def phase_device(state: dict) -> None:
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"the default device is {devs[0].platform!r}, not a GPU")
    need = state.get("need_devices", 1)
    check(len(devs) >= need, f"{len(devs)} GPU(s), {need} needed")
    from interactive_vit_tpu.runtime import native
    from interactive_vit_tpu.utils import compile_cache

    state["card"] = card_line()
    print(f"device: {devs[0].device_kind} x {len(devs)}")
    print(f"card (nvidia-smi name, power.limit): {state['card']}")
    flags = os.environ.get("XLA_FLAGS", "")
    print(f"jax {jax.__version__}; XLA_FLAGS={flags!r}")
    print(f"compile cache: {compile_cache.cache_dir()}")
    print(f"native wire codec loaded: {native.get_lib() is not None}")


def phase_serve(state: dict) -> None:
    import numpy as np

    from interactive_vit_tpu.wire.codec import Request, Response
    from interactive_vit_tpu.wire.schema import graph_from_json

    with Served(models=(VARIANT, "vgg16"), dtype_name="bfloat16",
                graphs_dir=state["graphs"]) as srv:
        status, raw, _ = _url(srv.base, "/list_graphs")
        listed = json.loads(raw)
        for g in (f"{VARIANT}.json", "vgg16.json",
                  f"{VARIANT}_saliency.json"):
            check(g in listed, f"/list_graphs lacks {g}")
        status, raw, _ = _url(srv.base, f"/load_graph/{VARIANT}.json")
        check(status == 200 and len(json.loads(raw)["nodes"])
              == model_cfg().depth + 5, f"/load_graph/{VARIANT}.json")
        status, raw, _ = _url(srv.base, f"/description/{VARIANT}:blocks.0")
        io = json.loads(raw)
        check("attn" in io["outs"] and "r" in io["outs"],
              f"/description {io}")

        imgs = [_image(s) for s in range(4)]
        res = post_concurrently(srv.base, [maps_request(i) for i in imgs])
        for k, (status, raw, ms) in enumerate(res):
            check(status == 200, f"maps request {k}: HTTP {status}")
            taps = split_maps_response(Response.decode(raw))
            check_maps_taps(*taps)
            print(f"serve {VARIANT} bf16 logits+maps+rollout request "
                  f"{k}: {ms:.1f} ms wall incl. compile "
                  f"({state['card']}; information only)")
            if k == 0:
                state["bf16_taps"], state["img0"] = taps, imgs[0]
        for label in ("batch-1 program, incl. compile", "warm"):
            status, raw, ms = _url(srv.base, "/compute",
                                   maps_request(imgs[0]))
            check(status == 200, f"single maps request: HTTP {status}")
            print(f"serve {VARIANT} bf16 maps request, {label}: "
                  f"{ms:.1f} ms ({state['card']}; information only)")

        for name in ("vgg16.json", f"{VARIANT}_saliency.json"):
            g = graph_from_json(json.loads(_url(
                srv.base, f"/load_graph/{name}")[1]))
            g.add_input(_image(7), g.nodes[0], "o")
            status, raw, ms = _url(srv.base, "/compute", Request.encode(g))
            check(status == 200, f"{name}: HTTP {status}")
            out = Response.decode(raw)
            arrays = [np.asarray(a, np.float32) for d in out.values()
                      for a in d.values()]
            check(len(arrays) > 0, f"{name}: no outputs")
            check(all(np.isfinite(a).all() for a in arrays),
                  f"{name}: non-finite outputs")
            print(f"serve {name}: {len(arrays)} tensors finite, "
                  f"{ms:.1f} ms wall incl. compile ({state['card']})")
        head = next(i for i, n in enumerate(g.nodes)
                    if n.name.endswith(":head"))
        check(out[head]["o"].shape == (1, model_cfg().num_classes),
              "saliency graph logits")


def reference_taps(imgs) -> list:
    """Monolithic f32 ``vit.forward`` at HIGHEST on the same seeded
    weights and the same eval transform as the served graph, one
    ``(logits, maps, rollout)`` per image."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

    cfg = model_cfg()
    params = vit.init_params(jax.random.key(0), cfg, dtype=jnp.float32)

    def fwd(p, im):
        x = preprocess_mm(im[None], cfg.img_size)
        return vit.forward(p, x, cfg, want_attn=True)

    jf = jax.jit(fwd)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    taps = []
    for img in imgs:
        with jax.default_matmul_precision("highest"):
            out = jf(params, jnp.asarray(img))
        taps.append((f(out["logits"]), [f(a) for a in out["attn"]],
                     f(out["rollout"])))
    return taps


def tap_errors(got, ref) -> dict:
    import numpy as np

    (gl, gm, gr), (rl, rm, rr) = got, ref
    return {
        "logits": float(np.abs(gl - rl).max()),
        "logits_scale": float(np.abs(rl).max()),
        "maps": max(float(np.abs(a - b).max()) for a, b in zip(gm, rm)),
        "rollout": float(np.abs(gr - rr).max()),
        "rollout_scale": float(np.abs(rr).max()),
    }


def check_f32(err: dict, what: str) -> None:
    for key in ("logits", "maps", "rollout"):
        check(err[key] <= F32_TOL, f"{what}: {key} error {err[key]}")


def check_bf16(err: dict, what: str) -> None:
    check(err["logits"] <= BF16_TOL["logits_rel"] * err["logits_scale"],
          f"{what}: logits {err}")
    check(err["maps"] <= BF16_TOL["maps_abs"], f"{what}: maps {err}")
    check(err["rollout"] <= BF16_TOL["rollout_rel"] * err["rollout_scale"],
          f"{what}: rollout {err}")


def phase_parity(state: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.ops import layers as L
    from interactive_vit_tpu.wire.codec import Response

    # f32 products on this card default to TF32 unless a precision is
    # pinned: the repo pins HIGHEST for f32 operands (layers.mm_precision)
    a = np.random.default_rng(0).standard_normal((512, 512), np.float32)
    exact = a.astype(np.float64) @ a.astype(np.float64)
    da = jnp.asarray(a)
    default = np.asarray(jnp.dot(da, da))
    pinned = np.asarray(jax.jit(lambda x: L.linear(x, x, None))(da))
    e_def = float(np.abs(default - exact).max())
    e_pin = float(np.abs(pinned - exact).max())
    print(f"f32 512x512 product, max-abs vs float64: default precision "
          f"{e_def:.3e}, layers.linear (mm_precision) {e_pin:.3e}")
    check(e_pin <= 1e-3, f"layers.linear f32 error {e_pin}")

    img = state["img0"]
    ref = reference_taps([img])[0]
    with Served(models=(VARIANT,), dtype_name="float32",
                graphs_dir=state["graphs"]) as srv:
        status, raw, ms = _url(srv.base, "/compute", maps_request(img))
        check(status == 200, f"f32 maps request: HTTP {status}")
    got = split_maps_response(Response.decode(raw))
    check_maps_taps(*got)
    e32 = tap_errors(got, ref)
    print(f"parity served f32 vs vit.forward f32 HIGHEST: max-abs logits "
          f"{e32['logits']:.3e}, maps {e32['maps']:.3e}, rollout "
          f"{e32['rollout']:.3e} (limit {F32_TOL})")
    check_f32(e32, "f32")
    e16 = tap_errors(state["bf16_taps"], ref)
    print(f"parity served bf16 vs the same reference: max-abs logits "
          f"{e16['logits']:.3e} (scale {e16['logits_scale']:.3f}), maps "
          f"{e16['maps']:.3e}, rollout {e16['rollout']:.3e} (limits "
          f"{BF16_TOL})")
    check_bf16(e16, "bf16")


def phase_kernels(state: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.ops import dispatch
    from interactive_vit_tpu.ops.attention import attention_reference

    markers = {"gpu_probs": "triton", "cudnn": "cudnn"}
    for (b, h, n, dh), expect in KERNEL_CASES:
        ks = jax.random.split(jax.random.key(n), 3)
        q, k, v = (jax.random.normal(x, (b, h, n, dh), jnp.float32)
                   for x in ks)
        ref_out, ref_p = jax.jit(lambda q, k, v: attention_reference(
            q, k, v, want_attn=True))(q, k, v)
        q16, k16, v16 = (x.astype(jnp.bfloat16) for x in (q, k, v))
        plain_out, plain_p = jax.jit(lambda q, k, v: attention_reference(
            q, k, v, want_attn=True))(q16, k16, v16)
        e_plain = float(jnp.abs(plain_out.astype(jnp.float32)
                                - ref_out).max())
        ep_plain = float(jnp.abs(plain_p - ref_p).max())
        for want in (True, False):
            impl = dispatch.choose_attention(jnp.bfloat16, want, dh)
            check(impl == expect[want], f"dispatch chose {impl!r} for bf16 "
                  f"want_attn={want} dh={dh} on the GPU, not {expect[want]}")
            fn = jax.jit(lambda q, k, v, w=want: dispatch.auto_attention(
                q, k, v, want_attn=w))
            hlo = fn.lower(q16, k16, v16).as_text().lower()
            for name, marker in markers.items():
                check((marker in hlo) == (name == impl),
                      f"{impl}: {marker} call in the lowered program: "
                      f"{marker in hlo}")
            out, p = fn(q16, k16, v16)
            e_out = float(jnp.abs(out.astype(jnp.float32) - ref_out).max())
            line = (f"kernel {impl} B={b} H={h} N={n} dh={dh}: out max-abs "
                    f"{e_out:.3e} (plain bf16 {e_plain:.3e})")
            check(bool(np.isfinite(e_out)) and e_out <= 2 * e_plain + 1e-2,
                  line)
            if want:
                e_p = float(jnp.abs(p.astype(jnp.float32) - ref_p).max())
                line += f", probs {e_p:.3e} (plain bf16 {ep_plain:.3e})"
                check(p.shape == (b, h, n, n) and
                      e_p <= 2 * ep_plain + 1e-2, line)
            print(line)


def phase_four(state: dict) -> None:
    """Mesh serving (``build_app(mesh_spec=MESH)``) on four GPUs, which
    runs the plain attention path (Pallas kernels are not partitioned).

    f32 on the mesh against the f32 HIGHEST reference, within F32_TOL:
    this is the check that catches a sharding fault, because at f32 both
    sides do the same math to rounding. bf16 on the mesh against the same
    reference within BF16_TOL, the one-device bf16 contract; and against
    the same requests served in bf16 on one device (plain path), also
    within BF16_TOL: the two round at other points (the tensor-parallel
    partial sums), so they differ about as much as either differs from
    f32, and a tighter limit has no reading to stand on.
    """
    from interactive_vit_tpu.wire.codec import Response

    imgs = [_image(s) for s in range(4)]
    bodies = [maps_request(i) for i in imgs]
    refs = reference_taps(imgs)

    def serve_all(dtype_name, n, **kw):
        with Served(models=(VARIANT,), dtype_name=dtype_name,
                    graphs_dir=state["graphs"], **kw) as srv:
            first = _url(srv.base, "/compute", bodies[0])
            rest = post_concurrently(srv.base, bodies[1:n])
        out = []
        for status, raw, ms in [first] + rest:
            check(status == 200, f"HTTP {status}")
            out.append(split_maps_response(Response.decode(raw)))
            check_maps_taps(*out[-1])
            print(f"  request: {ms:.1f} ms wall incl. compile")
        return out

    print(f"mesh {MESH} (4 GPUs), bf16:")
    mesh16 = serve_all("bfloat16", 4, mesh_spec=MESH)
    print("one device, bf16, same attention path (plain):")
    one16 = serve_all("bfloat16", 4, attn_impl_name="reference")
    print(f"mesh {MESH} (4 GPUs), f32:")
    mesh32 = serve_all("float32", 2, mesh_spec=MESH)
    for k, (m, o) in enumerate(zip(mesh16, one16)):
        for other, err in (("one device bf16", tap_errors(m, o)),
                           ("f32 reference", tap_errors(m, refs[k]))):
            print(f"four: request {k} mesh bf16 vs {other}: max-abs logits "
                  f"{err['logits']:.3e} (scale {err['logits_scale']:.3f}), "
                  f"maps {err['maps']:.3e}, rollout {err['rollout']:.3e} "
                  f"(limits {BF16_TOL})")
            check_bf16(err, f"mesh bf16 request {k} vs {other}")
    for k, m in enumerate(mesh32):
        err = tap_errors(m, refs[k])
        print(f"four: request {k} mesh f32 vs f32 reference: max-abs logits "
              f"{err['logits']:.3e}, maps {err['maps']:.3e}, rollout "
              f"{err['rollout']:.3e} (limit {F32_TOL})")
        check_f32(err, f"mesh f32 request {k}")


PHASES = {"device": phase_device, "serve": phase_serve,
          "parity": phase_parity, "kernels": phase_kernels,
          "four": phase_four}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="serve on a data=2,model=2 mesh of 4 GPUs and "
                         "compare with one device; no other phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import logging

    # each build_app re-registers the builtin kinds; keep the replacement
    # warnings out of the report
    logging.getLogger(f"{PACKAGE}.graph.registry").setLevel(logging.ERROR)
    import jax

    from interactive_vit_tpu.utils import compile_cache

    compile_cache.enable()
    state = {"need_devices": 4 if args.four else 1,
             "graphs": _graphs_copy()}
    try:
        ok = run_phases([(p, PHASES[p]) for p in select_phases(args.four)],
                        state)
    finally:
        shutil.rmtree(state["graphs"], ignore_errors=True)
    if not ok:
        return 1
    devs = jax.devices()
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
