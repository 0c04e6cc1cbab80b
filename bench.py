"""Throughput benchmark: ViT-B/16 @224 inference with attention-map
extraction.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "imgs/sec/device", "device": {...}}

Protocol: bf16 weights+activations (f32 accumulation — see
ops/layers.mm_precision), want_attn=True so every layer's post-softmax
attention maps AND the attention rollout are extracted, steady-state
timing over --iters batches after a warmup/compile batch. Runs on
whatever backend JAX selects; the device is printed beside the number.

``--ab attn`` (or ``--ab dtype``) compares two settings in one process in
the order A, B, B, A (plain path vs the dispatcher's kernels; int8w8a8 vs
bfloat16), so drift of the card's clock shows as disagreement between the
repeats. ``--profile DIR`` traces three steps after the timing and prints
the device time per kernel name, the busy time and the span:

    python bench.py --variant vit_b16 --batch 96 --iters 30 --ab attn
    python bench.py --variant vit_l16 --batch 16 --iters 30 --ab attn \
        --profile chiprun_out/trace_l16
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

#: --ab: the setting compared and its A, B, B, A order
AB_ORDERS = {"attn": ("attn", ("reference", "auto", "auto", "reference")),
             "dtype": ("dtype_name",
                       ("int8w8a8", "bfloat16", "bfloat16", "int8w8a8"))}


def _forward_gflops(cfg) -> float:
    """Analytic forward GFLOPs/image (mul+add = 2 FLOPs; conv-free ViT):
    patch embed + depth * (qkv/proj GEMMs + attention dots + MLP) + head.
    Attention-map extraction adds no FLOPs (the probs are computed
    anyway); softmax/LN/elementwise are ignored (<1%)."""
    n, d, p, depth = cfg.tokens, cfg.width, cfg.patch, cfg.depth
    mlp = getattr(cfg, "mlp_dim", 4 * d)
    embed = n * (3 * p * p) * d * 2
    per_block = (
        n * d * (3 * d) * 2      # qkv
        + 2 * n * n * d * 2      # scores + probs@V
        + n * d * d * 2          # proj
        + 2 * n * d * mlp * 2    # fc1 + fc2
    )
    head = d * getattr(cfg, "num_classes", 1000) * 2
    return (embed + depth * per_block + head) / 1e9


def card() -> str:
    """``name, power.limit`` as nvidia-smi gives them ("" without it)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return ""


def kernel_times(trace_dir: str, steps: int, top: int = 15) -> dict:
    """Device time per kernel name from a ``jax.profiler`` trace: sums the
    events on the GPU planes' stream lines. -> {"busy_ms", "span_ms",
    "kernels_ms": {name: ms}}, each per step."""
    import glob

    import jax

    pb = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    tot = collections.Counter()
    lo, hi = float("inf"), 0
    for plane in jax.profiler.ProfileData.from_file(pb).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
                lo = min(lo, ev.start_ns)
                hi = max(hi, ev.start_ns + ev.duration_ns)
    per_step = lambda ns: ns / 1e6 / steps  # noqa: E731
    return {"busy_ms": per_step(sum(tot.values())),
            "span_ms": per_step(max(hi - lo, 0)),
            "kernels_ms": {k: per_step(v) for k, v in tot.most_common(top)}}


def measure(variant: str = "vit_b16", dtype_name: str = "bfloat16",
            batches=(32, 64, 96, 128), iters: int = 20,
            want_attn: bool = True, attn: str = "auto",
            profile_dir: str = None) -> dict:
    """One throughput measurement over a batch sweep.

    Returns {"imgs_per_s", "best_batch", "per_batch", "ms_per_batch",
    "gflops_per_img"}, plus "trace" (``kernel_times`` of three steps at
    the last batch) with ``profile_dir``. The caller owns
    compilation-cache setup.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.ops.dispatch import default_attn_impl

    cfg = vit.VARIANTS[variant]
    dtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    params = vit.init_params(jax.random.key(0), cfg, dtype=dtype)
    if dtype_name == "int8w8a8":
        from interactive_vit_tpu.ops.quant import quantize_tree

        params = quantize_tree(params, names=frozenset({"fc1_w", "fc2_w"}),
                               mode="w8a8")
    attn_impl = default_attn_impl(attn)

    def fn(params, images):
        out = vit.forward(params, images, cfg, want_attn=want_attn,
                          attn_impl=attn_impl)
        if want_attn:
            return out["logits"], out["attn"], out["rollout"]
        return out["logits"]

    jitted = jax.jit(fn)
    per_batch = {}
    for batch in batches:
        images = jnp.asarray(
            np.random.default_rng(0).random(
                (batch, 3, cfg.img_size, cfg.img_size), dtype=np.float32),
            dtype=dtype)
        out = jitted(params, images)  # compile + warmup
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = jitted(params, images)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        per_batch[batch] = batch * iters / dt
        print(f"  {variant} batch={batch}: {per_batch[batch]:.1f} imgs/s "
              f"({dt / iters * 1e3:.2f} ms/batch)", file=sys.stderr)
    best_batch = max(per_batch, key=per_batch.get)
    best = per_batch[best_batch]
    res = {"imgs_per_s": best, "best_batch": best_batch,
           "per_batch": {str(k): v for k, v in per_batch.items()},
           "ms_per_batch": best_batch / best * 1e3,
           "gflops_per_img": _forward_gflops(cfg)}
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            for _ in range(3):
                out = jitted(params, images)
            jax.block_until_ready(out)
        res["trace"] = kernel_times(profile_dir, 3)
    return res


def ab_runs(ab: str, variant: str, dtype_name: str, attn: str) -> list:
    """The ``measure`` keyword sets of one ``--ab`` comparison, in order."""
    key, order = AB_ORDERS[ab]
    base = {"variant": variant, "dtype_name": dtype_name, "attn": attn}
    return [dict(base, **{key: value}) for value in order]


def main() -> None:
    from interactive_vit_tpu.ops.dispatch import POLICIES

    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="vit_b16")
    parser.add_argument("--batch", type=int, default=0,
                        help="batch size; 0 (default) = sweep "
                             "{32,64,96,128} and report the best")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32", "int8w8a8"],
                        help="int8w8a8: dynamic-activation int8 MLP "
                             "matmuls over bf16 — opt-in measurement")
    parser.add_argument("--attn", default="auto", choices=list(POLICIES))
    parser.add_argument("--no-attn-maps", action="store_true",
                        help="pure classification (not the headline config)")
    parser.add_argument("--ab", choices=sorted(AB_ORDERS),
                        help="compare two settings in the order A, B, B, A "
                             "(needs --batch)")
    parser.add_argument("--profile", metavar="DIR",
                        help="trace three steps of each run after timing "
                             "(DIR, DIR.1, ...) and print device ms per "
                             "kernel")
    args = parser.parse_args()
    if args.ab and not args.batch:
        parser.error("--ab needs --batch")

    import jax

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.utils import compile_cache

    compile_cache.enable()
    want_attn = not args.no_attn_maps
    batches = [args.batch] if args.batch else [32, 64, 96, 128]
    cfg = vit.VARIANTS[args.variant]
    dev = jax.devices()[0]
    if args.ab:
        runs = []
        for i, kw in enumerate(ab_runs(args.ab, args.variant, args.dtype,
                                       args.attn)):
            prof = args.profile and (
                args.profile + (f".{i}" if i else ""))
            r = measure(batches=batches, iters=args.iters,
                        want_attn=want_attn, profile_dir=prof, **kw)
            runs.append(dict(kw, **r))
            print(json.dumps(runs[-1]), flush=True)
        print(json.dumps({
            "ab": args.ab, "variant": args.variant, "batch": args.batch,
            "want_attn": want_attn, "card": card(),
            "imgs_per_s": [[r[AB_ORDERS[args.ab][0]], r["imgs_per_s"]]
                           for r in runs],
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        }))
        return
    res = measure(args.variant, args.dtype, batches, args.iters,
                  want_attn=want_attn, attn=args.attn,
                  profile_dir=args.profile)
    if "trace" in res:
        print(json.dumps(res["trace"]), file=sys.stderr)
    print(json.dumps({
        "metric": f"{args.variant} @{cfg.img_size} inference w/ "
                  f"{'full attention-map extraction' if want_attn else 'no taps'}"
                  f" ({args.dtype}, attn={args.attn})",
        "value": res["imgs_per_s"],
        "unit": "imgs/sec/device",
        "best_batch": res["best_batch"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
