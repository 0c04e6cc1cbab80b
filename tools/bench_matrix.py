"""Multi-config compute bench: every BASELINE compute config in one run.

    1. vit_t16 @224  — interactive path: batch-1 maps-on latency
    2. vit_b16 @224  — bf16 maps-on sweep (same protocol as bench.py)
    3. vit_l16 @384  — maps-on AND maps-off sweeps (N=577)
    4. clip_b32 @224 — embedding-extraction path

Config 5 (concurrent serving) is ``bench_serving.py``. Prints one JSON
document, with the device it ran on, to stdout:

    make bench-matrix          # = python tools/bench_matrix.py
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import bench  # noqa: E402 — the headline protocol (measure)

ITERS = int(os.environ.get("BENCH_ITERS", "20"))


def clip_gflops(cfg) -> float:
    """Analytic forward GFLOPs/image for the CLIP vision tower: same
    block math as ViT, head = CLS projection to the embedding dim."""
    n, d, p, depth = cfg.tokens, cfg.width, cfg.patch, cfg.depth
    mlp = cfg.mlp_dim
    embed = n * (3 * p * p) * d * 2
    per_block = (n * d * (3 * d) * 2 + 2 * n * n * d * 2
                 + n * d * d * 2 + 2 * n * d * mlp * 2)
    head = d * cfg.embed_dim * 2
    return (embed + depth * per_block + head) / 1e9


def bench_clip(batches=(32, 64, 128)) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import clip

    cfg = clip.CLIPVisionConfig()
    params = clip.init_params(jax.random.key(0), cfg, dtype=jnp.bfloat16)

    def fn(params, images):
        return clip.forward(params, images, cfg)["embedding"]

    per_batch = {}
    for batch in batches:
        images = jnp.asarray(np.random.default_rng(0).random(
            (batch, 3, cfg.img_size, cfg.img_size), dtype=np.float32),
            dtype=jnp.bfloat16)
        jitted = jax.jit(fn)
        jax.block_until_ready(jitted(params, images))
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = jitted(params, images)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        per_batch[batch] = batch * ITERS / dt
        print(f"  clip_b32 batch={batch}: {per_batch[batch]:.1f} imgs/s",
              file=sys.stderr)
    best_batch = max(per_batch, key=per_batch.get)
    return {"imgs_per_s": per_batch[best_batch], "best_batch": best_batch,
            "per_batch": {str(k): v for k, v in per_batch.items()},
            "gflops_per_img": clip_gflops(cfg)}


def main() -> int:
    import jax

    from interactive_vit_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    rows = {}
    t_all = time.time()

    # config 1: the interactive path — batch-1 maps-on latency
    t0 = time.time()
    r = bench.measure("vit_t16", "bfloat16", batches=(1,), iters=50,
                      want_attn=True)
    rows["vit_t16_latency"] = {
        "config": "1: vit_t16 @224 batch-1 classify + per-layer "
                  "attention-map dump",
        "ms_per_image": r["ms_per_batch"],
        "imgs_per_s": r["imgs_per_s"], "wall_s": round(time.time() - t0, 1)}

    # config 2: the headline (same protocol as bench.py)
    t0 = time.time()
    r = bench.measure("vit_b16", "bfloat16", iters=ITERS, want_attn=True)
    rows["vit_b16_headline"] = {
        "config": "2: vit_b16 @224 bf16 maps-on (headline)",
        **{k: r[k] for k in ("imgs_per_s", "best_batch", "per_batch")},
        "wall_s": round(time.time() - t0, 1)}

    # config 3: N=577, maps-on and maps-off sweeps
    t0 = time.time()
    r = bench.measure("vit_l16", "bfloat16", batches=(8, 16, 32),
                      iters=ITERS, want_attn=True)
    rows["vit_l16_maps"] = {
        "config": "3a: vit_l16 @384 bf16 maps-on",
        **{k: r[k] for k in ("imgs_per_s", "best_batch", "per_batch")},
        "wall_s": round(time.time() - t0, 1)}
    t0 = time.time()
    r = bench.measure("vit_l16", "bfloat16", batches=(16, 32, 48),
                      iters=ITERS, want_attn=False)
    rows["vit_l16_nomaps"] = {
        "config": "3b: vit_l16 @384 bf16 maps-off",
        **{k: r[k] for k in ("imgs_per_s", "best_batch", "per_batch")},
        "wall_s": round(time.time() - t0, 1)}

    # config 4: CLIP embedding extraction
    t0 = time.time()
    r = bench_clip()
    rows["clip_b32_embed"] = {
        "config": "4: clip_b32 @224 bf16 embedding extraction",
        **{k: r[k] for k in ("imgs_per_s", "best_batch", "per_batch")},
        "wall_s": round(time.time() - t0, 1)}

    doc = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "iters": ITERS, "configs": rows,
           "wall_s": round(time.time() - t_all, 1)}
    print(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
