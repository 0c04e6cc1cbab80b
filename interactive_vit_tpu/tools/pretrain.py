"""MAE self-supervised pretraining driver.

    python -m interactive_vit_tpu.tools.pretrain \
        --variant mae_t16 --steps 400 --batch 64 \
        --memorize 256 --export-encoder enc.safetensors --probe

No labels are consumed by the objective (masked reconstruction,
``models/mae.py``); ``--probe`` quantifies the learned features anyway
with a closed-form ridge linear probe on frozen CLS features — the
standard self-supervised evaluation, egress-free (the reference's
pretrained-weight story, ``/root/reference/static/models/vgg16.py:11-14``,
is impossible in this zero-egress image; pretraining replaces it).

Outputs:
  --output DIR              orbax checkpoint (full MAE tree + train state,
                            ``--resume`` continues mid-run)
  --export-encoder FILE     the pretrained trunk as a PLAIN-VIT safetensors
                            checkpoint (native '/' naming) — servable via
                            ``ivt-server --variant <enc> --ckpt FILE`` and
                            the finetune init for ``ivt-train``
  --export-safetensors FILE the full MAE tree (servable reconstruction
                            demo: ``ivt-server --variant mae_* --ckpt``)
"""

from __future__ import annotations

import argparse
import logging
import os
import time

logger = logging.getLogger(__name__)


def linear_probe(features, labels, classes: int, l2: float = 1e-3,
                 train_frac: float = 0.8, seed: int = 0) -> float:
    """Closed-form ridge regression on one-hot labels; HELD-OUT top-1.

    The split matters: with few samples and wide features any frozen
    encoder (random init included) memorizes the fit set, so train-set
    accuracy says nothing — generalization to held-out images is what
    separates learned features. Host numpy on purpose: jnp.linalg solves
    are custom calls with pathological remote-compile behavior on this
    backend (CLAUDE.md trap #7); the [D, D] solve is trivial host work."""
    import numpy as np

    x = np.asarray(features, np.float64)
    y = np.asarray(labels)
    perm = np.random.default_rng(seed).permutation(len(x))
    n_tr = max(classes, int(round(len(x) * train_frac)))
    tr, te = perm[:n_tr], perm[n_tr:]
    if len(te) == 0:
        tr = te = perm  # degenerate tiny sets: report fit accuracy
    onehot = np.eye(classes)[y[tr]]
    d = x.shape[1]
    w = np.linalg.solve(x[tr].T @ x[tr] + l2 * np.eye(d), x[tr].T @ onehot)
    pred = (x[te] @ w).argmax(axis=1)
    return float((pred == y[te]).mean())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variant", default="mae_t16",
                        help="mae_t16/mae_s16/mae_b16, optionally with the "
                             "@<pixels> encoder-resolution suffix")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1.5e-4)
    parser.add_argument("--warmup", type=int, default=0,
                        help="warmup steps (with cosine decay to --steps)")
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--mask-ratio", type=float, default=None,
                        help="override the config's mask ratio (default "
                             "0.75)")
    parser.add_argument("--no-norm-pix", action="store_true",
                        help="raw-pixel targets instead of per-patch "
                             "normalized (the paper's ablation)")
    parser.add_argument("--mesh", default="data=all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "mixed"],
                        help="mixed = f32 master params + bf16 compute "
                             "(f32 AdamW moments; the standard mixed-"
                             "precision recipe — see ivt-train --dtype)")
    parser.add_argument("--remat", default="off",
                        choices=["on", "off", "dots"],
                        help="per-block remat (default off: the 75%%-mask "
                             "encoder is small; turn on for mae_b16-class "
                             "batches that exceed device memory)")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--memorize", type=int, default=256,
                        help="pretrain on a FIXED set of N patterned "
                             "images (egress-free); --data overrides")
    parser.add_argument("--distinct-classes", type=int, default=64,
                        help="pattern classes in the --memorize set (used "
                             "only by --probe)")
    parser.add_argument("--data", default=None, metavar="PREFIX",
                        help="pretrain on {PREFIX}_images.npy via the "
                             "native prefetching loader (labels file is "
                             "read only for --probe)")
    parser.add_argument("--probe", action="store_true",
                        help="after pretraining, report a ridge linear "
                             "probe top-1 on frozen CLS features, next to "
                             "the same probe on a RANDOM-INIT encoder "
                             "(the self-supervised learning evidence)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--save-every", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--export-encoder", default=None)
    parser.add_argument("--export-safetensors", default=None)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--platform", default="default",
                        choices=["default", "cpu"])
    args = parser.parse_args(argv)
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error("--batch must be divisible by --accum-steps")

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import mae
    from interactive_vit_tpu.parallel import mesh as mesh_lib
    from interactive_vit_tpu.parallel import train as train_lib
    from interactive_vit_tpu.tools.train import (
        load_state, pattern_set, save_state,
    )

    cfg = mae.resolve_variant(args.variant)
    if args.no_norm_pix:
        cfg = dataclasses.replace(cfg, norm_pix=False)
    enc_cfg = cfg.enc_cfg
    if args.mesh == "data=all":
        axis_sizes = None
    else:
        axis_sizes = dict(
            (k, int(v)) for k, v in
            (kv.split("=") for kv in args.mesh.split(",")))
    mesh = mesh_lib.make_mesh(axis_sizes)
    logger.info("mesh: %s over %d devices; encoder %s (%d patches, "
                "keep %d)",
                dict(zip(mesh.axis_names, mesh.devices.shape)),
                mesh.devices.size, enc_cfg.name, cfg.num_patches,
                cfg.len_keep(args.mask_ratio))

    optimizer = train_lib.make_optimizer(
        args.lr, wd=args.weight_decay, warmup_steps=args.warmup,
        total_steps=args.steps if args.warmup else 0)
    state_dir = os.path.join(args.output, "state") if args.output else None
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else None
    compute_dtype = jnp.bfloat16 if args.dtype == "mixed" else None
    remat = {"on": True, "off": False, "dots": "dots"}[args.remat]

    with mesh:
        params, opt_state, step_fn = train_lib.setup_sharded_mae(
            cfg, mesh, seed=args.seed, lr=args.lr, remat=remat,
            optimizer=optimizer, dtype=dtype,
            accum_steps=args.accum_steps, mask_ratio=args.mask_ratio,
            compute_dtype=compute_dtype)
        start_step = 0
        if args.resume:
            if not (state_dir and os.path.exists(state_dir)):
                parser.error(f"--resume: no state at {state_dir}")
            params, opt_state, start_step = load_state(
                state_dir, mesh, params, opt_state)
            logger.info("resumed from %s at step %d", state_dir, start_step)

        rng = np.random.default_rng(args.seed + start_step)
        loader = None
        saver = None
        probe_labels = None
        if args.data:
            from interactive_vit_tpu.data.loader import Loader

            loader = Loader(args.data + "_images.npy",
                            args.data + "_labels.npy", args.batch,
                            seed=args.seed, flip=True, borrow=True)
            logger.info("data loader: %d samples", loader.n)
            for _ in range(start_step):
                next(loader)
        else:
            mem_images, probe_labels = pattern_set(
                args.seed, args.memorize, enc_cfg.img_size,
                max(enc_cfg.num_classes, args.distinct_classes),
                args.distinct_classes)
            mem_gather = None
            if mesh.devices.size == 1:
                mem_images_d = jnp.asarray(mem_images)
                mem_gather = jax.jit(lambda xs, i: xs[i])

        base_key = jax.random.key(args.seed + 0xAE)
        t0 = time.perf_counter()
        for step in range(start_step, args.steps):
            if loader is not None:
                images, _labels, _epoch = next(loader)
                images = jnp.asarray(images)
                jax.block_until_ready(images)
            else:
                idx = rng.integers(0, args.memorize, size=(args.batch,))
                if mem_gather is not None:
                    images = mem_gather(mem_images_d,
                                        jnp.asarray(idx.astype(np.int32)))
                else:
                    images = jnp.asarray(mem_images[idx])
            # deterministic per (seed, step): --resume replays the stream
            params, opt_state, loss = step_fn(
                params, opt_state, images,
                jax.random.fold_in(base_key, step))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                logger.info("step %4d  recon loss %.4f  (%.1f imgs/s)",
                            step, float(loss),
                            (step - start_step + 1) * args.batch / dt)
            if (args.save_every and state_dir
                    and (step + 1) % args.save_every == 0):
                if saver is None:
                    from interactive_vit_tpu.utils.checkpoint import (
                        AsyncSaver,
                    )

                    saver = AsyncSaver()
                save_state(state_dir, params, opt_state, step + 1,
                           saver=saver)
                logger.info("async-saving state at step %d", step + 1)
        if loader is not None:
            loader.close()
        if saver is not None:
            saver.close()

        if args.probe:
            if args.data:
                probe_images = np.load(args.data + "_images.npy",
                                       mmap_mode="r")[:2048]
                probe_labels = np.load(args.data + "_labels.npy",
                                       mmap_mode="r")[:2048]
                probe_images = np.asarray(probe_images)
                probe_labels = np.asarray(probe_labels)
            else:
                probe_images = mem_images

            def cls_features(p, imgs):
                feats = []
                enc = jax.jit(lambda pp, im: mae.encode(pp, im, cfg,
                                                        None)[:, 0])
                for i in range(0, len(imgs), args.batch):
                    feats.append(np.asarray(
                        enc(p, jnp.asarray(imgs[i:i + args.batch])),
                        np.float32))
                return np.concatenate(feats)

            classes = int(np.max(probe_labels)) + 1
            acc = linear_probe(cls_features(params, probe_images),
                               probe_labels, classes)
            rand = mae.init_params(jax.random.key(args.seed + 1), cfg,
                                   dtype=dtype or jnp.float32)
            acc0 = linear_probe(cls_features(rand, probe_images),
                                probe_labels, classes)
            logger.info("linear probe top-1: pretrained %.3f vs "
                        "random-init %.3f (%d samples, %d classes)",
                        acc, acc0, len(probe_images), classes)

    if args.output:
        from interactive_vit_tpu.utils.checkpoint import save_params

        save_params(os.path.join(args.output, "params"), params)
        if state_dir:
            save_state(state_dir, params, opt_state, args.steps)
        logger.info("saved checkpoint to %s", args.output)
    if args.export_encoder or args.export_safetensors:
        from interactive_vit_tpu.models.weights import to_native_flat
        from interactive_vit_tpu.utils.safetensors_io import save_file

        host = jax.device_get(params)
        if args.export_encoder:
            save_file(to_native_flat(mae.encoder_params(host)),
                      args.export_encoder)
            logger.info("exported encoder (plain-ViT %s checkpoint) to %s",
                        enc_cfg.name, args.export_encoder)
        if args.export_safetensors:
            save_file(to_native_flat(host), args.export_safetensors)
            logger.info("exported full MAE tree to %s",
                        args.export_safetensors)


if __name__ == "__main__":
    main()
