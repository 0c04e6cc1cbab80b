"""Training driver: sharded ViT training with step checkpointing/resume.

    python -m interactive_vit_tpu.tools.train \
        --variant vit_t16 --steps 100 --batch 64 \
        --mesh data=4,model=2 --output ckpts/vit_t16 --save-every 50

Data is synthetic (deterministic class-conditional Gaussian blobs — this
environment has no dataset and no egress); the point is the full sharded
training path: DP x TP mesh, rematerialized backward, optax AdamW with
warmup+cosine and global-norm clipping, orbax train-state checkpoints
(params + optimizer state + step) with ``--resume`` picking up mid-run —
the elastic-recovery story SURVEY.md §5 requires beyond the reference's
topology-JSON-only checkpointing. Swap ``synthetic_batch`` for a real
loader in deployment.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

logger = logging.getLogger(__name__)


def synthetic_batch(rng, batch: int, img: int, classes: int):
    import numpy as np

    labels = rng.integers(0, classes, size=(batch,))
    # class-conditional means so the loss actually has signal to learn
    means = (labels[:, None, None, None] / classes).astype(np.float32)
    images = (rng.normal(size=(batch, 3, img, img)).astype(np.float32) * 0.3
              + means)
    return images, labels


def pattern_set(seed: int, n: int, img: int, classes: int,
                distinct: int = 64):
    """A FIXED labeled set of class-conditional sinusoid patterns.

    The memorization oracle's data (VERDICT r2 #4): each class gets a
    distinct separable 2-D grating + per-image noise, so a ViT can reach
    ~100% top-1 on the set in a few hundred steps — which proves the
    whole train -> export -> convert -> serve -> wire path classifies,
    with zero egress. Labels span ``min(classes, distinct)`` classes of
    the model's label space."""
    import numpy as np

    rng = np.random.default_rng(seed)
    distinct = min(classes, distinct)
    labels = np.concatenate([np.arange(distinct),
                             rng.integers(0, distinct, size=(max(0, n - distinct),))])[:n]
    yy, xx = np.meshgrid(np.arange(img), np.arange(img), indexing="ij")
    images = np.empty((n, 3, img, img), np.float32)
    for i, lab in enumerate(labels):
        lab = int(lab)
        fx = 1 + (lab * 7) % 13
        fy = 1 + (lab * 11) % 13
        base = (np.sin(2 * np.pi * fx * xx / img + lab)
                * np.cos(2 * np.pi * fy * yy / img))
        chan = 0.5 + 0.5 * np.eye(3, dtype=np.float32)[lab % 3]
        images[i] = base[None] * chan[:, None, None]
        images[i] += rng.normal(size=(3, img, img)).astype(np.float32) * 0.05
    return images, labels.astype(np.int64)


def evaluate(infer_fn, params, images, labels, batch: int) -> float:
    """Top-1 over a set, in training-batch-size chunks.

    ``infer_fn`` was jitted with data-sharded in_shardings, so each chunk
    must keep the TRAINING batch size (which provably divides the mesh
    "data" axis — training ran with it); an arbitrary set size fed whole
    would fail pjit's divisibility check and compile a fresh program per
    set size. The chunk/pad math is ``tools.evaluate.run_eval`` — one
    copy shared with the ivt-eval CLI."""
    from interactive_vit_tpu.tools.evaluate import run_eval

    def chunks():
        for lo in range(0, len(labels), batch):
            yield images[lo:lo + batch], labels[lo:lo + batch]

    n, hits1, _ = run_eval(infer_fn, params, chunks(), batch, top_k=1)
    return hits1 / n


def make_ema_update(decay: float):
    """Jitted params-EMA step: ``ema = decay*ema + (1-decay)*params``.

    The standard eval/serving-weights average (DeiT/timm ``--model-ema``
    recipe). Runs as its own tiny fused elementwise program per step —
    keeping it out of ``make_train_step`` leaves the step's donation
    contract and every existing checkpoint structure unchanged. Float
    leaves only (int leaves — quantization scales etc. — pass through).

    The EMA tree must be float32 even for bf16 training: bf16 rounds
    0.9999 to 1.0 and swallows the (1-decay) increment entirely — a
    bf16 average provably never moves. The caller seeds it f32
    (``_seed_ema``) and casts back to the param dtype only at export."""
    import jax
    import jax.numpy as jnp

    def update(ema, params):
        return jax.tree.map(
            lambda e, p: (e * decay + p.astype(e.dtype) * (1.0 - decay))
            if jnp.issubdtype(e.dtype, jnp.floating) else p,
            ema, params)

    return jax.jit(update, donate_argnums=0)


def _seed_ema(params):
    """Fresh EMA tree from params: float leaves upcast to f32 (see
    ``make_ema_update`` — a bf16 average cannot represent the decay)."""
    import jax
    import jax.numpy as jnp

    # jnp.array(copy=True): astype(f32) on f32 params is a NO-COPY alias,
    # and the train step DONATES the param buffers — an aliased EMA would
    # reference deleted arrays one step later
    return jax.tree.map(
        lambda p: jnp.array(p, jnp.float32, copy=True)
        if jnp.issubdtype(p.dtype, jnp.floating) else jnp.copy(p), params)


def merge_pretrained(params, tree, cfg, head_major: bool = False):
    """Merge a converted (torch-layout) pretrained ViT tree into freshly
    initialized sharded params — the SSL finetune init.

    Trunk keys whose structure+shapes match load onto each target leaf's
    existing sharding and dtype; everything else (typically the classifier
    head — MAE encoder exports are headless feature extractors, and a
    supervised checkpoint's head won't match a different label space)
    keeps the fresh init. The tree is geometry-adapted first
    (``vit.adapt_checkpoint``: pos-table resample + PI patch-kernel
    resize) and qkv columns are repacked head-major when this run's
    layout wants it (``wants_head_major``).

    Returns ``(merged_params, loaded_keys, skipped_keys)``; raises if the
    trunk itself didn't load (wrong checkpoint for the model)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.parallel import mesh as mesh_lib

    tree = vit.adapt_checkpoint(tree, cfg)
    if head_major:
        tree = mesh_lib.permute_qkv_head_major(tree, cfg.heads)
    merged = dict(params)
    loaded, skipped = [], []
    for key, new in tree.items():
        old = merged.get(key)
        if old is None:
            skipped.append(key)
            continue
        try:
            compatible = (
                jax.tree.structure(new) == jax.tree.structure(old)
                and all(getattr(n, "shape", None) == o.shape
                        for n, o in zip(jax.tree.leaves(new),
                                        jax.tree.leaves(old))))
        except (TypeError, ValueError):
            compatible = False
        if not compatible or not jax.tree.leaves(new):
            # empty subtrees ({} heads) carry no weights: nothing to load
            (skipped if not compatible else loaded).append(key)
            continue
        merged[key] = jax.tree.map(
            lambda n, o: jax.device_put(
                jnp.asarray(np.asarray(n), o.dtype), o.sharding),
            new, old)
        loaded.append(key)
    if "blocks" not in loaded:
        raise ValueError(
            f"--init checkpoint does not match {cfg.name}: the block "
            f"trunk failed to load (loaded={loaded}, skipped={skipped}) "
            f"— wrong variant or depth?")
    return merged, loaded, skipped


def init_from_checkpoint(path: str, params, cfg, variant: str,
                         head_major: bool):
    """CLI leg of ``merge_pretrained``: load + layout-convert ``path``
    (safetensors or torch .pth, layout auto-detected) and merge its trunk
    into ``params``. This is how ``ivt-pretrain --export-encoder``
    checkpoints become finetune inits:

        ivt-pretrain --variant mae_s16 ... --export-encoder enc.safetensors
        ivt-train --variant vit_s16 --init enc.safetensors ...
    """
    from interactive_vit_tpu.tools.convert import convert, load_state_dict

    sd = load_state_dict(path)
    tree = convert(variant, "auto", sd)
    return merge_pretrained(params, tree, cfg, head_major)


def save_state(path: str, params, opt_state, step: int,
               saver=None, head_major: bool = False, ema=None) -> None:
    """Train-state checkpoint: params + optimizer state + step counter,
    one orbax tree (all plain pytrees of arrays). Pass an
    ``utils.checkpoint.AsyncSaver`` to overlap the write with the next
    interval's steps (mid-run checkpoints); the final save stays
    blocking.

    ``head_major`` records the qkv column layout the params are stored
    in (``wants_head_major``: TP sharding). Resume validates it — the
    layout depends on the --mesh flag, so a flag change between save and
    resume would otherwise load permuted qkv columns into same-shape
    avals SILENTLY."""
    import jax.numpy as jnp

    from interactive_vit_tpu.utils.checkpoint import save_params

    tree = {"params": params, "opt_state": opt_state,
            "step": jnp.asarray(step),
            "qkv_head_major": jnp.asarray(int(head_major))}
    if ema is not None:
        tree["ema"] = ema
    if saver is not None:
        saver.save(path, tree)
    else:
        save_params(path, tree)


def load_state(path: str, mesh, like_params, like_opt_state,
               expect_head_major=None, want_ema: bool = False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from interactive_vit_tpu.utils.checkpoint import load_params, state_keys

    # build `like` to match what the checkpoint ACTUALLY stores (orbax
    # metadata, no data read): the layout marker and the EMA subtree are
    # both optional — they follow the writing run's flags, and resuming
    # with different flags must degrade cleanly, not die in an orbax
    # structure error
    saved = state_keys(path)
    like = {"params": like_params, "opt_state": like_opt_state,
            "step": jnp.asarray(0)}
    if "qkv_head_major" in saved:
        like["qkv_head_major"] = jnp.asarray(0)
    if "ema" in saved:
        # EMA accumulates in f32 regardless of the param dtype
        # (bf16(0.9999) == 1.0 — a bf16 average never moves); shardings
        # mirror the params so TP-sharded leaves restore in place
        like["ema"] = jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(
                p.shape,
                jnp.float32 if jnp.issubdtype(p.dtype, jnp.floating)
                else p.dtype,
                sharding=getattr(p, "sharding", None)),
            like_params)
    st = load_params(path, like=like)
    saved_hm = (bool(int(st.pop("qkv_head_major")))
                if "qkv_head_major" in saved else None)
    if "qkv_head_major" in saved:
        del like["qkv_head_major"]  # keep st/like tree structures equal
    if (expect_head_major is not None and saved_hm is not None
            and saved_hm != bool(expect_head_major)):
        raise ValueError(
            f"--resume layout mismatch: checkpoint at {path} stores qkv "
            f"{'head-major' if saved_hm else 'torch-layout'} columns but "
            f"this run resolves to "
            f"{'head-major' if expect_head_major else 'torch-layout'} "
            f"(the layout follows --mesh/--attn/--dtype/platform via "
            f"wants_head_major). Resume with the original flags, or "
            f"export via --export-safetensors and restart from --ckpt.")
    # Orbax restores leaves COMMITTED to their saved placement; optimizer
    # scalars (e.g. adam `count`) were uncommitted single-device at save
    # time, so the restored tree mixes single-device and mesh-wide leaves
    # and jit refuses the device mismatch (fresh uncommitted scalars get
    # moved automatically; committed ones don't). Re-place every leaf:
    # keep multi-device shardings from the like tree, replicate the rest
    # over the full mesh.
    repl = NamedSharding(mesh, PartitionSpec())

    def place(x, l):
        sh = getattr(l, "sharding", None)
        if sh is not None and getattr(sh, "num_devices", 1) > 1:
            return jax.device_put(x, sh)
        return jax.device_put(x, repl)

    st = jax.tree.map(place, st, like)
    if want_ema:
        # None when the checkpoint predates --ema-decay: caller re-seeds
        return (st["params"], st["opt_state"], int(st["step"]),
                st.get("ema"))
    return st["params"], st["opt_state"], int(st["step"])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variant", default="vit_t16")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup", type=int, default=0,
                        help="warmup steps (with cosine decay to --steps)")
    parser.add_argument("--clip-norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--llrd", type=float, default=0.0,
                        help="layer-wise LR decay (the BEiT/MAE finetune "
                             "recipe): block j of L trains at "
                             "lr*llrd^(L-j), the embedding tier at "
                             "lr*llrd^(L+1), head/final-norm at full lr. "
                             "0 = uniform; 0.65-0.75 is the standard "
                             "finetune range (pair with --init)")
    parser.add_argument("--mesh", default="data=all",
                        help="e.g. data=4,model=2; 'data=all' = pure DP")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-remat", action="store_true",
                        help="(deprecated) same as --remat off")
    parser.add_argument("--remat", default="auto",
                        choices=["auto", "on", "off", "dots"],
                        help="per-block rematerialization; auto keeps it "
                             "OFF when the backward's activations fit the "
                             "device's memory (remat costs an extra "
                             "forward); dots = "
                             "save matmul outputs, recompute elementwise "
                             "(jax.checkpoint dots_with_no_batch_dims)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "mixed"],
                        help="float32 = the parity default; bfloat16 = "
                             "pure-bf16 params+compute (fastest, but "
                             "AdamW moments and updates are bf16 too); "
                             "mixed = f32 MASTER params + bf16 "
                             "forward/backward — the standard mixed-"
                             "precision recipe: f32 optimizer moments, "
                             "sub-ulp updates accumulate, bf16 tensor-"
                             "core throughput")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: split each batch "
                             "into k sequential microbatches (one "
                             "optimizer update, f32 grad accumulation) "
                             "— effective batches beyond device memory without "
                             "remat's extra forward")
    parser.add_argument("--output", default=None,
                        help="orbax checkpoint dir (final weights + "
                             "train state)")
    parser.add_argument("--save-every", type=int, default=0,
                        help="also checkpoint the train state every N steps")
    parser.add_argument("--resume", action="store_true",
                        help="restore train state from --output/state and "
                             "continue at the saved step (pass the SAME "
                             "--warmup/--clip-norm/--llrd as the original "
                             "run — they define the optimizer-state "
                             "structure)")
    parser.add_argument("--init", default=None, metavar="FILE",
                        help="initialize the trunk from a checkpoint "
                             "(safetensors or .pth, layout auto-detected) "
                             "— e.g. an ivt-pretrain --export-encoder MAE "
                             "encoder. Matching trunk keys load (geometry-"
                             "adapted); the classifier head stays fresh "
                             "when absent or label-space-incompatible. "
                             "Plain-ViT family only. Mutually exclusive "
                             "with --resume (which restores the FULL "
                             "train state)")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="top-1 accuracy on a held-out synthetic batch "
                             "every N steps")
    parser.add_argument("--memorize", type=int, default=0,
                        help="train on a FIXED set of N patterned images "
                             "(the end-to-end accuracy oracle) instead of "
                             "streaming synthetic batches; eval runs on "
                             "the whole set")
    parser.add_argument("--distinct-classes", type=int, default=64,
                        help="distinct labels in the --memorize set")
    parser.add_argument("--export-safetensors", default=None,
                        help="also write final params as a .safetensors "
                             "file in the native '/' naming (servable via "
                             "--ckpt, auto-detected layout)")
    parser.add_argument("--data", default=None, metavar="PREFIX",
                        help="train on {PREFIX}_images.npy/_labels.npy via "
                             "the native prefetching loader (data/loader.py)"
                             " instead of synthetic batches; augments with "
                             "deterministic horizontal flips")
    parser.add_argument("--hflip", action="store_true",
                        help="random horizontal flips (on device, jitted — "
                             "data/augment.py; the --data loader's own "
                             "deterministic flip is independent)")
    parser.add_argument("--crop-pad", type=int, default=0,
                        help="zero-pad N px per side + random same-size "
                             "crop (shift augmentation)")
    parser.add_argument("--color-jitter", type=float, default=0.0,
                        help="brightness/contrast/saturation jitter "
                             "strength s (factors from U[1-s, 1+s])")
    parser.add_argument("--cutout", type=int, default=0,
                        help="zero-fill a random NxN square per image")
    parser.add_argument("--mixup", type=float, default=0.0,
                        help="mixup Beta(a,a) alpha (0 = off); emits soft "
                             "labels")
    parser.add_argument("--cutmix", type=float, default=0.0,
                        help="cutmix Beta(a,a) alpha (0 = off); with "
                             "--mixup, one of the two is chosen per step")
    parser.add_argument("--label-smoothing", type=float, default=0.0,
                        help="uniform label smoothing in the loss")
    parser.add_argument("--distill-teacher", default=None, metavar="FILE",
                        help="knowledge distillation (DeiT recipe): a "
                             "FROZEN teacher checkpoint whose predictions "
                             "supervise the student's distillation head "
                             "(token 1). Student must be a distilled "
                             "variant (deit_*). Requires "
                             "--teacher-variant")
    parser.add_argument("--teacher-variant", default=None,
                        help="the teacher checkpoint's variant name (any "
                             "trainable family; same resolution and "
                             "label space as the student)")
    parser.add_argument("--distill-alpha", type=float, default=0.5,
                        help="distillation-loss weight: loss = "
                             "(1-a)*CE(cls, labels) + a*distill")
    parser.add_argument("--distill-tau", type=float, default=0.0,
                        help="0 = hard distillation (CE vs the teacher's "
                             "argmax, the DeiT-recommended recipe); >0 = "
                             "soft (temperature-tau KL, scaled tau^2)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="keep an exponential moving average of the "
                             "params (the DeiT/timm model-EMA recipe, "
                             "e.g. 0.9999); evals, --output params and "
                             "--export-safetensors then use the EMA "
                             "weights (0 = off)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--platform", default="default",
                        choices=["default", "cpu"],
                        help="cpu = in-process CPU backend override")
    args = parser.parse_args(argv)
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error("--batch must be divisible by --accum-steps")
    if args.data and args.memorize:
        parser.error("--data and --memorize are mutually exclusive "
                     "(the loader stream would silently win)")
    if args.init and args.resume:
        parser.error("--init and --resume are mutually exclusive: "
                     "--resume restores the full train state, --init "
                     "seeds a FRESH run from pretrained weights")
    if bool(args.distill_teacher) != bool(args.teacher_variant):
        parser.error("--distill-teacher and --teacher-variant go "
                     "together")

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.parallel import mesh as mesh_lib
    from interactive_vit_tpu.parallel import train as train_lib

    def resolve_cfg(variant: str):
        if variant.partition("@")[0] in vit.VARIANTS:
            # @<pixels>/@p<patch> = train/fine-tune at a derived geometry
            return vit.resolve_variant(variant)
        if variant.startswith("swin_"):
            from interactive_vit_tpu.models import swin

            return swin.VARIANTS[variant]
        if variant.startswith("convnext_"):
            from interactive_vit_tpu.models import convnext

            return convnext.VARIANTS[variant]
        from interactive_vit_tpu.models import moe

        return moe.VARIANTS[variant]

    cfg = resolve_cfg(args.variant)
    if args.mesh == "data=all":
        axis_sizes = None
    else:
        axis_sizes = dict(
            (k, int(v)) for k, v in
            (kv.split("=") for kv in args.mesh.split(","))
        )
    mesh = mesh_lib.make_mesh(axis_sizes)
    logger.info("mesh: %s over %d devices",
                dict(zip(mesh.axis_names, mesh.devices.shape)),
                mesh.devices.size)

    optimizer = train_lib.make_optimizer(
        args.lr, warmup_steps=args.warmup,
        total_steps=args.steps if args.warmup else 0,
        clip_norm=args.clip_norm, llrd=args.llrd)
    state_dir = os.path.join(args.output, "state") if args.output else None

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else None
    compute_dtype = jnp.bfloat16 if args.dtype == "mixed" else None
    # training differentiates the plain attention path (XLA autodiff)
    attn_impl = None
    if args.no_remat or args.remat == "off":
        remat = False
    elif args.remat == "on":
        remat = True
    elif args.remat == "dots":
        remat = "dots"
    else:
        data_ax = dict(zip(mesh.axis_names, mesh.devices.shape)
                       ).get("data", 1)
        remat = train_lib.auto_remat(
            cfg, max(1, args.batch // max(1, data_ax) // args.accum_steps),
            dtype=compute_dtype or dtype or jnp.float32)
        logger.info("remat auto -> %s", "on" if remat else "off")

    head_major = train_lib.wants_head_major(cfg, mesh)
    from interactive_vit_tpu.data.augment import (
        AugmentConfig, make_augment_fn,
    )

    aug_cfg = AugmentConfig(
        hflip=args.hflip, crop_pad=args.crop_pad,
        color_jitter=args.color_jitter, cutout=args.cutout,
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix)
    with mesh:
        if args.distill_teacher:
            from interactive_vit_tpu.tools.convert import (
                convert, load_state_dict,
            )

            teacher_cfg = resolve_cfg(args.teacher_variant)
            teacher_params = convert(args.teacher_variant, "auto",
                                     load_state_dict(args.distill_teacher))
            logger.info("distillation: frozen %s teacher from %s "
                        "(alpha=%g, %s)", args.teacher_variant,
                        args.distill_teacher, args.distill_alpha,
                        f"soft tau={args.distill_tau}"
                        if args.distill_tau > 0 else "hard")
            params, opt_state, step_fn, infer_fn = (
                train_lib.setup_sharded_distill(
                    cfg, teacher_cfg, teacher_params, mesh,
                    seed=args.seed, lr=args.lr, remat=remat,
                    optimizer=optimizer, dtype=dtype, attn_impl=attn_impl,
                    accum_steps=args.accum_steps,
                    alpha=args.distill_alpha, tau=args.distill_tau,
                    label_smoothing=args.label_smoothing,
                    compute_dtype=compute_dtype))
        else:
            params, opt_state, step_fn, infer_fn = train_lib.setup_sharded(
                cfg, mesh, seed=args.seed, lr=args.lr,
                remat=remat, optimizer=optimizer, dtype=dtype,
                attn_impl=attn_impl, accum_steps=args.accum_steps,
                label_smoothing=args.label_smoothing,
                compute_dtype=compute_dtype,
            )
        aug_fn = make_augment_fn(
            aug_cfg, cfg.num_classes,
            base_key=jax.random.key(args.seed + 0x5EED),
            batch_sharding=mesh_lib.batch_sharding(mesh))
        if aug_fn is not None:
            logger.info("augment: %s", aug_cfg)
        if args.init:
            if args.variant.partition("@")[0] not in vit.VARIANTS:
                parser.error("--init supports the plain-ViT family only "
                             "(vit_*/deit_*/dino* variants)")
            params, loaded, skipped = init_from_checkpoint(
                args.init, params, cfg, args.variant, head_major)
            logger.info("initialized from %s: loaded %s%s", args.init,
                        loaded,
                        f", fresh {skipped}" if skipped else "")
        start_step = 0
        ema = None
        ema_update = (make_ema_update(args.ema_decay)
                      if args.ema_decay else None)
        if args.resume:
            if not (state_dir and os.path.exists(state_dir)):
                parser.error(f"--resume: no state at {state_dir}")
            if args.ema_decay:
                params, opt_state, start_step, ema = load_state(
                    state_dir, mesh, params, opt_state,
                    expect_head_major=head_major, want_ema=True)
                if ema is None:
                    logger.info("checkpoint has no EMA state; seeding "
                                "the average from the restored params")
            else:
                params, opt_state, start_step = load_state(
                    state_dir, mesh, params, opt_state,
                    expect_head_major=head_major)
            logger.info("resumed from %s at step %d", state_dir, start_step)
        if args.ema_decay and ema is None:
            ema = _seed_ema(params)

        rng = np.random.default_rng(args.seed + start_step)
        loader = None
        saver = None  # lazy AsyncSaver for mid-run checkpoints
        if args.data:
            from interactive_vit_tpu.data.loader import Loader

            # borrow=True: batches view the prefetch ring (zero host
            # copies); the step consumes them via jnp.asarray before the
            # next iteration, which is exactly the borrow contract
            loader = Loader(args.data + "_images.npy",
                            args.data + "_labels.npy", args.batch,
                            seed=args.seed, flip=True, borrow=True)
            logger.info("data loader: %d samples, %s backend",
                        loader.n, "native" if loader.native else "numpy")
            # NOTE: a smoke metric over the TRAINING stream (these
            # samples re-enter training after epoch 0) — a genuinely
            # held-out eval needs a separate --data prefix. np.array:
            # borrowed views die at the next batch.
            ev = next(loader)
            eval_images, eval_labels = np.array(ev[0]), np.array(ev[1])
            # resume reproducibility: skip the batches the original run
            # already consumed so the resumed stream continues where the
            # uninterrupted run would be
            for _ in range(start_step):
                next(loader)
        elif args.memorize:
            mem_images, mem_labels = pattern_set(
                args.seed, args.memorize, cfg.img_size, cfg.num_classes,
                args.distinct_classes)
            eval_images, eval_labels = mem_images, mem_labels
            # single device: park the memorize set ON DEVICE once and
            # gather batches there — per-step host->device traffic drops
            # from the full image batch (77 MB for vit_s16@128) to one
            # index vector. Mesh runs keep the
            # host path (batches must arrive data-sharded).
            mem_gather = None
            if mesh.devices.size == 1:
                mem_images_d = jnp.asarray(mem_images)
                mem_labels_d = jnp.asarray(mem_labels)
                mem_gather = jax.jit(lambda xs, ys, i: (xs[i], ys[i]))
        else:
            eval_images, eval_labels = synthetic_batch(
                np.random.default_rng(10_007), args.batch, cfg.img_size,
                cfg.num_classes)
        t0 = time.perf_counter()
        for step in range(start_step, args.steps):
            if loader is not None:
                images, labels, _epoch = next(loader)
                # borrow contract: the slot is recycled at the NEXT
                # next(), but jnp.asarray's host->device copy is ASYNC —
                # place and BLOCK here so a prefetch worker can't
                # overwrite bytes an in-flight transfer is still reading
                images = jnp.asarray(images)
                labels = jnp.asarray(labels)
                import jax as _jax

                _jax.block_until_ready((images, labels))
            elif args.memorize:
                idx = rng.integers(0, args.memorize, size=(args.batch,))
                if mem_gather is not None:
                    images, labels = mem_gather(
                        mem_images_d, mem_labels_d,
                        jnp.asarray(idx.astype(np.int32)))
                else:
                    images, labels = mem_images[idx], mem_labels[idx]
            else:
                images, labels = synthetic_batch(
                    rng, args.batch, cfg.img_size, cfg.num_classes
                )
            images, labels = jnp.asarray(images), jnp.asarray(labels)
            if aug_fn is not None:
                # deterministic per (seed, step): resume replays the stream
                images, labels = aug_fn(step, images, labels)
            params, opt_state, loss = step_fn(
                params, opt_state, images, labels
            )
            if ema_update is not None:
                ema = ema_update(ema, params)
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                logger.info(
                    "step %4d  loss %.4f  (%.1f imgs/s)",
                    step, float(loss),
                    (step - start_step + 1) * args.batch / dt,
                )
            if args.eval_every and (step + 1) % args.eval_every == 0:
                acc = evaluate(infer_fn, ema if ema is not None else params,
                               eval_images, eval_labels, args.batch)
                label = ("train-stream top-1" if loader is not None
                         else "eval top-1")
                if ema is not None:
                    label = "EMA " + label
                logger.info("step %4d  %s %.3f", step, label, acc)
            if (args.save_every and state_dir
                    and (step + 1) % args.save_every == 0):
                if saver is None:
                    from interactive_vit_tpu.utils.checkpoint import (
                        AsyncSaver,
                    )

                    saver = AsyncSaver()
                save_state(state_dir, params, opt_state, step + 1,
                           saver=saver, head_major=head_major, ema=ema)
                logger.info("async-saving train state at step %d", step + 1)
        if loader is not None:
            loader.close()
        if saver is not None:
            saver.close()  # drain the in-flight write before final save

    # Canonical export layout: training with TP runs head-major qkv
    # ([H][3][Dh] columns) — exported weights must return to the
    # torch-style [3][H][Dh] packing the single-chip forward (and every
    # converter) expects. Train-STATE checkpoints (--resume) stay in the
    # training layout on purpose: resume re-enters the same TP setup.
    # With --ema-decay, the AVERAGED weights are the serving artifact
    # (the model-EMA recipe's whole point); the raw params stay in the
    # train state for resume. The f32 average casts back to the param
    # dtype so the exported artifact matches a plain run's.
    export_params = params
    if ema is not None:
        export_params = jax.tree.map(
            lambda e, p: e.astype(p.dtype)
            if jnp.issubdtype(e.dtype, jnp.floating) else e, ema, params)
    if head_major:
        # head-major runs (TP sharding OR the packed train kernel);
        # swin returns False here — it trains flat-column qkv even
        # under TP (per-stage head counts), nothing to unpermute
        export_params = mesh_lib.unpermute_qkv_head_major(
            export_params, cfg.heads)

    if args.output:
        from interactive_vit_tpu.utils.checkpoint import save_params

        save_params(os.path.join(args.output, "params"), export_params)
        if state_dir:
            save_state(state_dir, params, opt_state, args.steps,
                       head_major=head_major, ema=ema)
        logger.info("saved checkpoint to %s", args.output)
    if args.export_safetensors:
        import jax

        from interactive_vit_tpu.models.weights import to_native_flat
        from interactive_vit_tpu.utils.safetensors_io import save_file

        save_file(to_native_flat(jax.device_get(export_params)),
                  args.export_safetensors)
        logger.info("exported %s", args.export_safetensors)


if __name__ == "__main__":
    main()
