"""Sharded training and inference steps (DP x TP over a mesh).

The reference was inference-only (``torch.no_grad()``,
the reference's ``main/context.py:80``); training support is an addition
(the multi-device dry-run jits a FULL training step). Design: plain
``jax.jit`` over functions whose inputs carry ``NamedSharding``s — GSPMD
propagates the Megatron TP layout from the weight shardings
(``parallel/mesh.py``) and inserts the psums; gradients
reduce over the data axis automatically because params are replicated on it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.parallel import mesh as mesh_lib

Params = Dict[str, Any]


def cross_entropy(logits: jnp.ndarray, labels: jnp.ndarray,
                  smoothing: float = 0.0) -> jnp.ndarray:
    """Mean cross-entropy. ``labels``: int ``[B]`` OR soft ``[B, C]``
    (mixup/cutmix emit soft targets, ``data/augment.py``); ``smoothing``
    is standard label smoothing (uniform mass ``s/C``)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    if labels.ndim == 2:
        tgt = labels.astype(jnp.float32)
        if smoothing:
            tgt = tgt * (1.0 - smoothing) + smoothing / logits.shape[-1]
        return -(tgt * logp).sum(axis=-1).mean()
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    if smoothing:
        # s * (nll - mean logp over classes) folded in closed form:
        # target = (1-s)*onehot + s/C  ->  loss = (1-s)*nll - s*mean(logp)
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(axis=-1)
    return nll.mean()


def _decay_mask(params):
    """True where AdamW weight decay applies: matmul weights only.

    The standard ViT recipe excludes LayerNorm scales/biases, all biases,
    cls_token and pos_emb from decay (decaying LN scales measurably hurts
    long runs); a leaf is decayed iff it is a rank-2 weight matrix — plus
    the MoE expert matmuls, which are rank-3 [E, d_in, d_out] (the E dim
    is a batch of weight matrices, not an embedding table)."""
    import jax

    def decayed(path, x):
        nd = getattr(x, "ndim", 0)
        if "exp_fc" in jax.tree_util.keystr(path):
            # expert weights are rank-3 [E, d_in, d_out]; expert BIASES
            # are rank-2 [E, d] but still biases — exempt like all biases
            return nd == 3
        # rank-4 = conv kernels (ConvNeXt stem/dw/downsample): decayed in
        # the torchvision recipe; no rank-4 embedding tables exist in any
        # family, so the rule is safe. Rank-3 pos_emb/cls/reg stay exempt.
        return nd in (2, 4)

    return jax.tree_util.tree_map_with_path(decayed, params)


def _llrd_layer_id(path_str: str):
    """Map a param path to its LLRD group: 0 = embedding tier,
    1..L = transformer/conv blocks in depth order, None = the top
    (head + final norm — always full LR).

    Handles every family's tree shape: ViT ``blocks[i]``, Swin/ConvNeXt
    ``stages[s][b]`` (flattened in depth order) with the between-stage
    ``merges[s]``/``downs[s]`` attached to the END of stage s (they
    consume stage-s features, so they share its depth position). The
    returned id for stage blocks is a (s, b) tuple resolved to a global
    index once the whole tree has been scanned."""
    import re

    m = re.search(r"\['blocks'\]\[(\d+)\]", path_str)
    if m:
        return ("block", int(m.group(1)))
    m = re.search(r"\['stages'\]\[(\d+)\]\[(\d+)\]", path_str)
    if m:
        return ("stage", int(m.group(1)), int(m.group(2)))
    m = re.search(r"\['(?:merges|downs)'\]\[(\d+)\]", path_str)
    if m:
        return ("stage_end", int(m.group(1)))  # shares the stage's last rung
    if re.search(r"\['(?:head|head_dist|norm)'\]", path_str):
        return None
    return ("embed",)  # patch_embed/stem/cls/pos/dist/reg tokens


def llrd_factors(params, decay: float):
    """Per-leaf LR multipliers for layer-wise LR decay (the BEiT/MAE
    finetune recipe, Clark/Bao et al.): the head and final norm train at
    the full LR, block ``j`` of ``L`` at ``decay^(L-j)``, and the
    embedding tier at ``decay^(L+1)``. Returns an f32 scalar tree shaped
    like ``params``."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    ids = {jax.tree_util.keystr(p): _llrd_layer_id(jax.tree_util.keystr(p))
           for p, _ in flat}
    blocks = sorted({i for i in ids.values()
                     if i is not None and i[0] in ("block", "stage")})
    order = {b: j for j, b in enumerate(blocks)}
    # merges/downs between stages share the rung of their stage's LAST
    # block (they consume stage-s features); they add no rung of their own
    for i in set(ids.values()):
        if i is not None and i[0] == "stage_end":
            last = max(b for b in blocks if b[:2] == ("stage", i[1]))
            order[i] = order[last]
    n = len(blocks)

    def factor(path, x):
        i = ids[jax.tree_util.keystr(path)]
        if i is None:
            return jnp.float32(1.0)
        if i == ("embed",):
            return jnp.float32(decay ** (n + 1))
        return jnp.float32(decay ** (n - order[i]))

    return jax.tree_util.tree_map_with_path(factor, params)


def scale_by_llrd(decay: float) -> optax.GradientTransformation:
    """Optax transform applying layer-wise LR decay: appended AFTER the
    base optimizer so it scales the final updates — exactly equivalent to
    per-layer learning rates (AdamW's update direction is invariant to a
    per-group LR). Factors are computed at trace time from the update
    tree's paths; no state."""

    def init(params):
        return optax.EmptyState()

    def update(updates, state, params=None):
        fac = llrd_factors(updates, decay)
        return (jax.tree.map(lambda u, f: u * f.astype(u.dtype),
                             updates, fac), state)

    return optax.GradientTransformation(init, update)


def make_optimizer(lr: float = 3e-4, wd: float = 0.05,
                   warmup_steps: int = 0, total_steps: int = 0,
                   clip_norm: float = 0.0, llrd: float = 0.0):
    """AdamW (decay masked to rank-2 weights — LN/biases/embeddings are
    exempt per the standard ViT recipe), optionally with global-norm
    clipping, a warmup+cosine schedule, and layer-wise LR decay
    (``llrd`` in (0,1): per-block multiplier, the MAE/BEiT finetune
    recipe). ``total_steps=0`` -> constant lr; ``clip_norm=0`` -> no
    clipping; ``llrd=0`` -> uniform LR."""
    sched = lr
    if total_steps:
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr,
            warmup_steps=max(1, warmup_steps),
            decay_steps=total_steps, end_value=lr * 0.01)
    tx = optax.adamw(sched, weight_decay=wd, mask=_decay_mask)
    if clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), tx)
    if llrd:
        if not 0.0 < llrd <= 1.0:
            raise ValueError(f"llrd must be in (0, 1], got {llrd}")
        tx = optax.chain(tx, scale_by_llrd(llrd))
    return tx


MOE_AUX_WEIGHT = 0.01  # Switch load-balance loss coefficient

def device_memory_bytes(device=None):
    """The device's own memory limit (``memory_stats()["bytes_limit"]``),
    or None where the backend does not report one."""
    try:
        stats = (device or jax.devices()[0]).memory_stats() or {}
    except Exception:  # noqa: BLE001 — backends without memory stats
        return None
    return stats.get("bytes_limit")


def auto_remat(cfg, per_device_batch: int, dtype=jnp.float32,
               hbm_bytes=None, budget_frac: float = 0.7) -> bool:
    """Decide per-block rematerialization from a memory working-set
    estimate.

    Without remat the backward saves the block activations instead of
    recomputing the forward, so remat is pure waste whenever those
    activations fit. This estimates that working set (coarse,
    upper-bound-ish) and returns True (remat ON) only when it would
    breach ``budget_frac`` of ``hbm_bytes`` (default: the device's own
    limit, ``device_memory_bytes``). Where the limit is unknown, and for
    unknown config families (swin's per-stage geometry), remat stays ON.
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes()
    if not hbm_bytes:
        return True
    d = getattr(cfg, "width", None)
    depth = getattr(cfg, "depth", None)
    if not (d and depth and hasattr(cfg, "img_size")
            and hasattr(cfg, "patch")):
        return True
    bytes_per = jnp.dtype(dtype).itemsize
    n = (cfg.img_size // cfg.patch) ** 2 + 2  # +cls (+dist)
    heads = getattr(cfg, "heads", 1)
    mlp_dim = getattr(cfg, "mlp_dim", 4 * d)
    # saved per block without remat: ~12 [B,N,D]-sized tensors (qkv,
    # attention out, proj in/out, LN stats, residuals) + the MLP hidden
    # twice (pre/post GELU)
    per_block = per_device_batch * n * (12 * d + 2 * mlp_dim) * bytes_per
    # XLA attention saves the probs for the backward, f32-ish
    per_block += 2 * per_device_batch * heads * n * n * 4
    experts = getattr(cfg, "n_experts", 0) or 1
    n_params = (depth * (4 * d * d + 2 * d * mlp_dim * experts)
                + 2 * n * d + d * getattr(cfg, "num_classes", 1000))
    # params (dtype) + grads (dtype) + AdamW m/v (f32)
    static = n_params * (2 * bytes_per + 8)
    return depth * per_block + static > budget_frac * hbm_bytes


def model_family(cfg: vit.ViTConfig):
    """The module implementing ``cfg``'s forward/init (vit, moe, swin,
    convnext)."""
    from interactive_vit_tpu.models import convnext, moe, swin

    if isinstance(cfg, swin.SwinConfig):
        return swin
    if isinstance(cfg, convnext.ConvNeXtConfig):
        return convnext
    return moe if isinstance(cfg, moe.MoEViTConfig) else vit


def _plain_forward_family(fam) -> bool:
    """Families whose forward takes no attn_impl/qkv knobs (swin's
    windowed attention, convnext's convs) — just the remat hook."""
    return fam.__name__.endswith((".swin", ".convnext"))


def loss_fn(params: Params, images: jnp.ndarray, labels: jnp.ndarray,
            cfg: vit.ViTConfig, attn_impl=None,
            block_wrapper=None, qkv_head_major: bool = False,
            label_smoothing: float = 0.0) -> jnp.ndarray:
    fam = model_family(cfg)
    if _plain_forward_family(fam):
        # no attn_impl/qkv repack knobs (swin's windowed attention,
        # convnext's convs) — just the remat hook
        out = fam.forward(params, images, cfg, block_wrapper=block_wrapper)
        logits = out["logits"] if isinstance(out, dict) else out
        return cross_entropy(logits, labels, label_smoothing)
    if fam is not vit:
        out = fam.forward(params, images, cfg, attn_impl=attn_impl,
                          block_wrapper=block_wrapper,
                          qkv_head_major=qkv_head_major, want_aux=True)
        return (cross_entropy(out["logits"], labels, label_smoothing)
                + MOE_AUX_WEIGHT * out["aux"])
    logits = vit.forward(params, images, cfg, attn_impl=attn_impl,
                         block_wrapper=block_wrapper,
                         qkv_head_major=qkv_head_major)["logits"]
    return cross_entropy(logits, labels, label_smoothing)


def wants_head_major(cfg, mesh) -> bool:
    """Whether training should run head-major qkv columns ([H][3][Dh]):
    when TP is active, the flat column sharding must be head-aligned (the
    Megatron split). Swin never repacks (per-stage head counts).
    Checkpoint EXPORTS must consult this too: the on-disk canonical
    layout is torch-style [3][H][Dh] (``unpermute_qkv_head_major``).
    """
    if _plain_forward_family(model_family(cfg)):
        return False
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1) > 1


def remat_wrapper(remat):
    """Resolve the per-block ``jax.checkpoint`` wrapper.

    ``remat``: False = no remat (fastest when activations fit HBM —
    ``auto_remat``); True = full per-block remat (save block inputs
    only); "dots" = ``dots_with_no_batch_dims_saveable`` — save matmul
    outputs, recompute the elementwise chains (LN, GELU, softmax): a
    middle point that skips most of remat's extra matmul FLOPs while
    still dropping the elementwise intermediates.
    """
    if not remat:
        return None
    if remat == "dots":
        return functools.partial(
            jax.checkpoint,
            policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    return functools.partial(jax.checkpoint)


def cast_params(params: Params, dtype) -> Params:
    """Cast the floating leaves of ``params`` to ``dtype`` (None = no-op).

    The mixed-precision compute cast: master params stay f32 (so AdamW's
    mu/nu are f32 and sub-ulp updates don't round away — optax moments
    inherit the PARAM dtype, and bf16 nu underflows small squared grads),
    while the forward runs in ``dtype``. ``models.vit.embed`` makes
    activations adopt the weight dtype, so casting the tree here puts the
    whole forward in bf16; the cast's VJP converts the bf16 cotangents
    back to f32, so gradients and the optimizer update stay f32."""
    if dtype is None:
        return params
    return jax.tree.map(
        lambda x: x.astype(dtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        params)


def make_train_step(cfg: vit.ViTConfig, optimizer=None, attn_impl=None,
                    remat=True, qkv_head_major: bool = False,
                    accum_steps: int = 1, label_smoothing: float = 0.0,
                    compute_dtype=None):
    """Build a jittable train step (params, opt_state, images, labels) ->
    (params, opt_state, loss).

    ``remat`` wraps each block in ``jax.checkpoint`` via ``vit.forward``'s
    ``block_wrapper`` hook — trade FLOPs for HBM (rematerialize
    activations in backward) so big batches fit; see ``remat_wrapper``
    for the accepted values. ONE trunk: the training forward is the
    inference forward, so they cannot drift.

    ``accum_steps=k``: gradient accumulation — the [B] batch is split
    into k microbatches run sequentially under ``lax.scan`` (one compile,
    activation memory of B/k), grads accumulated in f32 and averaged
    before ONE optimizer update. Equivalent to the full-batch step by
    loss-mean linearity; enables effective batches whose activations
    exceed HBM without paying remat's extra forward.

    ``compute_dtype``: mixed precision — params stay in their (f32
    master) dtype for the optimizer, the forward/backward run in
    ``compute_dtype`` via ``cast_params``.
    """
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)

    def lf(p, im, lb):
        return loss_fn(cast_params(p, compute_dtype), im, lb, cfg,
                       attn_impl=attn_impl,
                       block_wrapper=wrapper,
                       qkv_head_major=qkv_head_major,
                       label_smoothing=label_smoothing)

    def step(params, opt_state, images, labels):
        if accum_steps == 1:
            loss, grads = jax.value_and_grad(lf)(params, images, labels)
        else:
            mb_im = images.reshape(
                accum_steps, images.shape[0] // accum_steps,
                *images.shape[1:])
            # labels: int [B] or soft [B, C] (mixup/cutmix)
            mb_lb = labels.reshape(
                accum_steps, labels.shape[0] // accum_steps,
                *labels.shape[1:])

            def body(carry, mb):
                g_acc, l_acc = carry
                loss_i, g_i = jax.value_and_grad(lf)(params, *mb)
                g_acc = jax.tree.map(
                    lambda a, g: a + g.astype(jnp.float32), g_acc, g_i)
                return (g_acc, l_acc + loss_i), None

            zeros = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (grads, loss), _ = jax.lax.scan(
                body, (zeros, jnp.zeros((), jnp.float32)), (mb_im, mb_lb))
            # cast back to the param dtype AFTER the f32 accumulation:
            # keeps the summation exact-ish and the optimizer state dtype
            # stable across steps (donation requires matching avals)
            grads = jax.tree.map(
                lambda g, p: (g / accum_steps).astype(p.dtype),
                grads, params)
            loss = loss / accum_steps
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _student_logits(p, images, cfg, attn_impl=None, wrapper=None,
                    qkv_head_major: bool = False):
    """Distilled-student forward with UN-averaged heads: (cls, dist)
    logits. Same trunk units as ``vit.forward``'s wrapped path (embed ->
    per-block remat hook -> prefix-token final norm) so remat applies."""

    x = vit.embed(p, images, cfg)

    def one(bp, x):
        y, _, _ = vit.block(bp, x, cfg, attn_impl=attn_impl,
                            qkv_head_major=qkv_head_major)
        return y

    if wrapper is not None:
        one = wrapper(one)
    for bp in p["blocks"]:
        x = one(bp, x)
    x = vit.final_norm(p, x[:, :cfg.prefix_tokens], cfg)
    return vit.head_split(p, x)


def make_teacher_fn(teacher_cfg, teacher_params, attn_impl=None):
    """images -> stop-gradient logits from a FROZEN teacher of any
    trainable family (the params are closed over — never donated, never
    updated). Torch-layout qkv columns on purpose: the teacher runs the
    plain XLA inference forward."""
    tfam = model_family(teacher_cfg)
    plain = _plain_forward_family(tfam)

    def teacher_logits(images):
        if plain:
            out = tfam.forward(teacher_params, images, teacher_cfg)
        else:
            out = tfam.forward(teacher_params, images, teacher_cfg,
                               attn_impl=attn_impl)
        logits = out["logits"] if isinstance(out, dict) else out
        return jax.lax.stop_gradient(logits)

    return teacher_logits


def make_distill_train_step(cfg: vit.ViTConfig, teacher_cfg, teacher_params,
                            optimizer=None, attn_impl=None, remat=False,
                            qkv_head_major: bool = False,
                            accum_steps: int = 1, alpha: float = 0.5,
                            tau: float = 0.0,
                            label_smoothing: float = 0.0,
                            compute_dtype=None):
    """DeiT knowledge-distillation step (Touvron et al. 2021): the
    student's class head trains on the labels, its distillation head
    (token 1) trains on a frozen teacher's predictions.

    ``tau=0`` -> HARD distillation (CE against the teacher's argmax — the
    paper's best recipe); ``tau>0`` -> soft distillation (CE against the
    temperature-softened teacher distribution, scaled by tau^2 so gradient
    magnitude is temperature-invariant). ``alpha`` weighs the distillation
    term: loss = (1-alpha)*CE(cls, y) + alpha*distill. Signature matches
    ``make_train_step`` — (params, opt_state, images, labels) -> (params,
    opt_state, loss) — so the CLI's checkpoint/EMA/eval loop is reused
    unchanged."""
    if not cfg.distilled:
        raise ValueError(
            f"{cfg.name} has no distillation token/head (distilled=False) "
            f"— distillation training needs a deit_* style student")
    if teacher_cfg.img_size != cfg.img_size:
        raise ValueError(
            f"teacher resolution {teacher_cfg.img_size} != student "
            f"{cfg.img_size}: both consume the same batch")
    if teacher_cfg.num_classes != cfg.num_classes:
        raise ValueError(
            f"teacher classes {teacher_cfg.num_classes} != student "
            f"{cfg.num_classes}: the dist head trains on teacher logits")
    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)
    # the teacher is frozen — no master copy needed, cast it once
    teacher = make_teacher_fn(teacher_cfg,
                              cast_params(teacher_params, compute_dtype))

    def lf(p, im, lb):
        cls_l, dist_l = _student_logits(
            cast_params(p, compute_dtype), im, cfg, attn_impl=attn_impl,
            wrapper=wrapper, qkv_head_major=qkv_head_major)
        t = teacher(im)
        if tau > 0:
            logq = jax.nn.log_softmax(
                dist_l.astype(jnp.float32) / tau, axis=-1)
            pt = jax.nn.softmax(t.astype(jnp.float32) / tau, axis=-1)
            distill = -(pt * logq).sum(axis=-1).mean() * (tau * tau)
        else:
            distill = cross_entropy(dist_l, jnp.argmax(t, axis=-1))
        return ((1.0 - alpha) * cross_entropy(cls_l, lb, label_smoothing)
                + alpha * distill)

    def step(params, opt_state, images, labels):
        if accum_steps == 1:
            loss, grads = jax.value_and_grad(lf)(params, images, labels)
        else:
            mb_im = images.reshape(
                accum_steps, images.shape[0] // accum_steps,
                *images.shape[1:])
            mb_lb = labels.reshape(
                accum_steps, labels.shape[0] // accum_steps,
                *labels.shape[1:])

            def body(carry, mb):
                g_acc, l_acc = carry
                loss_i, g_i = jax.value_and_grad(lf)(params, *mb)
                g_acc = jax.tree.map(
                    lambda a, g: a + g.astype(jnp.float32), g_acc, g_i)
                return (g_acc, l_acc + loss_i), None

            zeros = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (grads, loss), _ = jax.lax.scan(
                body, (zeros, jnp.zeros((), jnp.float32)), (mb_im, mb_lb))
            grads = jax.tree.map(
                lambda g, p: (g / accum_steps).astype(p.dtype),
                grads, params)
            loss = loss / accum_steps
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def setup_sharded_distill(cfg: vit.ViTConfig, teacher_cfg, teacher_params,
                          mesh, seed: int = 0, lr: float = 3e-4,
                          remat=False, optimizer=None, dtype=None,
                          attn_impl=None, accum_steps: int = 1,
                          alpha: float = 0.5, tau: float = 0.0,
                          label_smoothing: float = 0.0,
                          compute_dtype=None):
    """Init a distilled student on the mesh against a frozen teacher;
    returns (params, opt_state, train_step, infer_fn) — the same tuple as
    ``setup_sharded`` so the CLI loop is shared. The teacher tree is
    mesh-sharded (same Megatron rules; its matmuls TP-split like the
    student's) but stays torch-layout and is closed over by the step."""
    optimizer = optimizer or make_optimizer(lr)
    params = vit.init_params(
        jax.random.key(seed), cfg,
        **({"dtype": dtype} if dtype is not None else {}))
    head_major = wants_head_major(cfg, mesh)
    if head_major:
        params = mesh_lib.permute_qkv_head_major(params, cfg.heads)
    params = mesh_lib.shard_params(params, mesh)
    teacher_params = cast_params(teacher_params, dtype)
    teacher_params = mesh_lib.shard_params(teacher_params, mesh)
    opt_state = optimizer.init(params)
    step = make_distill_train_step(
        cfg, teacher_cfg, teacher_params, optimizer, attn_impl=attn_impl,
        remat=remat, qkv_head_major=head_major, accum_steps=accum_steps,
        alpha=alpha, tau=tau, label_smoothing=label_smoothing,
        compute_dtype=compute_dtype)
    bsh = mesh_lib.batch_sharding(mesh)
    train_step = jax.jit(
        step,
        in_shardings=(None, None, bsh, bsh),
        donate_argnums=(0, 1),
    )

    def infer(params, images):
        return vit.forward(cast_params(params, compute_dtype), images,
                           cfg, attn_impl=attn_impl,
                           qkv_head_major=head_major)["logits"]

    infer_fn = jax.jit(infer, in_shardings=(None, bsh))
    return params, opt_state, train_step, infer_fn


def make_mae_train_step(cfg, optimizer=None, remat=False,
                        accum_steps: int = 1,
                        mask_ratio: float = None,
                        compute_dtype=None):
    """Build a jittable MAE pretraining step (params, opt_state, images,
    key) -> (params, opt_state, loss).

    Same structure as ``make_train_step`` — remat via the block wrapper,
    ``lax.scan`` gradient accumulation with f32 accumulators — but the
    objective is masked reconstruction (``models/mae.forward_pretrain``)
    and the per-step randomness is an explicit ``jax.random`` key (fold it
    from (seed, step) for deterministic, resumable streams). Each
    microbatch folds the accumulation index into the key so microbatches
    draw independent masks."""
    from interactive_vit_tpu.models import mae

    optimizer = optimizer or make_optimizer()
    wrapper = remat_wrapper(remat)

    def lf(p, im, key):
        return mae.forward_pretrain(
            cast_params(p, compute_dtype), im, cfg, key,
            mask_ratio=mask_ratio,
            block_wrapper=wrapper)["loss"]

    def step(params, opt_state, images, key):
        if accum_steps == 1:
            loss, grads = jax.value_and_grad(lf)(params, images, key)
        else:
            mb_im = images.reshape(
                accum_steps, images.shape[0] // accum_steps,
                *images.shape[1:])

            def body(carry, mb):
                g_acc, l_acc = carry
                im, i = mb
                loss_i, g_i = jax.value_and_grad(lf)(
                    params, im, jax.random.fold_in(key, i))
                g_acc = jax.tree.map(
                    lambda a, g: a + g.astype(jnp.float32), g_acc, g_i)
                return (g_acc, l_acc + loss_i), None

            zeros = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (grads, loss), _ = jax.lax.scan(
                body, (zeros, jnp.zeros((), jnp.float32)),
                (mb_im, jnp.arange(accum_steps)))
            grads = jax.tree.map(
                lambda g, p: (g / accum_steps).astype(p.dtype),
                grads, params)
            loss = loss / accum_steps
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def setup_sharded_mae(cfg, mesh, seed: int = 0, lr: float = 1.5e-4,
                      remat=False, optimizer=None, dtype=None,
                      accum_steps: int = 1, mask_ratio: float = None,
                      compute_dtype=None):
    """Init MAE params + opt state on the mesh; return the jitted step.

    Returns (params, opt_state, train_step). The encoder/decoder blocks
    carry the same leaf names as plain ViT blocks, so ``param_spec``'s
    Megatron TP rules apply unchanged (qkv/fc1 output-sharded, proj/fc2
    input-sharded) and GSPMD inserts the psums; the batch shards over
    "data". The step runs the TORCH-layout qkv columns (no head-major
    repack): the packed custom-VJP kernel keys on full fixed token counts,
    while MAE's visible-token count varies with the ratio — the XLA
    attention path trains it."""
    from interactive_vit_tpu.models import mae

    optimizer = optimizer or make_optimizer(lr)
    params = mae.init_params(
        jax.random.key(seed), cfg,
        **({"dtype": dtype} if dtype is not None else {}))
    params = mesh_lib.shard_params(params, mesh)
    opt_state = optimizer.init(params)
    step = make_mae_train_step(cfg, optimizer, remat=remat,
                               accum_steps=accum_steps,
                               mask_ratio=mask_ratio,
                               compute_dtype=compute_dtype)
    bsh = mesh_lib.batch_sharding(mesh)
    train_step = jax.jit(
        step,
        in_shardings=(None, None, bsh, None),
        donate_argnums=(0, 1),
    )
    return params, opt_state, train_step


def setup_sharded(
    cfg: vit.ViTConfig,
    mesh,
    seed: int = 0,
    lr: float = 3e-4,
    attn_impl=None,
    remat=True,
    optimizer=None,
    dtype=None,
    accum_steps: int = 1,
    label_smoothing: float = 0.0,
    compute_dtype=None,
) -> Tuple[Params, Any, Any, Any]:
    """Init params+opt state on the mesh; return jitted (train_step, infer).

    Returns (params, opt_state, train_step, infer_fn). All four live on the
    mesh: params/opt_state replicated over data + TP-sharded over model;
    train_step donates params/opt_state buffers. Pass ``optimizer`` to use
    a configured one (schedule/clipping via ``make_optimizer``).

    ``attn_impl``: a callable (``attention.mhsa`` contract) or None for
    the plain path, which XLA differentiates.
    ``dtype``: parameter dtype (None = f32, the parity default; bf16 is
    the pure-bf16 throughput config).
    ``compute_dtype``: mixed precision — keep ``dtype`` at f32 masters
    (AdamW moments f32) and run the forward/backward in this dtype.
    """
    optimizer = optimizer or make_optimizer(lr)
    params = model_family(cfg).init_params(
        jax.random.key(seed), cfg,
        **({"dtype": dtype} if dtype is not None else {}))
    # head-major qkv columns whenever TP is active (makes param_spec's
    # flat column sharding head-ALIGNED — the actual Megatron split; the
    # torch layout [3][H][Dh] would force GSPMD to reshard the activation
    # at the head reshape). Swin keeps flat columns under TP:
    # per-stage head counts (3/6/12/24) need not divide the model axis —
    # GSPMD reshards at the window reshape instead; correctness unchanged.
    fam = model_family(cfg)
    is_plain = _plain_forward_family(fam)
    head_major = wants_head_major(cfg, mesh)
    if head_major:
        params = mesh_lib.permute_qkv_head_major(params, cfg.heads)
    params = mesh_lib.shard_params(params, mesh)
    # optax init builds zeros_like(params) -> inherits the TP shardings
    opt_state = optimizer.init(params)

    step = make_train_step(cfg, optimizer, attn_impl=attn_impl, remat=remat,
                           qkv_head_major=head_major,
                           accum_steps=accum_steps,
                           label_smoothing=label_smoothing,
                           compute_dtype=compute_dtype)
    bsh = mesh_lib.batch_sharding(mesh)

    train_step = jax.jit(
        step,
        in_shardings=(None, None, bsh, bsh),  # None = keep arg's sharding
        donate_argnums=(0, 1),
    )

    def infer(params, images):
        params = cast_params(params, compute_dtype)
        if is_plain:
            out = fam.forward(params, images, cfg)
            return out["logits"] if isinstance(out, dict) else out
        return fam.forward(params, images, cfg, attn_impl=attn_impl,
                           qkv_head_major=head_major)["logits"]

    infer_fn = jax.jit(infer, in_shardings=(None, bsh))
    return params, opt_state, train_step, infer_fn
