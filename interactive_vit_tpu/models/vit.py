"""Vision Transformer — functional pytree implementation, every edge tappable.

The reference exposed any torch submodule as a graph node by name
(``/root/reference/main/context.py:79-88``); here the model IS a list of
named pure functions over pytree param subtrees, which the model-plugin tier
(``models/model_plugin.py``) registers as graph node kinds
(``vit_b16:blocks.3`` etc.). BASELINE.json's configs drive the variants:

    vit_t16  ViT-Tiny/16  @224  (config 1: CPU single-image + attn dump)
    vit_s16  ViT-Small/16 @224
    vit_b16  ViT-Base/16  @224  (config 2: the headline throughput model)
    vit_l16  ViT-Large/16 @384  (config 3: 577-token flash-attn tiling)

Architecture: standard pre-LN ViT (Dosovitskiy et al. 2021), CLS token,
learned position embeddings, exact GELU — layer-for-layer compatible with
torchvision's ``vit_b_16`` so its checkpoints convert directly
(``models/weights.py``).

Monolithic forward (``forward``) is used for benchmarking and training; the
per-layer functions (``layer_fns``) are what the graph executor stages —
both paths share the same primitives so they cannot drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import attention as attn_ops
from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_size: int = 224
    patch: int = 16
    width: int = 192
    depth: int = 12
    heads: int = 3
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_chans: int = 3
    ln_eps: float = 1e-6
    # DeiT (Touvron et al. 2021): a second learned prefix token trained
    # against a teacher; at inference the class and distillation heads
    # average. Same blocks, one extra token — a config, not a new model.
    distilled: bool = False
    # "Vision Transformers Need Registers" (Darcet et al. 2024) /
    # DINOv2-reg: extra learned prefix tokens inserted after CLS that
    # carry NO positional embedding — attention scratch space that cleans
    # up the feature maps. Pure config: same blocks, R more tokens.
    registers: int = 0
    # DINOv2 (Oquab et al. 2023) LayerScale: per-channel learned gamma on
    # each residual branch, init value here (1e-5 in the paper; 0 = off).
    layer_scale: float = 0.0

    def __post_init__(self):
        if self.distilled and self.registers:
            raise ValueError(
                f"{self.name}: distilled + registers is not a published "
                f"configuration (head_dist reads token 1, which a "
                f"register would occupy)")

    @property
    def prefix_tokens(self) -> int:
        return (2 if self.distilled else 1) + self.registers

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + self.prefix_tokens

    @property
    def pos_tokens(self) -> int:
        """Rows of the position table: CLS(+DIST) + patch grid —
        registers are pos-free (the DINOv2-reg construction)."""
        return self.tokens - self.registers

    @property
    def mlp_dim(self) -> int:
        return self.width * self.mlp_ratio


VARIANTS: Dict[str, ViTConfig] = {
    "vit_t16": ViTConfig("vit_t16", 224, 16, 192, 12, 3),
    "vit_s16": ViTConfig("vit_s16", 224, 16, 384, 12, 6),
    "vit_b16": ViTConfig("vit_b16", 224, 16, 768, 12, 12),
    "vit_b32": ViTConfig("vit_b32", 224, 32, 768, 12, 12),
    "vit_l16": ViTConfig("vit_l16", 384, 16, 1024, 24, 16),
    "vit_h14": ViTConfig("vit_h14", 224, 14, 1280, 32, 16),
    # self-supervised (DINO-style) feature extractors: num_classes=0 makes
    # the head emit final-LN CLS features [B,D] instead of logits; the
    # patch tokens feed the pca_view/patch_sim dense-feature nodes.
    # dino_s8's patch-8 grid gives N=785 tokens @224 — the longest
    # sequence served (beyond ViT-L@384's 577), exercising the
    # online-softmax tiling past ROWFULL_MAX_N.
    "dino_s16": ViTConfig("dino_s16", 224, 16, 384, 12, 6, num_classes=0),
    "dino_s8": ViTConfig("dino_s8", 224, 8, 384, 12, 6, num_classes=0),
    "dino_b16": ViTConfig("dino_b16", 224, 16, 768, 12, 12, num_classes=0),
    # DeiT distilled variants (timm deit_*_distilled_patch16_224): CLS +
    # distillation prefix tokens, dual averaged heads, N = grid + 2
    "deit_t16": ViTConfig("deit_t16", 224, 16, 192, 12, 3, distilled=True),
    "deit_s16": ViTConfig("deit_s16", 224, 16, 384, 12, 6, distilled=True),
    "deit_b16": ViTConfig("deit_b16", 224, 16, 768, 12, 12, distilled=True),
    # DINOv2 (patch-14 @518 = 37x37 grid, LayerScale residuals,
    # num_classes=0 feature extractors; timm vit_*_patch14_dinov2 /
    # *_reg4_dinov2 checkpoints convert via weights.from_timm). The _reg
    # variants add 4 pos-free register tokens after CLS.
    "dinov2_s14": ViTConfig("dinov2_s14", 518, 14, 384, 12, 6,
                            num_classes=0, layer_scale=1e-5),
    "dinov2_b14": ViTConfig("dinov2_b14", 518, 14, 768, 12, 12,
                            num_classes=0, layer_scale=1e-5),
    "dinov2_s14_reg": ViTConfig("dinov2_s14_reg", 518, 14, 384, 12, 6,
                                num_classes=0, layer_scale=1e-5,
                                registers=4),
    "dinov2_b14_reg": ViTConfig("dinov2_b14_reg", 518, 14, 768, 12, 12,
                                num_classes=0, layer_scale=1e-5,
                                registers=4),
}


def resolve_variant(name: str) -> ViTConfig:
    """``"vit_b16"``, ``"vit_b16@384"``, ``"vit_b16@p8"`` or
    ``"vit_b16@384p32"`` -> config. The ``@[<pixels>][p<patch>]`` suffix
    serves a known variant at a non-native resolution and/or patch size;
    width/depth/heads and the checkpoint weights are unchanged —
    checkpoints adapt on load (``adapt_checkpoint``: position-table
    resampling + FlexiViT pseudo-inverse patch-kernel resize). Classic
    uses: DINO dense features on a finer grid (``dino_s16@448`` ->
    28x28 tokens, or ``dino_s16@p8`` -> same via smaller patches),
    higher-res fine-tuning (``vit_b16@384``, the ViT/DeiT recipe), and
    compute/accuracy trades from ONE checkpoint (``vit_b16@p32``)."""
    base, sep, suffix = name.partition("@")
    if base not in VARIANTS:
        raise ValueError(
            f"unknown ViT variant {base!r}; known: {sorted(VARIANTS)}")
    cfg = VARIANTS[base]
    if sep:
        res, psep, patch = suffix.partition("p")
        ok = (res.isdigit() or (not res and psep)) \
            and (patch.isdigit() or not psep)
        if not ok:
            raise ValueError(
                f"bad resolution suffix in {name!r}: expected "
                f"<variant>@<pixels>, <variant>@p<patch>, or "
                f"<variant>@<pixels>p<patch> (e.g. vit_b16@384, "
                f"dino_s16@p8, vit_b16@384p32)")
        img = int(res) if res else cfg.img_size
        p = int(patch) if psep else cfg.patch
        if img % p:
            raise ValueError(
                f"{name!r}: resolution {img} must be a multiple of the "
                f"patch size {p}")
        if (img, p) != (cfg.img_size, cfg.patch):
            cfg = dataclasses.replace(cfg, name=f"{base}@{suffix}",
                                      img_size=img, patch=p)
    return cfg


def adapt_pos_embed(params: Params, cfg: ViTConfig) -> Params:
    """Resample a loaded checkpoint's position table to ``cfg``'s grid.

    The timm ``resample_abs_pos_embed`` construction (public): prefix
    rows (CLS, DIST) pass through; the grid part reshapes to
    [g, g, D] and resamples bicubically per side (separable — two small
    matmuls via ``ops.preprocess_mm.resize_matrix``, the same Keys
    a=-0.5 kernel torch's antialiased bicubic uses). Identity when the
    token count already matches, so it is safe on every load path."""
    pe = params["pos_emb"]
    if pe.shape[1] == cfg.pos_tokens:
        return params
    from interactive_vit_tpu.ops.layers import mm_precision
    from interactive_vit_tpu.ops.preprocess_mm import resize_matrix

    # registers are pos-free: the table's prefix rows are CLS(+DIST) only
    prefix = cfg.prefix_tokens - cfg.registers
    d = pe.shape[2]
    g_sq = pe.shape[1] - prefix
    g_old = int(round(g_sq ** 0.5))
    if g_old * g_old != g_sq:
        raise ValueError(
            f"cannot adapt pos_emb of {pe.shape[1]} tokens to "
            f"{cfg.name}: grid part ({g_sq} rows after {prefix} prefix "
            f"tokens) is not square")
    g_new = cfg.img_size // cfg.patch
    r = jnp.asarray(resize_matrix(g_old, g_new, "bicubic"))
    grid = pe[0, prefix:].astype(jnp.float32).reshape(g_old, g_old, d)
    prec = mm_precision(grid, r)
    grid = jnp.einsum("sh,hwd->swd", r, grid,
                      preferred_element_type=jnp.float32, precision=prec)
    grid = jnp.einsum("tw,swd->std", r, grid,
                      preferred_element_type=jnp.float32, precision=prec)
    new_pe = jnp.concatenate(
        [pe[:, :prefix].astype(jnp.float32),
         grid.reshape(1, g_new * g_new, d)], axis=1).astype(pe.dtype)
    out = dict(params)
    out["pos_emb"] = new_pe
    return out


def adapt_patch_embed(params: Params, cfg: ViTConfig) -> Params:
    """FlexiViT pseudo-inverse resize of the patch-embedding kernel.

    The published PI-resize construction (Beyer et al. 2023, "FlexiViT:
    One Model for All Patch Sizes"): with ``B`` the bilinear patch-resize
    operator p0 -> p1, the adapted kernel is ``(B^+)^T w`` — chosen so
    ``<resize(x), w_new> == <x, w>`` EXACTLY when upsampling (B has full
    column rank) and least-squares-optimal when downsampling. Separable:
    ``pinv`` of the per-axis resize matrix applies to each spatial axis
    of the kernel (host numpy, tiny matrices, load time only). Identity
    when the kernel's patch size already matches ``cfg.patch``."""
    pe = params["patch_embed"]
    w = pe["w"]
    if not hasattr(w, "shape"):  # quantized dict: adapt before quantize
        raise ValueError("adapt_patch_embed needs float weights "
                         "(load/adapt the checkpoint before quantizing)")
    import numpy as np

    c = cfg.in_chans
    pdim, d = w.shape
    p0 = int(round((pdim // c) ** 0.5))
    if c * p0 * p0 != pdim:
        raise ValueError(
            f"patch_embed rows {pdim} are not {c} x p x p — cannot "
            f"infer the checkpoint's patch size")
    if p0 == cfg.patch:
        return params
    from interactive_vit_tpu.ops.preprocess_mm import resize_matrix

    r = resize_matrix(p0, cfg.patch, "bilinear")        # [p1, p0]
    pinv_t = np.linalg.pinv(r).T.astype(np.float32)     # [p1, p0]
    w4 = np.asarray(w, np.float32).reshape(c, p0, p0, d)
    w_new = np.einsum("ai,bj,cijd->cabd", pinv_t, pinv_t, w4,
                      optimize=True)
    out = dict(params)
    out["patch_embed"] = {
        "w": jnp.asarray(
            w_new.reshape(c * cfg.patch * cfg.patch, d), w.dtype),
        "b": pe["b"],
    }
    return out


def adapt_checkpoint(params: Params, cfg: ViTConfig) -> Params:
    """Adapt a loaded plain-ViT checkpoint to a derived ``@res``/``@p``
    config: PI-resize the patch kernel, then resample the position table
    to the resulting grid. Identity when nothing changed — safe on every
    load path."""
    return adapt_pos_embed(adapt_patch_embed(params, cfg), cfg)


# -- init ----------------------------------------------------------------------


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: ViTConfig,
                dtype=jnp.float32) -> Params:
    """Random init (trunc-normal-ish); layout mirrors the forward fns."""
    keys = iter(jax.random.split(key, 8 + 10 * cfg.depth))
    d, dh, md = cfg.width, cfg.width // cfg.heads, cfg.mlp_dim
    pdim = cfg.in_chans * cfg.patch * cfg.patch

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    params: Params = {
        "patch_embed": {
            "w": dense(next(keys), pdim, (pdim, d)),
            "b": jnp.zeros((d,), dtype),
        },
        "cls_token": jnp.zeros((1, 1, d), dtype),
        # registers are pos-free: the table spans CLS(+DIST) + grid only
        "pos_emb": (jax.random.normal(next(keys), (1, cfg.pos_tokens, d),
                                      jnp.float32) * 0.02).astype(dtype),
        "blocks": [],
        "norm": {"s": jnp.ones((d,), dtype), "b": jnp.zeros((d,), dtype)},
        # num_classes=0 = feature extractor (DINO-style): no classifier
        # weights; head() emits the CLS token as the embedding
        "head": (
            {
                "w": dense(next(keys), d, (d, cfg.num_classes)),
                "b": jnp.zeros((cfg.num_classes,), dtype),
            }
            if cfg.num_classes else {}
        ),
    }
    if cfg.distilled:
        params["dist_token"] = jnp.zeros((1, 1, d), dtype)
        if cfg.num_classes:
            params["head_dist"] = {
                "w": dense(next(keys), d, (d, cfg.num_classes)),
                "b": jnp.zeros((cfg.num_classes,), dtype),
            }
    if cfg.registers:
        params["reg_tokens"] = (
            jax.random.normal(next(keys), (1, cfg.registers, d),
                              jnp.float32) * 0.02).astype(dtype)
    for _ in range(cfg.depth):
        blk = {
            "ln1_s": jnp.ones((d,), dtype),
            "ln1_b": jnp.zeros((d,), dtype),
            "qkv_w": dense(next(keys), d, (d, 3 * d)),
            "qkv_b": jnp.zeros((3 * d,), dtype),
            "proj_w": dense(next(keys), d, (d, d)),
            "proj_b": jnp.zeros((d,), dtype),
            "ln2_s": jnp.ones((d,), dtype),
            "ln2_b": jnp.zeros((d,), dtype),
            "fc1_w": dense(next(keys), d, (d, md)),
            "fc1_b": jnp.zeros((md,), dtype),
            "fc2_w": dense(next(keys), md, (md, d)),
            "fc2_b": jnp.zeros((d,), dtype),
        }
        if cfg.layer_scale:
            blk["ls1"] = jnp.full((d,), cfg.layer_scale, dtype)
            blk["ls2"] = jnp.full((d,), cfg.layer_scale, dtype)
        params["blocks"].append(blk)
    return params


# -- per-layer functions -------------------------------------------------------


def embed(params: Params, images: jnp.ndarray, cfg: ViTConfig) -> jnp.ndarray:
    """Patch-embed + CLS + position embeddings: [B,C,H,W] -> [B,N,D].

    Activations adopt the weight dtype here (the model's single entry
    point), so a bf16-weighted model runs bf16 end-to-end even when the
    wire delivers f32 images. With weight-only int8 (ops/quant.py) the
    weight leaf is a dict; the bias (never quantized) carries the
    activation dtype instead.
    """
    pe = params["patch_embed"]
    act_dtype = pe["w"].dtype if hasattr(pe["w"], "dtype") else pe["b"].dtype
    images = images.astype(act_dtype)
    x = L.patch_embed(images, params["patch_embed"], cfg.patch)
    prefix = params["cls_token"]
    if "dist_token" in params:
        # DeiT: [CLS, DIST, patches...]; pos_emb already spans N+2
        prefix = jnp.concatenate(
            [prefix, params["dist_token"].astype(prefix.dtype)], axis=1)
    x = L.add_cls_and_pos(x, prefix, params["pos_emb"])
    if "reg_tokens" in params:
        # DINOv2-reg: registers insert AFTER the pos add, right behind
        # CLS — they carry no positional embedding (the published
        # construction; a timm no_embed_class table normalizes to this
        # via a zero CLS row in weights.from_timm)
        regs = jnp.broadcast_to(
            params["reg_tokens"].astype(x.dtype),
            (x.shape[0],) + params["reg_tokens"].shape[1:])
        x = jnp.concatenate([x[:, :1], regs, x[:, 1:]], axis=1)
    return x


def block(
    p: Params,
    x: jnp.ndarray,
    cfg: ViTConfig,
    want_attn: bool = False,
    attn_impl=None,
    n_real: Optional[int] = None,
    want_mean: bool = False,
    qkv_head_major: bool = False,
    attn_heads=None,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray], Optional[jnp.ndarray]]:
    """Pre-LN transformer block; optionally taps the attention maps.

    Returns ``(y, probs, mean)``: probs [B,H,N,N] when ``want_attn``, mean
    [B,N,N] head-meaned maps (the rollout's input) when ``want_mean``.

    ``attn_heads``: optional static head subset for the probs tap — the
    emitted maps become [B, len(attn_heads), N, N] (ascending head order).

    ``n_real``: set when x's token dim is padded (padded-domain execution);
    attention masks keys beyond it, everything else is row-local.
    ``attn_impl``: the attention implementation (``ops/dispatch``); None
    is the plain path.
    """
    pmean = None
    sel = (tuple(sorted(set(int(h) for h in attn_heads)))
           if attn_heads is not None else None)
    if sel is not None and any(h < 0 or h >= cfg.heads for h in sel):
        raise ValueError(
            f"attn_heads {sorted(sel)} out of range for {cfg.heads} heads")
    h, probs = attn_ops.mhsa(
        L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps),
        p, cfg.heads, want_attn=want_attn or want_mean,
        attn_impl=attn_impl, n_real=n_real,
        head_major=qkv_head_major,
    )
    if "ls1" in p:  # DINOv2 LayerScale on the attention branch
        h = h * p["ls1"].astype(h.dtype)
    x = x + h
    if want_mean and probs is not None:
        # mean over heads accumulates in f32, but the emitted map takes
        # the activations' dtype, so rollout_step's precision policy is
        # keyed on the model's numeric class whichever attention path
        # made the maps (the plain path's f32 probs would otherwise force
        # HIGHEST rollout matmuls on bf16 models)
        pmean = probs.astype(jnp.float32).mean(axis=1).astype(x.dtype)
    if not want_attn:
        probs = None
    elif sel is not None and probs is not None:
        # the full probs existed transiently anyway; only the selected
        # heads persist as the tap
        probs = probs[:, list(sel), :, :]
    m = L.mlp(L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    if "ls2" in p:  # DINOv2 LayerScale on the MLP branch
        m = m * p["ls2"].astype(m.dtype)
    return x + m, probs, pmean


def final_norm(params: Params, x: jnp.ndarray, cfg: ViTConfig) -> jnp.ndarray:
    return L.layer_norm(x, params["norm"]["s"], params["norm"]["b"], cfg.ln_eps)


def head(params: Params, x: jnp.ndarray) -> jnp.ndarray:
    """Classification head on the CLS token: [B,N,D] -> [B,num_classes].

    Feature-extractor variants (num_classes=0, empty head params) emit the
    CLS token itself: [B,N,D] -> [B,D] — the DINO-style embedding.
    Distilled variants (DeiT) average the class head on token 0 with the
    distillation head on token 1 — the published inference contract."""
    hp = params.get("head") or {}
    if "w" not in hp:
        return x[:, 0]
    logits = L.linear(x[:, 0], hp["w"], hp["b"])
    hd = params.get("head_dist") or {}
    if "w" in hd:
        logits = (logits + L.linear(x[:, 1], hd["w"], hd["b"])) * 0.5
    return logits


def head_split(params: Params, x: jnp.ndarray
               ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Training-time heads, UN-averaged: (class logits on token 0,
    distillation logits on token 1 — or None for plain variants).

    ``head`` averages the two — the published DeiT INFERENCE contract;
    the DeiT training objective supervises them separately (class head
    by the labels, distillation head by the teacher —
    ``parallel/train.make_distill_train_step``)."""
    hp = params.get("head") or {}
    if "w" not in hp:
        raise ValueError("head_split needs a classifier head "
                         "(num_classes=0 variants have none)")
    cls = L.linear(x[:, 0], hp["w"], hp["b"])
    hd = params.get("head_dist") or {}
    if "w" not in hd:
        return cls, None
    return cls, L.linear(x[:, 1], hd["w"], hd["b"])


# -- monolithic forward (bench/training path) -----------------------------------


def forward(
    params: Params,
    images: jnp.ndarray,
    cfg: ViTConfig,
    want_attn: bool = False,
    want_cls_trajectory: bool = False,
    attn_impl=None,
    pad_tokens: bool = False,
    qkv_head_major: bool = False,
    block_wrapper=None,
    attn_heads=None,
) -> Dict[str, jnp.ndarray]:
    """Full forward with optional taps.

    Returns {"logits": [B,K]} plus, when requested:
      "attn":     [L,B,H,N,N] per-layer attention maps
      "rollout":  [B,N,N] attention rollout (config 2 visualization)
      "cls":      [L+1,B,D] CLS-token trajectory through the blocks

    ``attn_heads``: static head subset for the attention taps — each
    layer's map becomes [B, len(attn_heads), N, N]; the rollout still
    averages ALL heads (it feeds on the head-mean). An EMPTY tuple means
    rollout-only: no per-head probs are tapped.

    ``pad_tokens``: run the trunk in a PADDED TOKEN DOMAIN — pad the
    sequence once after embedding to a multiple of 128 and keep it padded
    through every block (attention masks keys >= n_real; padded rows carry
    garbage sliced away at tap extraction; numerically identical for real
    rows since masked keys underflow to exactly 0 in the softmax).
    Off by default: the MLP dominates FLOPs and would pay the +30%
    padding (197->256), and XLA and the attention kernel take exact
    token counts.
    """
    x = embed(params, images, cfg)
    n_real = x.shape[1]
    n_pad = (n_real + 127) // 128 * 128 if pad_tokens else n_real
    if n_pad != n_real:
        x = jnp.pad(x, ((0, 0), (0, n_pad - n_real), (0, 0)))
    nr = n_real if n_pad != n_real else None

    if block_wrapper is not None:
        # training hook: wrap each block as one (p, x) -> x unit (e.g.
        # ``jax.checkpoint`` for remat) — THE trunk lives here, so the
        # remat path cannot drift from the inference path. Taps don't
        # compose with a single-output wrapper.
        if want_attn or want_cls_trajectory:
            raise ValueError("block_wrapper requires taps off")

        def one(p, x):
            y, _, _ = block(
                p, x, cfg, attn_impl=attn_impl, n_real=nr,
                qkv_head_major=qkv_head_major,
            )
            return y

        one = block_wrapper(one)
        for p in params["blocks"]:
            x = one(p, x)
        return {"logits": head(
            params, final_norm(params, x[:, : cfg.prefix_tokens], cfg))}

    attns: List[jnp.ndarray] = []
    means: List[jnp.ndarray] = []
    cls_traj: List[jnp.ndarray] = [x[:, 0]]
    want_probs = want_attn and (attn_heads is None or len(attn_heads) > 0)
    for p in params["blocks"]:
        x, probs, pmean = block(
            p, x, cfg, want_attn=want_probs, attn_impl=attn_impl,
            n_real=nr, want_mean=want_attn, qkv_head_major=qkv_head_major,
            attn_heads=attn_heads if want_probs else None,
        )
        if want_probs:
            # tap in activation dtype: the softmax ran f32, but emitting
            # f32 maps doubles the dominant HBM write traffic (L*B*H*N^2);
            # slice real rows/cols here (padded rows are garbage)
            attns.append(probs[..., :n_real, :n_real].astype(x.dtype))
        if want_attn:
            means.append(pmean[..., :n_real, :n_real])
        if want_cls_trajectory:
            cls_traj.append(x[:, 0])
    # head reads only the CLS token and LayerNorm is per-token, so norm
    # just that row: skips a [B, N, D] reduce fusion the logits never use
    # (the graph path's `norm` node still norms every token — it's tappable)
    out: Dict[str, jnp.ndarray] = {
        "logits": head(
            params, final_norm(params, x[:, : cfg.prefix_tokens], cfg))
    }
    if want_attn:
        if want_probs:
            # tuple, NOT stacked: stacking copies L*B*H*N^2 bytes for
            # nothing (callers wanting one array can jnp.stack; taps ship
            # per-layer)
            out["attn"] = tuple(attns)
        # rollout from the per-layer head-means
        out["rollout"] = attn_ops.attention_rollout(means)
    if want_cls_trajectory:
        out["cls"] = jnp.stack(cls_traj)
    return out


# -- graph-node decomposition ---------------------------------------------------


def parse_attn_heads(node_params) -> Optional[Tuple[int, ...]]:
    """attn_heads node param -> head tuple, or None for ALL heads.

    A STATIC param (shape-changing, so it participates in the compile
    signature; selecting heads recompiles, scrubbing values does not).
    "[]" (and "") mean ALL heads, as the UI placeholder documents.
    Shared by every transformer family's block nodes (vit, moe) so the UI control behaves identically.
    """
    if node_params and node_params.get("attn_heads"):
        import json as _json

        parsed = _json.loads(node_params["attn_heads"])
        return tuple(int(h) for h in parsed) if parsed else None
    return None


def rollout_carry(pmean: jnp.ndarray, ins, x: jnp.ndarray) -> jnp.ndarray:
    """The "r" channel: rollout flows along the chain — r_out =
    step(head_mean, r_in); an unwired r input means "this is the first
    tapped block" (identity rollout). Feeds on the head-mean, so an
    "r"-only tap ships no [B,H,N,N] probs. Shared by every transformer
    family's block nodes."""
    b, n = x.shape[0], x.shape[1]
    r_in = ins.get("r")
    if r_in is None:
        r_in = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (b, n, n))
    return attn_ops.rollout_step(pmean, r_in).astype(x.dtype)


def layer_fns(cfg: ViTConfig, attn_impl=None, qkv_head_major: bool = False):
    """The model as an ordered list of named tappable layers.

    Each entry is ``(layer_name, extra_out_channels, fn)`` with
    ``fn(params_subtree, ins) -> outs``; channel "o" carries the flowing
    activation (the reference's single-channel contract,
    ``context.py:94-96``), extra channels carry taps (attention maps).

    The plugin tier turns each entry into a registered NodeKind named
    ``f"{cfg.name}:{layer_name}"`` and chains them in the generated graph
    JSON, exactly as the reference did for VGG16's 42 nodes
    (``context.py:55-73``).
    """
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], cfg.img_size)}

    def embed_fn(p, ins):
        # unbatched [C,H,W] inputs get a batch dim; downstream stays
        # batched (the graph contract is batch-carrying end-to-end)
        x = ins["o"]
        if x.ndim == 3:
            x = x[None]
        return {"o": embed(p, x, cfg)}

    layers.append(("transform", [], transform_fn))
    layers.append(("embed", [], embed_fn))

    def make_block_fn(i):
        def block_fn(p, ins, want=frozenset(), node_params=None):
            x = ins["o"]
            sel = parse_attn_heads(node_params)
            y, probs, pmean = block(
                p, x, cfg, want_attn="attn" in want,
                attn_impl=attn_impl, want_mean="r" in want,
                qkv_head_major=qkv_head_major, attn_heads=sel,
            )
            outs = {"o": y}
            if probs is not None and "attn" in want:
                outs["attn"] = probs
            if "r" in want:
                outs["r"] = rollout_carry(pmean, ins, x)
            if "cls" in want:
                # CLS-token trajectory tap: [B, D] after this block
                outs["cls"] = y[:, 0]
            return outs

        return block_fn

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn", "r", "cls"], make_block_fn(i)))

    def norm_fn(p, ins):
        return {"o": final_norm({"norm": p}, ins["o"], cfg)}

    def head_fn(p, ins):
        # distilled layer_params hands {"head":…, "head_dist":…}; plain
        # hands the bare head subtree (capture paths stay stable)
        return {"o": head(p if "head" in p else {"head": p}, ins["o"])}

    layers.append(("norm", [], norm_fn))
    layers.append(("head", [], head_fn))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    """Select the param subtree a named layer closes over."""
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        sub = {
            "patch_embed": params["patch_embed"],
            "cls_token": params["cls_token"],
            "pos_emb": params["pos_emb"],
        }
        if "dist_token" in params:
            sub["dist_token"] = params["dist_token"]
        if "reg_tokens" in params:
            sub["reg_tokens"] = params["reg_tokens"]
        return sub
    if layer_name == "norm":
        return params["norm"]
    if layer_name == "head":
        if "head_dist" in params:
            return {"head": params["head"],
                    "head_dist": params["head_dist"]}
        return params["head"]
    return {}  # transform has no params
