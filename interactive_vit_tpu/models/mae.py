"""Masked-autoencoder (MAE) self-supervised pretraining for the ViT family.

The reference is inference-only (``torch.no_grad()``,
``/root/reference/main/context.py:80``) and ships pretrained torchvision
weights (``/root/reference/static/models/vgg16.py:11-14``); this image has
ZERO egress, so pretrained weights cannot be downloaded at all. MAE closes
that gap from first principles: pretrain an encoder on unlabeled images
(the masked-reconstruction objective of He et al. 2022, "Masked Autoencoders
Are Scalable Vision Learners"), then export the trunk as a standard ViT
checkpoint every serving/finetune path already loads.

Design decisions:

- **Static shapes end-to-end.** The mask ratio fixes ``len_keep`` at trace
  time; per-image randomness is a ``jax.random`` key threaded through the
  jitted step (deterministic per (seed, step), same policy as
  ``data/augment.py``). No dynamic shapes, no recompiles across steps.
- **Masking is two argsorts + two gathers per batch** ([B, L] iota-class
  work, ≪1% of a step) — the published random-shuffle construction maps
  directly onto ``jnp.argsort``/``take_along_axis``; everything downstream
  is dense matmuls over the kept tokens.
- **The encoder IS ``models/vit.py``**: same param layout, same
  ``vit.block`` trunk, so the pretrained subtree exports byte-for-byte as a
  plain ViT checkpoint (``encoder_params``) and cannot drift from the
  serving forward. Pretraining computes attention over only
  ``1 + len_keep`` tokens — the 75%-mask default makes each step ~3x
  cheaper than a supervised step at the same batch.
- Position embeddings are LEARNED (matching this repo's ViT; the paper
  uses fixed sin-cos) — the exported trunk must match what
  ``vit.init_params`` serves.

Deviations from the paper, both deliberate: learned (not sin-cos) position
tables as above, and the decoder prediction head keeps its bias (harmless).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    name: str
    encoder: str                # plain-ViT variant name (``vit.VARIANTS``)
    dec_width: int = 512
    dec_depth: int = 8
    dec_heads: int = 16
    mask_ratio: float = 0.75
    norm_pix: bool = True       # per-patch-normalized targets (paper default)
    # direct encoder config (bypasses the variant registry) — toy
    # topologies for gates/tests; normal use resolves ``encoder`` by name
    enc_override: Optional[vit.ViTConfig] = None

    @property
    def enc_cfg(self) -> vit.ViTConfig:
        """Encoder config: the named variant as a feature extractor.

        Restricted to plain ViTs (no distilled/register prefixes): MAE's
        shuffle operates on the patch-token tail and assumes exactly one
        prefix token (CLS)."""
        cfg = self.enc_override or vit.resolve_variant(self.encoder)
        if cfg.prefix_tokens != 1:
            raise ValueError(
                f"MAE encoder must be a plain ViT (one CLS prefix); "
                f"{self.encoder} has {cfg.prefix_tokens} prefix tokens")
        return dataclasses.replace(cfg, num_classes=0)

    @property
    def dec_cfg(self) -> vit.ViTConfig:
        """Decoder trunk as a ViTConfig so ``vit.block`` runs it; the
        img/patch fields are inherited for bookkeeping only."""
        e = self.enc_cfg
        return dataclasses.replace(
            e, name=self.name + ":dec", width=self.dec_width,
            depth=self.dec_depth, heads=self.dec_heads, num_classes=0)

    @property
    def grid(self) -> Tuple[int, int]:
        e = self.enc_cfg
        g = e.img_size // e.patch
        return g, g

    @property
    def num_patches(self) -> int:
        g, _ = self.grid
        return g * g

    def len_keep(self, mask_ratio: Optional[float] = None) -> int:
        """Visible-token count for a ratio — STATIC (fixed at trace time)."""
        r = self.mask_ratio if mask_ratio is None else float(mask_ratio)
        if not 0.0 <= r < 1.0:
            raise ValueError(f"mask_ratio {r} must be in [0, 1)")
        keep = self.num_patches - int(round(self.num_patches * r))
        return max(1, keep)


VARIANTS: Dict[str, MAEConfig] = {
    # decoder dims scale with the encoder (paper: ViT-B/L share a 512x8
    # decoder; the tiny/small decoders here keep the same ~2/3 width ratio
    # so CPU tests stay fast)
    "mae_t16": MAEConfig("mae_t16", "vit_t16", dec_width=128, dec_depth=4,
                         dec_heads=4),
    "mae_s16": MAEConfig("mae_s16", "vit_s16", dec_width=256, dec_depth=4,
                         dec_heads=8),
    "mae_b16": MAEConfig("mae_b16", "vit_b16", dec_width=512, dec_depth=8,
                         dec_heads=16),
}


def resolve_variant(name: str) -> MAEConfig:
    """``"mae_t16"`` or ``"mae_t16@64"`` (derived encoder resolution, the
    ``vit.resolve_variant`` grammar applied to the encoder)."""
    base, sep, suffix = name.partition("@")
    if base not in VARIANTS:
        raise ValueError(
            f"unknown MAE variant {base!r}; known: {sorted(VARIANTS)}")
    cfg = VARIANTS[base]
    if sep:
        cfg = dataclasses.replace(
            cfg, name=name, encoder=f"{cfg.encoder}@{suffix}")
        cfg.enc_cfg  # validate the suffix eagerly
    return cfg


# -- init -----------------------------------------------------------------


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: MAEConfig, dtype=jnp.float32) -> Params:
    """{"enc": <plain ViT params, head={}>, "dec": {...}}.

    The encoder subtree is EXACTLY ``vit.init_params(enc_cfg)`` — that is
    the export contract (``encoder_params``)."""
    ke, kd, km, kb, kp = jax.random.split(key, 5)
    e, d = cfg.enc_cfg, cfg.dec_cfg
    dec_trunk = vit.init_params(kd, d, dtype=dtype)
    patch_dim = e.in_chans * e.patch * e.patch
    dec = {
        "embed": {
            "w": (jax.random.normal(kb, (e.width, d.width), jnp.float32)
                  * (e.width ** -0.5)).astype(dtype),
            "b": jnp.zeros((d.width,), dtype),
        },
        "mask_token": jnp.zeros((1, 1, d.width), dtype),
        "pos_emb": (jax.random.normal(km, (1, cfg.num_patches + 1, d.width),
                                      jnp.float32) * 0.02).astype(dtype),
        "blocks": dec_trunk["blocks"],
        "norm": dec_trunk["norm"],
        "pred": {
            "w": (jax.random.normal(kp, (d.width, patch_dim), jnp.float32)
                  * (d.width ** -0.5)).astype(dtype),
            "b": jnp.zeros((patch_dim,), dtype),
        },
    }
    return {"enc": vit.init_params(ke, e, dtype=dtype), "dec": dec}


def encoder_params(params: Params) -> Params:
    """The pretrained trunk as a standard plain-ViT checkpoint tree
    (num_classes=0 feature extractor — loadable by serving ``--ckpt``,
    ``tools/convert``, and as a finetune init via ``load_encoder_into``)."""
    return params["enc"]


def load_encoder_into(vit_params: Params, enc: Params,
                      cfg: Optional[vit.ViTConfig] = None) -> Params:
    """Overwrite ``vit_params``' trunk with a pretrained MAE encoder,
    keeping the (fresh) classifier head — the finetune/linear-probe init.
    Pass the target ``cfg`` to adapt the trunk (position table, patch
    kernel) when the target geometry differs from the pretrain one."""
    out = dict(vit_params)
    for k in ("patch_embed", "cls_token", "pos_emb", "blocks", "norm"):
        out[k] = enc[k]
    if cfg is not None:
        out = vit.adapt_checkpoint(out, cfg)
    return out


# -- masking ----------------------------------------------------------------


def random_masking(key: jax.Array, batch: int, length: int,
                   len_keep: int) -> Tuple[jnp.ndarray, jnp.ndarray,
                                           jnp.ndarray]:
    """Per-image uniform random masking (the published construction).

    Returns ``(ids_keep [B, K] int32, mask [B, L] f32 (1 = masked),
    ids_restore [B, L] int32)``. ``ids_restore[b, i]`` is position ``i``'s
    rank in the shuffle, so ``mask = ids_restore >= len_keep`` — no third
    gather. Static shapes; ~[B, L] argsort work, negligible next to the
    trunk matmuls."""
    noise = jax.random.uniform(key, (batch, length))
    ids_shuffle = jnp.argsort(noise, axis=1).astype(jnp.int32)
    ids_restore = jnp.argsort(ids_shuffle, axis=1).astype(jnp.int32)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = (ids_restore >= len_keep).astype(jnp.float32)
    return ids_keep, mask, ids_restore


# -- forward ----------------------------------------------------------------


def encode(params: Params, images: jnp.ndarray, cfg: MAEConfig,
           ids_keep: Optional[jnp.ndarray] = None,
           block_wrapper=None) -> jnp.ndarray:
    """Patch-embed + pos (the full grid), keep-token gather, encoder trunk.

    ``ids_keep=None`` runs all tokens — that path IS the plain ViT feature
    forward (parity-pinned in tests). [B,C,H,W] -> [B, 1+K, D] final-norm
    features, CLS first."""
    e = cfg.enc_cfg
    enc = params["enc"]
    x = vit.embed(enc, images, e)          # [B, 1+L, D], pos already added
    if ids_keep is not None:
        cls, tok = x[:, :1], x[:, 1:]
        tok = jnp.take_along_axis(tok, ids_keep[:, :, None], axis=1)
        x = jnp.concatenate([cls, tok], axis=1)

    def one(p, x):
        y, _, _ = vit.block(p, x, e)
        return y

    if block_wrapper is not None:
        one = block_wrapper(one)
    for p in enc["blocks"]:
        x = one(p, x)
    return vit.final_norm(enc, x, e)


def decode(params: Params, x_enc: jnp.ndarray, ids_restore: jnp.ndarray,
           cfg: MAEConfig, block_wrapper=None) -> jnp.ndarray:
    """Narrow decoder: embed, re-insert mask tokens at their original
    positions (one gather), decoder pos table, trunk, per-patch pixel
    prediction. [B, 1+K, D] -> [B, L, p*p*C]."""
    dec = params["dec"]
    d = cfg.dec_cfg
    x = L.linear(x_enc, dec["embed"]["w"], dec["embed"]["b"])  # [B, 1+K, Dd]
    b, n_vis, dd = x.shape
    length = ids_restore.shape[1]
    mask_tok = jnp.broadcast_to(
        dec["mask_token"].astype(x.dtype), (b, length - (n_vis - 1), dd))
    # shuffled order: kept tokens first, mask tokens after; the restore
    # gather returns every token to its grid position
    x_ = jnp.concatenate([x[:, 1:], mask_tok], axis=1)          # [B, L, Dd]
    x_ = jnp.take_along_axis(x_, ids_restore[:, :, None], axis=1)
    x = jnp.concatenate([x[:, :1], x_], axis=1)                 # [B, 1+L, Dd]
    x = x + dec["pos_emb"].astype(x.dtype)

    def one(p, x):
        y, _, _ = vit.block(p, x, d)
        return y

    if block_wrapper is not None:
        one = block_wrapper(one)
    for p in dec["blocks"]:
        x = one(p, x)
    x = L.layer_norm(x, dec["norm"]["s"], dec["norm"]["b"], d.ln_eps)
    pred = L.linear(x, dec["pred"]["w"], dec["pred"]["b"])
    return pred[:, 1:]  # drop CLS


def patch_targets(images: jnp.ndarray, cfg: MAEConfig,
                  norm_pix: Optional[bool] = None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reconstruction targets [B, L, p*p*C] in f32, plus the per-patch
    (mean, rstd) used when ``norm_pix`` (needed again to UN-normalize
    predictions for visualization)."""
    e = cfg.enc_cfg
    t = L.patchify(images, e.patch).astype(jnp.float32)
    use_norm = cfg.norm_pix if norm_pix is None else norm_pix
    if not use_norm:
        z = jnp.zeros(t.shape[:2] + (1,), jnp.float32)
        return t, z, z + 1.0
    mean = t.mean(axis=-1, keepdims=True)
    var = t.var(axis=-1, keepdims=True)
    rstd = jax.lax.rsqrt(var + 1e-6)
    return (t - mean) * rstd, mean, rstd


def forward_pretrain(params: Params, images: jnp.ndarray, cfg: MAEConfig,
                     key: jax.Array, mask_ratio: Optional[float] = None,
                     block_wrapper=None) -> Dict[str, jnp.ndarray]:
    """One masked-reconstruction pass.

    Returns {"loss": scalar f32, "pred": [B, L, p*p*C], "mask": [B, L]}.
    Loss = mean squared error over MASKED patches only (f32), per the
    published objective."""
    e = cfg.enc_cfg
    b = images.shape[0]
    keep = cfg.len_keep(mask_ratio)
    if keep >= cfg.num_patches:
        raise ValueError(
            f"mask_ratio leaves no masked patches to reconstruct "
            f"(len_keep {keep} of {cfg.num_patches})")
    images = images.astype(_act_dtype(params))
    ids_keep, mask, ids_restore = random_masking(
        key, b, cfg.num_patches, keep)
    z = encode(params, images, cfg, ids_keep, block_wrapper=block_wrapper)
    pred = decode(params, z, ids_restore, cfg, block_wrapper=block_wrapper)
    target, _, _ = patch_targets(images, cfg)
    per_patch = jnp.square(pred.astype(jnp.float32) - target).mean(axis=-1)
    loss = (per_patch * mask).sum() / mask.sum()
    return {"loss": loss, "pred": pred, "mask": mask}


def _act_dtype(params: Params):
    w = params["enc"]["patch_embed"]["w"]
    return w.dtype if hasattr(w, "dtype") else jnp.float32


# -- visualization (the product surface) -------------------------------------


def unpatchify(patches: jnp.ndarray, patch: int, grid: Tuple[int, int],
               chans: int = 3) -> jnp.ndarray:
    """[B, L, C*p*p] -> [B, C, H, W]; exact inverse of ``L.patchify``."""
    b = patches.shape[0]
    gh, gw = grid
    x = patches.reshape(b, gh, gw, chans, patch, patch)
    x = x.transpose(0, 3, 1, 4, 2, 5)  # [B, C, gh, ph, gw, pw]
    return x.reshape(b, chans, gh * patch, gw * patch)


def reconstruct(params: Params, images: jnp.ndarray, cfg: MAEConfig,
                key: jax.Array, mask_ratio: Optional[float] = None,
                ) -> Dict[str, jnp.ndarray]:
    """The interactive MAE demo: mask, reconstruct, compose viewables.

    Returns (all image-space tensors [B, C, H, W] except "err"/"mask"):
      "o":      visible patches from the input, masked patches from the
                prediction (the paper's headline figure)
      "masked": the input with masked patches zeroed (what the encoder saw)
      "err":    per-patch masked-reconstruction MSE heatmap [B, gh, gw]
      "mask":   the binary patch mask [B, gh, gw] (1 = masked)
    Predictions un-normalize with the target patch statistics when the
    config trains on normalized pixels (the standard visualization)."""
    e = cfg.enc_cfg
    b = images.shape[0]
    keep = cfg.len_keep(mask_ratio)
    images = images.astype(_act_dtype(params))
    ids_keep, mask, ids_restore = random_masking(
        key, b, cfg.num_patches, keep)
    z = encode(params, images, cfg, ids_keep)
    pred = decode(params, z, ids_restore, cfg).astype(jnp.float32)
    target, t_mean, t_rstd = patch_targets(images, cfg)
    if cfg.norm_pix:
        pred_pix = pred / t_rstd + t_mean   # back to pixel space
    else:
        pred_pix = pred
    raw = L.patchify(images, e.patch).astype(jnp.float32)
    m = mask[:, :, None]
    pasted = raw * (1.0 - m) + pred_pix * m
    per_patch = (jnp.square(pred - target).mean(axis=-1) * mask)
    gh, gw = cfg.grid
    out_dtype = images.dtype
    return {
        "o": unpatchify(pasted, e.patch, cfg.grid,
                        e.in_chans).astype(out_dtype),
        "masked": unpatchify(raw * (1.0 - m), e.patch, cfg.grid,
                             e.in_chans).astype(out_dtype),
        "err": per_patch.reshape(b, gh, gw),
        "mask": mask.reshape(b, gh, gw),
    }
