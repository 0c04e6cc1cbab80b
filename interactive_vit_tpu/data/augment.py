"""Jitted on-device training augmentations (flip / shift / color / cutout
/ mixup / cutmix).

The reference never trains (``/root/reference/main/context.py:79-88`` runs
under ``torch.no_grad``), so there is no analog; this is the standard ViT
training recipe's augmentation stack rebuilt on-device: every op is a
**static-shape jittable function of a PRNG key** — the whole pipeline
traces into one XLA program and runs on device next to the train step (no
host-side PIL/numpy per-batch work, no H2D traffic beyond the raw batch).
Randomness is `jax.random` (fold the step index into a session key), so
augmentation is deterministic per (seed, step) across restarts — matching
the deterministic-loader discipline of ``data/loader.py``.

Image layout is the framework-wide ``[B, 3, H, W]`` float32/bfloat16 (the
``:transform`` node contract). Mixing ops return SOFT labels ``[B, C]``;
``parallel.train.cross_entropy`` accepts either int or soft labels.

Design notes:
- per-image crops/cutout use iota-mask arithmetic, not dynamic slices —
  masks vectorize over the batch with zero gather/scatter and fuse into
  the surrounding elementwise ops;
- mixup/cutmix pair each image with the batch-reversed one (the timm
  "batch" mode): ``x[::-1]`` is one reshuffle, static shapes, and under
  DP it stays a single cheap collective permute;
- cutmix's label weight is recomputed from the CLIPPED box area (the
  standard correction), so labels always match the pixels actually mixed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation recipe; every field off (0/False) = identity.

    hflip: random horizontal flip per image (p=0.5).
    crop_pad: zero-pad each side by this many pixels, then take a random
        HxW crop (the CIFAR shift augmentation; 4 is the classic value).
    color_jitter: strength s -> per-image brightness/contrast/saturation
        factors drawn from U[1-s, 1+s] (applied in that fixed order;
        saturation interpolates with the channel-mean gray image).
    cutout: side (pixels) of a zero-filled square at a random position
        per image (random-erasing class; 0 = off).
    mixup_alpha: Beta(a, a) mixup over the batch-reversed pairing.
    cutmix_alpha: Beta(a, a) cutmix (box paste) over the same pairing.
    switch_prob: when BOTH mixup and cutmix are enabled, per-batch
        probability of choosing cutmix for this step.
    """

    hflip: bool = False
    crop_pad: int = 0
    color_jitter: float = 0.0
    cutout: int = 0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    switch_prob: float = 0.5

    @property
    def enabled(self) -> bool:
        return bool(self.hflip or self.crop_pad or self.color_jitter
                    or self.cutout or self.mixup_alpha or self.cutmix_alpha)

    @property
    def mixes(self) -> bool:
        """Whether labels come out soft ([B, C])."""
        return bool(self.mixup_alpha or self.cutmix_alpha)


def _hflip(key, x):
    flip = jax.random.bernoulli(key, 0.5, (x.shape[0],))
    return jnp.where(flip[:, None, None, None], x[..., ::-1], x)


def _shift_crop(key, x, pad: int):
    """Zero-pad by ``pad`` and take a random same-size crop per image.

    Implemented as a roll-style iota gather on the padded canvas: output
    pixel (i, j) reads padded (i + oy, j + ox) with per-image integer
    offsets in [0, 2*pad] — `take_along_axis` over each spatial dim keeps
    shapes static and batches on the device.
    """
    b, _, h, w = x.shape
    kh, kw = jax.random.split(key)
    oy = jax.random.randint(kh, (b,), 0, 2 * pad + 1)
    ox = jax.random.randint(kw, (b,), 0, 2 * pad + 1)
    xp = jnp.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    rows = oy[:, None] + jnp.arange(h)[None, :]          # [B, H]
    xp = jnp.take_along_axis(xp, rows[:, None, :, None], axis=2)
    cols = ox[:, None] + jnp.arange(w)[None, :]          # [B, W]
    return jnp.take_along_axis(xp, cols[:, None, None, :], axis=3)


def _color_jitter(key, x, s: float):
    b = x.shape[0]
    kb, kc, ks = jax.random.split(key, 3)
    lo, hi = 1.0 - s, 1.0 + s
    fb = jax.random.uniform(kb, (b, 1, 1, 1), x.dtype, lo, hi)
    fc = jax.random.uniform(kc, (b, 1, 1, 1), x.dtype, lo, hi)
    fs = jax.random.uniform(ks, (b, 1, 1, 1), x.dtype, lo, hi)
    x = x * fb                                            # brightness
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    x = (x - mean) * fc + mean                            # contrast
    gray = x.mean(axis=1, keepdims=True)
    return (x - gray) * fs + gray                         # saturation


def _box_mask(key, b: int, h: int, w: int, bh, bw):
    """[B, 1, H, W] bool: True INSIDE a per-image random box of (clipped)
    size ``bh x bw`` centered uniformly. ``bh/bw`` may be scalars or [B].
    Returns (mask, inside_area [B])."""
    kh, kw = jax.random.split(key)
    cy = jax.random.randint(kh, (b,), 0, h)
    cx = jax.random.randint(kw, (b,), 0, w)
    bh = jnp.broadcast_to(jnp.asarray(bh), (b,))
    bw = jnp.broadcast_to(jnp.asarray(bw), (b,))
    y0 = jnp.clip(cy - bh // 2, 0, h)
    y1 = jnp.clip(cy - bh // 2 + bh, 0, h)
    x0 = jnp.clip(cx - bw // 2, 0, w)
    x1 = jnp.clip(cx - bw // 2 + bw, 0, w)
    ys = jnp.arange(h)[None, :]
    xs = jnp.arange(w)[None, :]
    in_y = (ys >= y0[:, None]) & (ys < y1[:, None])       # [B, H]
    in_x = (xs >= x0[:, None]) & (xs < x1[:, None])       # [B, W]
    mask = in_y[:, None, :, None] & in_x[:, None, None, :]
    area = (y1 - y0) * (x1 - x0)
    return mask, area


def _cutout(key, x, side: int):
    mask, _ = _box_mask(key, x.shape[0], x.shape[2], x.shape[3], side, side)
    return jnp.where(mask, jnp.zeros((), x.dtype), x)


def _one_hot(labels, num_classes: int):
    if labels.ndim == 2:
        return labels.astype(jnp.float32)
    return jax.nn.one_hot(labels, num_classes, dtype=jnp.float32)


def _mixup(key, x, y, alpha: float):
    lam = jax.random.beta(key, alpha, alpha, ())
    # batch-reversed pairing; symmetric, so pin lam >= 0.5 to avoid the
    # degenerate "every image mostly its partner" half of the Beta
    lam = jnp.maximum(lam, 1.0 - lam).astype(jnp.float32)
    xm = x * lam.astype(x.dtype) + x[::-1] * (1.0 - lam).astype(x.dtype)
    ym = y * lam + y[::-1] * (1.0 - lam)
    return xm, ym


def _cutmix(key, x, y, alpha: float):
    b, _, h, w = x.shape
    kl, kb = jax.random.split(key)
    lam = jax.random.beta(kl, alpha, alpha, ())
    lam = jnp.maximum(lam, 1.0 - lam)
    ratio = jnp.sqrt(1.0 - lam)                           # box covers 1-lam
    bh = (ratio * h).astype(jnp.int32)
    bw = (ratio * w).astype(jnp.int32)
    mask, area = _box_mask(kb, b, h, w, bh, bw)
    xm = jnp.where(mask, x[::-1], x)
    # label weight from the CLIPPED box (it may hang off the edge):
    # per-image, unlike scalar lam — the standard cutmix correction
    lam_adj = 1.0 - area.astype(jnp.float32) / float(h * w)  # [B]
    ym = y * lam_adj[:, None] + y[::-1] * (1.0 - lam_adj[:, None])
    return xm, ym


def augment(key, images, labels, num_classes: int,
            cfg: AugmentConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply ``cfg`` to one batch. Jittable; static shapes.

    Returns ``(images, labels)`` — labels come back unchanged (int) when
    no mixing op is enabled, else soft ``[B, C]`` float32. ``cfg`` must be
    a static argument under ``jax.jit`` (each field toggles traced ops).
    """
    k = dict(zip(
        ("flip", "crop", "color", "cut", "mix", "switch"),
        jax.random.split(key, 6)))
    if cfg.hflip:
        images = _hflip(k["flip"], images)
    if cfg.crop_pad:
        images = _shift_crop(k["crop"], images, cfg.crop_pad)
    if cfg.color_jitter:
        images = _color_jitter(k["color"], images, cfg.color_jitter)
    if cfg.cutout:
        images = _cutout(k["cut"], images, cfg.cutout)
    if cfg.mixes:
        y = _one_hot(labels, num_classes)
        if cfg.mixup_alpha and cfg.cutmix_alpha:
            images, labels = jax.lax.cond(
                jax.random.bernoulli(k["switch"], cfg.switch_prob),
                lambda a: _cutmix(k["mix"], *a, cfg.cutmix_alpha),
                lambda a: _mixup(k["mix"], *a, cfg.mixup_alpha),
                (images, y))
        elif cfg.cutmix_alpha:
            images, labels = _cutmix(k["mix"], images, y, cfg.cutmix_alpha)
        else:
            images, labels = _mixup(k["mix"], images, y, cfg.mixup_alpha)
    return images, labels


def make_augment_fn(cfg: AugmentConfig, num_classes: int,
                    base_key=None, batch_sharding=None):
    """``(step, images, labels) -> (images, labels)``, jitted once.

    Folds ``step`` into ``base_key`` so augmentation is deterministic per
    (seed, step) — resume replays the same stream. ``batch_sharding``
    (a NamedSharding) pins images/labels to the data axis under a mesh.
    Returns None when ``cfg`` is all-off, so callers can skip the stage.
    """
    if not cfg.enabled:
        return None
    key = base_key if base_key is not None else jax.random.key(0)

    def fn(step, images, labels):
        return augment(jax.random.fold_in(key, step), images, labels,
                       num_classes, cfg)

    sh = batch_sharding
    return jax.jit(fn, in_shardings=(None, sh, sh) if sh else None)
