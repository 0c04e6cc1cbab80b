"""Fused preprocessing as matmuls: resize + crop + normalize + patchify.

The BASELINE north star calls for preprocessing fused into the device
program. The trick: antialiased bilinear resize is SEPARABLE, so
``resize(x)`` is ``R_h @ x @ R_w^T`` with small dense weight matrices — a
gather-free formulation that runs as matmuls instead of gathers. The
center crop folds in for free as row selection of R (we multiply
by exactly the rows that survive the crop), the per-channel normalization is
a trailing affine XLA fuses into the matmul epilogue, and patchify+embed is
already one matmul (``ops/layers.patch_embed``). Net: the whole eval
transform of the reference's ``vgg16:transform``
(``/root/reference/static/models/vgg16.py:40-42``) becomes two batched
matmuls per image.

Weight matrices replicate ``jax.image.resize(..., "bilinear")`` semantics
(half-pixel centers, triangle kernel dilated by the scale factor when
downsampling = antialiasing, rows renormalized), so this path is
numerically interchangeable with ``ops/layers.preprocess`` (parity-tested).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.ops.layers import mm_precision


def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


def _cubic(t: float, a: float = -0.5) -> float:
    """Keys cubic kernel, a=-0.5: the PIL/CLIP bicubic (and torch's
    antialiased bicubic). Support 2."""
    t = abs(t)
    if t < 1.0:
        return (a + 2.0) * t * t * t - (a + 3.0) * t * t + 1.0
    if t < 2.0:
        return a * (t * t * t - 5.0 * t * t + 8.0 * t - 4.0)
    return 0.0


_KERNELS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int,
                  method: str = "bilinear") -> np.ndarray:
    """[out_size, in_size] antialiased resampling matrix.

    Half-pixel centers; the kernel dilates by the scale factor when
    downsampling (= antialiasing, PIL semantics) and rows renormalize —
    so "bilinear" matches ``jax.image.resize(..., "bilinear")`` /
    torchvision's antialiased bilinear, and "bicubic" matches PIL's
    BICUBIC (Keys a=-0.5) = the exact OpenAI CLIP eval resize."""
    kernel, base_support = _KERNELS[method]
    scale = in_size / out_size
    fscale = max(1.0, scale)  # kernel dilation when downsampling
    support = base_support * fscale
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        for j in range(max(0, lo), min(in_size, hi + 1)):
            w[i, j] = kernel((j - center) / fscale)
        s = w[i].sum()
        if s > 0:
            w[i] /= s
    return w


# the single copy of the shorter-side resize math lives in layers.py —
# the two preprocess paths are parity-coupled and must not drift
from interactive_vit_tpu.ops.layers import target_dims as _target_dims


def preprocess_mm(
    images: jnp.ndarray,
    size: int,
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
    resize_to: Optional[int] = None,
    method: str = "bilinear",
) -> jnp.ndarray:
    """resize -> center crop -> normalize via two matmuls.

    [B, C, H, W] or [C, H, W] in [0, 1] -> [..., C, size, size].
    ``method="bicubic"`` selects the PIL-exact Keys a=-0.5 kernel
    (OpenAI CLIP's eval transform).
    """
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    b, c, h, w = images.shape
    nh, nw = _target_dims(h, w, size, resize_to)

    rh = resize_matrix(h, nh, method)
    rw = resize_matrix(w, nw, method)
    # fold the center crop into the resampling matrices: keep only the
    # output rows/cols inside the crop window
    top, left = (nh - size) // 2, (nw - size) // 2
    rh = jnp.asarray(rh[top : top + size])          # [size, H]
    rw = jnp.asarray(rw[left : left + size])        # [size, W]

    prec = mm_precision(images, rh)
    # rows: [size, H] @ [B*C, H, W] -> [B*C, size, W]
    x = images.reshape(b * c, h, w)
    x = jnp.einsum("sh,nhw->nsw", rh, x,
                   preferred_element_type=jnp.float32, precision=prec)
    # cols: [B*C, size, W] @ [W, size] -> [B*C, size, size]
    x = jnp.einsum("nsw,tw->nst", x, rw,
                   preferred_element_type=jnp.float32, precision=prec)
    x = x.reshape(b, c, size, size).astype(images.dtype)

    m = jnp.asarray(mean, x.dtype).reshape(1, -1, 1, 1)
    s = jnp.asarray(std, x.dtype).reshape(1, -1, 1, 1)
    x = (x - m) / s
    return x[0] if squeeze else x
