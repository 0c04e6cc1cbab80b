"""Transformer layer ops — jnp reference implementations.

These are the program on every backend, and the ground truth for the
attention kernel in ``ops/gpu_attention.py``. In f32 they hold the 1e-4
parity contract (BASELINE.json).

The reference app had no transformer at all (SURVEY.md §0 — its only model
was torchvision VGG16 run layer-at-a-time on CPU torch,
the reference's ``main/context.py:79-88``); these ops are the
capability mandated by BASELINE.json's north star.

Conventions:
* activations are ``[B, N, D]`` (batch, tokens, width), f32 or bf16;
* parameters are dicts of arrays (pytree leaves), f32 master copies;
* matmuls request f32 accumulation via ``preferred_element_type`` so bf16
  activations keep the parity contract.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

Params = Dict[str, jnp.ndarray]


def mm_precision(*xs: jnp.ndarray) -> jax.lax.Precision:
    """Matmul precision policy for the 1e-4 parity contract.

    f32 inputs -> HIGHEST: DEFAULT lets the backend use reduced-precision
    passes for f32 operands (TF32 tensor cores on a GPU, about three
    decimal digits), which silently breaks parity. bf16 inputs -> DEFAULT:
    the tensor cores multiply bf16 natively and accumulate f32 (via
    preferred_element_type), which is the fast path and exact at bf16
    input precision.
    """
    if any(x.dtype == jnp.float32 for x in xs):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def precision_for(dtype) -> jax.lax.Precision:
    """``mm_precision`` keyed by dtype instead of arrays, for code that
    builds closures before it has arrays. Same policy: f32 -> HIGHEST,
    everything else -> DEFAULT."""
    return (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)


def layer_norm(x: jnp.ndarray, scale: jnp.ndarray, bias: jnp.ndarray,
               eps: float = 1e-6) -> jnp.ndarray:
    """LayerNorm over the last axis, f32 statistics regardless of x dtype."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def gelu(x: jnp.ndarray) -> jnp.ndarray:
    """GELU, precision-adaptive.

    f32 -> exact erf GELU (matches torch ``nn.GELU()`` default; the 1e-4
    parity contract runs in f32). bf16 -> tanh approximation: cheaper
    than erf, and the erf-vs-tanh difference (~1e-3 relative) sits below
    bf16 activation noise.
    """
    return jax.nn.gelu(x, approximate=x.dtype != jnp.float32)


def linear(x: jnp.ndarray, w, b: Optional[jnp.ndarray]) -> jnp.ndarray:
    """x @ w + b with f32 accumulation. w is [D_in, D_out], either a dense
    array or a weight-only int8 dict (``ops/quant.py``): the per-column
    scale commutes with the matmul, so dequantization is a cheap column
    rescale of the f32 accumulator and the int8->activation-dtype convert
    fuses into the weight read."""
    from interactive_vit_tpu.ops.quant import (
        QKEY, SKEY, is_quantized, is_w8a8, linear_w8a8,
    )

    if is_w8a8(w):
        # int8 x int8 -> int32 dot; dynamic per-token activation
        # scales, opt-in accuracy class (ops/quant.py)
        return linear_w8a8(x, w, b)
    if is_quantized(w):
        y = jnp.dot(x, w[QKEY].astype(x.dtype),
                    preferred_element_type=jnp.float32,
                    precision=mm_precision(x))
        y = y * w[SKEY]
    else:
        y = jnp.dot(x, w, preferred_element_type=jnp.float32,
                    precision=mm_precision(x, w))
    if b is not None:
        y = y + b
    return y.astype(x.dtype)


def mlp(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    """Transformer MLP: linear -> GELU -> linear."""
    h = gelu(linear(x, p["fc1_w"], p["fc1_b"]))
    return linear(h, p["fc2_w"], p["fc2_b"])


def mlp_block(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    """Pre-LN MLP residual branch: x + MLP(LN(x))."""
    return x + mlp(layer_norm(x, p["ln2_s"], p["ln2_b"]), p)


def patchify(images: jnp.ndarray, patch: int) -> jnp.ndarray:
    """[B, C, H, W] -> [B, N, C*patch*patch] patch extraction.

    Layout matches a conv-style patch embedding: patches scan row-major over
    the image; features are (C, ph, pw) flattened in that order, so the
    downstream matmul weight is the conv kernel reshaped [D, C*p*p].T.
    """
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, ph, pw]
    return x.reshape(b, gh * gw, c * patch * patch)


def patch_embed(images: jnp.ndarray, p: Params, patch: int) -> jnp.ndarray:
    """Patchify + project: ONE big [B*N, C*p*p] @ [C*p*p, D] matmul.

    Equivalent to the usual stride-p conv but expressed as a matmul
    (BASELINE.json: "patch embedding is one HBM-resident matmul").
    """
    patches = patchify(images, patch)
    return linear(patches, p["w"], p["b"])


def add_cls_and_pos(x: jnp.ndarray, cls_token: jnp.ndarray,
                    pos_emb: jnp.ndarray) -> jnp.ndarray:
    """Prepend prefix token(s) and add positional embeddings.

    cls_token: [1, P, D] (P=1 plain ViT, P=2 DeiT CLS+DIST);
    pos_emb: [1, N+P, D].
    """
    b = x.shape[0]
    cls = jnp.broadcast_to(
        cls_token.astype(x.dtype),
        (b, cls_token.shape[1], x.shape[-1]))
    x = jnp.concatenate([cls, x], axis=1)
    return x + pos_emb.astype(x.dtype)


def imagenet_normalize(x: jnp.ndarray,
                       mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225)) -> jnp.ndarray:
    """Normalize [.., C, H, W] images in [0,1] with ImageNet statistics."""
    m = jnp.asarray(mean, x.dtype).reshape(-1, 1, 1)
    s = jnp.asarray(std, x.dtype).reshape(-1, 1, 1)
    return (x - m) / s


def target_dims(h: int, w: int, size: int,
                resize_to: Optional[int] = None):
    """Shorter-side resize target (nh, nw) for the eval transform.

    THE single copy of this math — ``preprocess`` (gather path) and
    ``preprocess_mm`` (matmul path) are parity-coupled, so the rounding
    must not be able to drift between them. Default ``resize_to`` is the
    ImageNet recipe (shorter side to size*256/224, crop ``size``); pass
    ``resize_to=size`` for recipes that resize the shorter side DIRECTLY
    to the crop size (OpenAI CLIP)."""
    if resize_to is None:
        resize_to = int(size * 256 / 224)
    if h < w:
        return resize_to, max(resize_to, int(round(w * resize_to / h)))
    return max(resize_to, int(round(h * resize_to / w))), resize_to


def preprocess(images: jnp.ndarray, size: int,
               mean=(0.485, 0.456, 0.406),
               std=(0.229, 0.224, 0.225)) -> jnp.ndarray:
    """Eval-time transform: resize shorter side -> center crop -> normalize.

    Mirrors the torchvision classification eval transform the reference's
    ``vgg16:transform`` node applied (``static/models/vgg16.py:40-42``).
    Accepts [C, H, W] or [B, C, H, W] in [0, 1].
    """
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    b, c, h, w = images.shape
    nh, nw = target_dims(h, w, size)
    x = jax.image.resize(images, (b, c, nh, nw), method="bilinear")
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top : top + size, left : left + size]
    x = imagenet_normalize(x, mean, std)
    return x[0] if squeeze else x
