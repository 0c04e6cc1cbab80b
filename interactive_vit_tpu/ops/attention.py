"""Multi-head self-attention with attention-map taps — the plain path.

Ground truth for the GPU attention kernel (``ops/gpu_attention.py``). The
tap contract (BASELINE.json north star: "any node — per-head attention maps,
CLS-token trajectories, intermediate activations — remains tappable") is:

* ``want_attn=False`` — fast path, returns only the block output; a fused
  attention kernel never materializes the N x N matrix;
* ``want_attn=True``  — also returns the post-softmax attention
  probabilities ``[B, H, N, N]`` (what the UI renders as attention maps).

Fused QKV: one [D, 3D] matmul instead of three [D, D] ones — bigger
tiles, fewer device-memory round trips.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops.layers import linear, mm_precision

Params = Dict[str, jnp.ndarray]


def qkv_proj(x: jnp.ndarray, p: Params, heads: int, head_major: bool = False
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused QKV projection -> per-head tensors [B, H, N, Dh].

    ``head_major=True``: the weight columns are packed [H][3][Dh]
    (``parallel/mesh.permute_qkv_head_major`` — the Megatron TP layout,
    head-aligned under flat column sharding) instead of the torch-
    compatible [3][H][Dh]."""
    b, n, d = x.shape
    dh = d // heads
    qkv = linear(x, p["qkv_w"], p["qkv_b"])  # dense or weight-only int8
    if head_major:
        qkv = qkv.reshape(b, n, heads, 3, dh)
        q, k, v = (qkv[:, :, :, i].transpose(0, 2, 1, 3) for i in range(3))
    else:
        qkv = qkv.reshape(b, n, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
    return q, k, v


def attention_reference(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    want_attn: bool = False,
    n_real: Optional[int] = None,
    causal: bool = False,
    key_bias: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """softmax(q k^T / sqrt(dh)) v with f32 softmax, inputs [B, H, N, Dh].

    ``n_real``: when the token dim is padded (the model keeps sequences
    padded to a multiple of 128 end-to-end — see ``vit.forward``), keys beyond
    ``n_real`` are masked out; padded query rows produce uniform garbage the
    caller never reads.

    ``causal``: additive -inf strictly above the diagonal (the CLIP text
    tower), matching torch ``nn.MultiheadAttention(attn_mask=...)``.

    ``key_bias``: optional [B, N] f32 additive logit bias per KEY, shared
    across heads and queries — proportional attention for merged tokens
    (``softmax(q k^T/sqrt(dh) + log s)``, the ToMe correction: a token
    representing ``s`` originals attends as if those ``s`` keys were
    still present; ``models/tome.py``).
    """
    dh = q.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(dh, jnp.float32))
    logits = jnp.einsum(
        "bhnd,bhmd->bhnm", q, k, preferred_element_type=jnp.float32,
        precision=mm_precision(q, k),
    ) * scale
    if key_bias is not None:
        logits = logits + key_bias.astype(jnp.float32)[:, None, None, :]
    neg = -0.7 * jnp.finfo(jnp.float32).max
    if causal:
        row = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 2)
        col = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 3)
        logits = jnp.where(col <= row, logits, neg)
    if n_real is not None and n_real < q.shape[2]:
        col = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 3)
        logits = jnp.where(col < n_real, logits, neg)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum(
        "bhnm,bhmd->bhnd", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
        precision=mm_precision(v),
    ).astype(v.dtype)
    return out, (probs if want_attn else None)


def mhsa(
    x: jnp.ndarray,
    p: Params,
    heads: int,
    want_attn: bool = False,
    attn_impl=None,
    n_real: Optional[int] = None,
    head_major: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Full MHSA: fused QKV -> attention -> output projection.

    ``attn_impl`` lets callers swap in another implementation
    (``ops/dispatch``); it must accept (q, k, v, want_attn, n_real=None)
    and honor the same contract.
    ``head_major``: qkv weights use the Megatron TP column layout
    (``qkv_proj`` docstring).
    """
    b, n, d = x.shape
    q, k, v = qkv_proj(x, p, heads, head_major=head_major)
    impl = attn_impl or attention_reference
    out, probs = impl(q, k, v, want_attn, n_real=n_real)
    out = out.transpose(0, 2, 1, 3).reshape(b, n, d)
    return linear(out, p["proj_w"], p["proj_b"]), probs


def rollout_step(attn: jnp.ndarray, carry: jnp.ndarray) -> jnp.ndarray:
    """One layer of attention rollout: fold attention maps into [B,N,N].

    ``attn`` is either per-head maps [B,H,N,N] (meaned here) or already
    head-meaned maps [B,N,N] (what the blocks emit for rollout).
    carry is the rollout up to the previous layer (identity at layer 0).
    Used both by ``attention_rollout`` (monolithic forward) and by the
    per-block "r" channel in the interactive graph (the rollout flows
    along the chain like the activation does).
    """
    # precision keyed on the INCOMING maps' dtype, not the f32 working
    # copy: bf16 maps carry 8 mantissa bits, so HIGHEST (multi-pass f32)
    # buys nothing there. The f32 parity path (f32 maps) keeps HIGHEST
    # per the 1e-4 contract.
    prec = mm_precision(attn)
    mean_heads = attn.astype(jnp.float32)
    if mean_heads.ndim == 4:
        mean_heads = mean_heads.mean(axis=1)  # [B, N, N]
    n = mean_heads.shape[-1]
    aug = 0.5 * mean_heads + 0.5 * jnp.eye(n, dtype=jnp.float32)
    aug = aug / jnp.sum(aug, axis=-1, keepdims=True)
    return jnp.einsum("bij,bjk->bik", aug, carry.astype(jnp.float32),
                      precision=prec)


def attention_rollout(attns) -> jnp.ndarray:
    """Attention rollout (Abnar & Zuidema 2020) over per-layer maps.

    ``attns``: a sequence of [B, H, N, N] post-softmax maps, of [B, N, N]
    head-meaned maps, or a stacked array of either. Returns [B, N, N]:
    cumulative token-to-token
    attribution with residual connections folded in as 0.5*I +
    0.5*mean-over-heads, renormalized, matrix-chained across layers. Drives
    the BASELINE config 2 "CLS + attention-rollout visualization".

    Takes a list by design: stacking L maps first costs an extra
    L*B*H*N^2 copy that the chain doesn't need.
    """
    if hasattr(attns, "shape"):
        attns = list(attns)
    b, n = attns[0].shape[0], attns[0].shape[-1]
    rollout = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (b, n, n))
    for a in attns:
        rollout = rollout_step(a, rollout)
    return rollout
