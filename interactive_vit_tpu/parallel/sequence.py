"""Sequence parallelism: ring attention + Ulysses head-parallel attention.

The long-sequence scale-out path (SURVEY.md §2.3, §5): when one device's
memory can no longer hold a sequence's K/V (far beyond ViT-L/16@384's 577 tokens,
but first-class in this framework), shard the token axis across the mesh:

* **Ring attention**: each device keeps its Q shard and circulates K/V
  shards around the ring with ``jax.lax.ppermute``,
  folding each visiting shard into an online-softmax accumulator. Peak
  memory per device: one K/V shard + O(n_local) stats. Communication
  overlaps compute under XLA's latency-hiding scheduler.

* **Ulysses**: ``jax.lax.all_to_all`` re-shards [tokens] -> [heads], so each
  device computes FULL attention for a head subset — per-head attention
  maps stay whole on one chip, which is exactly what the attention-map tap
  contract needs (a ring cannot tap a full map without gathering).

Both are pure-jax ``shard_map`` programs: collectives are explicit, math is
the same online softmax as the Pallas kernel, and they validate on the
8-virtual-device CPU mesh (tests) exactly as they run on a pod.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from interactive_vit_tpu.ops.layers import mm_precision

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def _local_ring_attention(q, k, v, axis_name: str, n_real: int):
    """Per-device body under shard_map: q,k,v are local [B,H,nl,D] shards."""
    p = jax.lax.axis_size(axis_name)
    my = jax.lax.axis_index(axis_name)
    b, h, nl, d = q.shape
    scale = d ** -0.5
    qf = q.astype(jnp.float32)

    m = jnp.full((b, h, nl, 1), -jnp.inf, jnp.float32)
    l = jnp.zeros((b, h, nl, 1), jnp.float32)
    acc = jnp.zeros((b, h, nl, d), jnp.float32)
    k_cur, v_cur = k, v

    perm = [(j, (j + 1) % p) for j in range(p)]

    for step in range(p):
        # k_cur originated on device (my - step) mod p -> its global key range
        src = (my - step) % p
        kf = k_cur.astype(jnp.float32)
        s = jnp.einsum(
            "bhnd,bhmd->bhnm", qf, kf, precision=mm_precision(qf, kf)
        ) * scale
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3) + src * nl
        s = jnp.where(col < n_real, s, MASK_VALUE)

        m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
        alpha = jnp.exp(m - m_new)
        pexp = jnp.exp(s - m_new)
        l = alpha * l + jnp.sum(pexp, axis=-1, keepdims=True)
        vf = v_cur.astype(jnp.float32)
        acc = acc * alpha + jnp.einsum(
            "bhnm,bhmd->bhnd", pexp, vf, precision=mm_precision(pexp, vf)
        )
        m = m_new

        if step + 1 < p:
            k_cur = jax.lax.ppermute(k_cur, axis_name, perm)
            v_cur = jax.lax.ppermute(v_cur, axis_name, perm)

    return (acc / l).astype(q.dtype)


def ring_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    n_real: Optional[int] = None,
) -> jnp.ndarray:
    """Sequence-sharded attention over a mesh axis.

    q/k/v: [B, H, N, D] global; N must divide by the axis size (pad + pass
    ``n_real`` otherwise). Returns [B, H, N, D] sharded the same way.
    """
    n = q.shape[2]
    n_real = n if n_real is None else n_real
    p = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    if n % p:
        raise ValueError(
            f"ring_attention: token count {n} must be divisible by mesh "
            f"axis {axis!r} (size {p}) — pad and pass n_real"
        )
    spec = P(None, None, axis, None)
    fn = jax.shard_map(
        functools.partial(
            _local_ring_attention, axis_name=axis, n_real=n_real
        ),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
    )
    return fn(q, k, v)


def _local_ulysses(q, k, v, axis_name: str, n_real: int, want_attn: bool):
    """Per-device body: [B, H, nl, D] token shards -> all-to-all to
    [B, H/p, N, D] head shards -> full local attention -> back."""

    def to_heads(x):
        # split heads across devices, gather all tokens
        return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                                  tiled=True)

    def to_tokens(x):
        return jax.lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                                  tiled=True)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)  # [B, H/p, N, D]
    scale = qh.shape[-1] ** -0.5
    qf, kf = qh.astype(jnp.float32), kh.astype(jnp.float32)
    s = jnp.einsum(
        "bhnd,bhmd->bhnm", qf, kf, precision=mm_precision(qf, kf)
    ) * scale
    col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3)
    s = jnp.where(col < n_real, s, MASK_VALUE)
    probs = jax.nn.softmax(s, axis=-1)
    vf = vh.astype(jnp.float32)
    out = jnp.einsum(
        "bhnm,bhmd->bhnd", probs, vf, precision=mm_precision(probs, vf)
    ).astype(q.dtype)
    out = to_tokens(out)  # back to [B, H, nl, D]
    if want_attn:
        # maps stay head-sharded [B, H/p, N, N]: whole per-head maps per chip
        return out, probs.astype(q.dtype)
    return out, None


def ulysses_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    n_real: Optional[int] = None,
    want_attn: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Ulysses attention: tokens->heads all-to-all, full local attention.

    Heads must divide by the axis size. Returns (out [B,H,N,D] token-sharded,
    probs [B,H,N,N] head-sharded or None).
    """
    n = q.shape[2]
    n_real = n if n_real is None else n_real
    p = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    if q.shape[1] % p:
        raise ValueError(
            f"ulysses_attention: heads {q.shape[1]} must be divisible by "
            f"mesh axis {axis!r} (size {p})"
        )
    if n % p:
        raise ValueError(
            f"ulysses_attention: token count {n} must be divisible by "
            f"mesh axis {axis!r} (size {p}) — pad and pass n_real"
        )
    spec = P(None, None, axis, None)
    probs_spec = P(None, axis, None, None)
    body = functools.partial(_local_ulysses, axis_name=axis, n_real=n_real,
                             want_attn=want_attn)
    if want_attn:
        fn = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                           out_specs=(spec, probs_spec))
        return fn(q, k, v)
    fn = jax.shard_map(lambda a, b, c: body(a, b, c)[0], mesh=mesh,
                       in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v), None
