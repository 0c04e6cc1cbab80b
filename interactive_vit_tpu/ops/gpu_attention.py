"""Attention that emits its maps, as one Pallas kernel through Triton.

The plain path (``ops/attention.attention_reference``) writes the f32
logits ``[B, H, N, N]`` to device memory, reads them back for the softmax,
writes the probs and reads them again for ``P @ V``. This kernel keeps
every N x N intermediate on chip and writes the probs once, in the tap
dtype.

One program per (Q block, batch, head), Dh = 64:

* pass 1 walks the K blocks for each row's max and normaliser;
* pass 2 recomputes the scores, stores the normalised probs block by
  block and accumulates ``P @ V``.

``Q K^T`` is computed twice; next to the MLP products that costs little.
Rows and keys past N (ragged 197, 577, 785) are masked at the loads and
stores; keys at or past ``n_real`` are masked in the softmax.

bf16 only (``ops/dispatch.choose_attention``): the f32 parity path stays on
the plain path at HIGHEST precision. Pallas kernels have no AD rule, so
models that use it register the plain path as their gradient twin
(``JaxModel(grad_layers=...)``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -0.7 * float(jnp.finfo(jnp.float32).max)
BLOCK_Q = 64
BLOCK_K = 64


def _kernel(q_ref, k_ref, v_ref, o_ref, p_ref, *, n: int, n_keys: int,
            scale: float):
    i = pl.program_id(0)
    rows = i * BLOCK_Q + jnp.arange(BLOCK_Q)
    row_ok = (rows < n)[:, None]
    q = plgpu.load(q_ref.at[pl.ds(i * BLOCK_Q, BLOCK_Q), :], mask=row_ok,
                   other=0.0)
    n_blocks = pl.cdiv(n, BLOCK_K)

    def scores(j):
        cols = j * BLOCK_K + jnp.arange(BLOCK_K)
        k = plgpu.load(k_ref.at[pl.ds(j * BLOCK_K, BLOCK_K), :],
                       mask=(cols < n)[:, None], other=0.0)
        s = pl.dot(q, k.T) * scale  # f32 accumulation
        return cols, jnp.where((cols < n_keys)[None, :], s, NEG)

    def stats(j, carry):
        m, l = carry
        _, s = scores(j)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        l = l * jnp.exp(m - m_new) + jnp.sum(
            jnp.exp(s - m_new[:, None]), axis=1)
        return m_new, l

    m0 = jnp.full((BLOCK_Q,), NEG, jnp.float32)
    l0 = jnp.zeros((BLOCK_Q,), jnp.float32)
    m, l = jax.lax.fori_loop(0, n_blocks, stats, (m0, l0))
    inv_l = 1.0 / l

    def emit(j, acc):
        cols, s = scores(j)
        p = jnp.exp(s - m[:, None]) * inv_l[:, None]
        plgpu.store(p_ref.at[pl.ds(i * BLOCK_Q, BLOCK_Q),
                             pl.ds(j * BLOCK_K, BLOCK_K)],
                    p.astype(p_ref.dtype),
                    mask=row_ok & (cols < n)[None, :])
        v = plgpu.load(v_ref.at[pl.ds(j * BLOCK_K, BLOCK_K), :],
                       mask=(cols < n)[:, None], other=0.0)
        return acc + pl.dot(p.astype(v.dtype), v)

    acc = jax.lax.fori_loop(
        0, n_blocks, emit, jnp.zeros((BLOCK_Q, q.shape[-1]), jnp.float32))
    plgpu.store(o_ref.at[pl.ds(i * BLOCK_Q, BLOCK_Q), :],
                acc.astype(o_ref.dtype), mask=row_ok)


@functools.partial(jax.jit, static_argnames=("n_real", "interpret"))
def attention_probs(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                    n_real: Optional[int] = None, interpret: bool = False):
    """softmax(q k^T / sqrt(dh)) v and its probs; inputs [B, H, N, Dh].

    Returns ``(out [B, H, N, Dh], probs [B, H, N, N])``, both in q's
    dtype: the contract of ``attention_reference(..., want_attn=True)``
    with the probs already in the tap dtype. ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests).
    """
    b, h, n, dh = q.shape
    if dh & (dh - 1):
        raise ValueError(f"head dim {dh} is not a power of two")
    n_keys = n if n_real is None else min(int(n_real), n)
    kernel = functools.partial(
        _kernel, n=n, n_keys=n_keys, scale=1.0 / math.sqrt(dh))
    seq = pl.BlockSpec((None, None, n, dh), lambda i, bi, hi: (bi, hi, 0, 0))
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, BLOCK_Q), b, h),
        in_specs=[seq, seq, seq],
        out_specs=[seq, pl.BlockSpec((None, None, n, n),
                                     lambda i, bi, hi: (bi, hi, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((b, h, n, dh), q.dtype),
                   jax.ShapeDtypeStruct((b, h, n, n), q.dtype)],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="attention_probs",
    )(q, k, v)
