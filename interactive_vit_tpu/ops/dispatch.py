"""Attention dispatch: the one place that decides which implementation runs.

The plain jnp path (``ops/attention.attention_reference``) is the program
itself: XLA compiles it on every backend. The backend string
(``jax.default_backend()``) adds kernels on top of it:

    "gpu"   bf16 with maps on  -> the Pallas-Triton probs kernel
                                  (``ops/gpu_attention``), when the
                                  head dim is a power of two
            bf16 with maps off -> cuDNN fused attention through
                                  ``jax.nn.dot_product_attention``, when
                                  the head dim is a multiple of 8, <= 128
    other   the plain path

A head dim a kernel cannot take (ViT-H/14's 80 for the probs kernel) runs
the plain path. float32 never gets a kernel: it is the parity path
(HIGHEST precision, ``ops/layers.mm_precision``). Policy names:

    "auto"       the table above
    "reference"  force the plain path
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

POLICIES = ("auto", "reference")


def choose_attention(dtype, want_attn: bool, head_dim: int,
                     platform: str = None) -> str:
    """Name the implementation ``auto_attention`` runs for one call.

    Returns "gpu_probs" (the Pallas-Triton kernel), "cudnn" (library
    fused attention) or "reference". ``platform`` defaults to
    ``jax.default_backend()``.
    """
    platform = platform or jax.default_backend()
    if platform != "gpu" or jnp.dtype(dtype) != jnp.dtype(jnp.bfloat16):
        return "reference"
    if want_attn:
        pow2 = head_dim & (head_dim - 1) == 0
        return "gpu_probs" if pow2 else "reference"
    return "cudnn" if head_dim % 8 == 0 and head_dim <= 128 else "reference"


def auto_attention(q, k, v, want_attn=False, n_real=None):
    """Shape- and backend-aware attention (decided at trace time: shapes,
    dtypes and the backend are static under jit). Same contract as
    ``attention_reference``: inputs [B, H, N, Dh], returns
    ``(out, probs | None)``."""
    from interactive_vit_tpu.ops.attention import attention_reference

    impl = choose_attention(q.dtype, want_attn, q.shape[-1])
    if impl == "gpu_probs":
        from interactive_vit_tpu.ops.gpu_attention import attention_probs

        return attention_probs(q, k, v, n_real=n_real)
    if impl == "cudnn":
        return cudnn_attention(q, k, v, n_real=n_real), None
    return attention_reference(q, k, v, want_attn=want_attn, n_real=n_real)


def cudnn_attention(q, k, v, n_real=None):
    """Maps-off attention through cuDNN's fused kernel (a library call).
    ``jax.nn.dot_product_attention`` takes [B, N, H, Dh]."""
    t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    n = q.shape[2]
    lengths = None
    if n_real is not None and n_real < n:
        lengths = jnp.full((q.shape[0],), n_real, jnp.int32)
    out = jax.nn.dot_product_attention(
        t(q), t(k), t(v), key_value_seq_lengths=lengths,
        implementation="cudnn")
    return t(out)


def default_attn_impl(name: str = "auto"):
    """Resolve an attention implementation by policy name.

    Returns None for the plain path (``attention.mhsa`` treats None as
    "use attention_reference") or ``auto_attention``. Names of kernels
    that no longer exist raise.
    """
    if name == "reference":
        return None
    if name == "auto":
        return auto_attention
    raise ValueError(f"unknown attention policy {name!r}; "
                     f"choose from {POLICIES}")
