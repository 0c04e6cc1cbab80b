"""The Pallas-Triton attention kernel (ops/gpu_attention.py) against the
plain path, in Pallas interpret mode on the CPU; one card-only test
compiles it for the GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops.attention import attention_reference
from interactive_vit_tpu.ops.gpu_attention import attention_probs


def _qkv(n, b=1, h=2, dh=64, dtype=jnp.bfloat16, seed=0):
    ks = jax.random.split(jax.random.key(seed + n), 3)
    return tuple(jax.random.normal(k, (b, h, n, dh), jnp.float32)
                 .astype(dtype) for k in ks)


def _errs(got, ref):
    (o, p), (ro, rp) = got, ref
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (float(np.abs(f(o) - f(ro)).max()),
            float(np.abs(f(p) - f(rp)).max()))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "n_real"])
@pytest.mark.parametrize("n", [50, 197, 577, 785])
def test_kernel_matches_reference(n, masked):
    """Ragged token counts (ViT-B/16 197, ViT-L/16@384 577, 785) with and
    without key masking: within the plain bf16 path's own error against
    the f32 reference."""
    q, k, v = _qkv(n)
    n_real = n - 7 if masked else None
    got = attention_probs(q, k, v, n_real=n_real, interpret=True)
    f32 = tuple(x.astype(jnp.float32) for x in (q, k, v))
    ref = attention_reference(*f32, want_attn=True, n_real=n_real)
    plain = attention_reference(q, k, v, want_attn=True, n_real=n_real)
    e_out, e_p = _errs(got, ref)
    p_out, p_p = _errs(plain, ref)
    assert e_out <= 2 * p_out + 1e-2
    assert e_p <= 2 * p_p + 1e-3
    if masked:
        assert float(jnp.abs(got[1][..., n_real:]).max()) == 0.0


def test_kernel_output_contract():
    """(out, probs) in the input dtype, probs row-normalized: the
    ``attention_reference(..., want_attn=True)`` contract with the maps
    already in the tap dtype."""
    q, k, v = _qkv(70, b=2, h=3)
    out, probs = attention_probs(q, k, v, interpret=True)
    assert out.shape == (2, 3, 70, 64) and out.dtype == jnp.bfloat16
    assert probs.shape == (2, 3, 70, 70) and probs.dtype == jnp.bfloat16
    rows = np.asarray(probs, np.float32).sum(-1)
    np.testing.assert_allclose(rows, 1.0, atol=2e-2)


@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_kernel_block_sizes_agree(edge):
    """The tiling is an implementation detail: token counts one below, at
    and one past a block edge give the plain path's maps to rounding."""
    from interactive_vit_tpu.ops.gpu_attention import BLOCK_K, BLOCK_Q

    assert BLOCK_Q == BLOCK_K
    q, k, v = _qkv(BLOCK_Q + edge)
    got = attention_probs(q, k, v, interpret=True)
    base = attention_reference(q, k, v, want_attn=True)
    e_out, e_p = _errs(got, base)
    assert e_out < 2e-2 and e_p < 4e-3


def test_kernel_n_real_at_or_past_n_is_unmasked():
    q, k, v = _qkv(40)
    base = attention_probs(q, k, v, interpret=True)
    for n_real in (40, 64):
        got = attention_probs(q, k, v, n_real=n_real, interpret=True)
        assert _errs(got, base) == (0.0, 0.0)


def test_kernel_rejects_non_power_of_two_head_dim():
    q, k, v = _qkv(16, dh=48)
    with pytest.raises(ValueError, match="power of two"):
        attention_probs(q, k, v, interpret=True)


def test_kernel_in_vit_block_matches_plain_path():
    """Through ``vit.block`` with the kernel as attn_impl: the maps,
    head-mean and block output track the plain path."""
    import functools

    from interactive_vit_tpu.models import vit

    cfg = vit.ViTConfig("vit_gk", img_size=32, patch=8, width=128, depth=1,
                        heads=2, num_classes=4)
    params = vit.init_params(jax.random.key(0), cfg, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.key(1), (2, cfg.tokens, 128),
                          jnp.float32).astype(jnp.bfloat16)

    def impl(q, k, v, want_attn=False, n_real=None):
        return attention_probs(q, k, v, n_real=n_real, interpret=True)

    p = params["blocks"][0]
    y0, a0, m0 = vit.block(p, x, cfg, want_attn=True, want_mean=True)
    y1, a1, m1 = vit.block(p, x, cfg, want_attn=True, want_mean=True,
                           attn_impl=functools.partial(impl))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    assert a1.shape == a0.shape and m1.shape == m0.shape
    assert np.abs(f(a1) - f(a0)).max() < 1e-2
    assert np.abs(f(m1) - f(m0)).max() < 1e-2
    assert np.abs(f(y1) - f(y0)).max() < 0.1


@pytest.mark.gpu
def test_kernel_compiles_on_the_card(gpu_device):
    """Compiled through Triton for the card (no interpreter), at the
    vit_b16 width."""
    q, k, v = (jax.device_put(x, gpu_device) for x in _qkv(197, b=4, h=12))
    out, probs = jax.jit(attention_probs)(q, k, v)
    f32 = tuple(x.astype(jnp.float32) for x in (q, k, v))
    ref = attention_reference(*f32, want_attn=True)
    plain = attention_reference(q, k, v, want_attn=True)
    e_out, e_p = _errs((out, probs), ref)
    p_out, p_p = _errs(plain, ref)
    assert e_out <= 2 * p_out + 1e-2 and e_p <= 2 * p_p + 1e-3
