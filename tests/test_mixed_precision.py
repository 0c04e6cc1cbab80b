"""Mixed-precision training (--dtype mixed): f32 master params + bf16
compute (parallel/train.cast_params).

Why it exists: optax moments inherit the PARAM dtype, so the pure-bf16
config stores AdamW's mu/nu in bf16 (nu underflows small squared grads)
and applies updates in bf16 (sub-ulp updates round away — a ~1.0-magnitude
param cannot absorb an update below ~2^-8). The mixed recipe keeps f32
masters/moments and runs the forward/backward in bf16 — the standard
large-model setup. The reference is inference-only
(/root/reference/main/context.py:80); training is this framework's tier.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.parallel import mesh as mesh_lib
from interactive_vit_tpu.parallel import train as train_lib

CFG = vit.ViTConfig("mp_test", img_size=32, patch=16, width=64,
                    depth=2, heads=4, num_classes=8)


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 8, size=(n,))
    images = (rng.normal(size=(n, 3, 32, 32)).astype(np.float32) * 0.3
              + (labels[:, None, None, None] / 8).astype(np.float32))
    return jnp.asarray(images), jnp.asarray(labels)


def test_moments_dtype_f32_under_mixed():
    """The point of the feature: mixed keeps AdamW mu/nu f32 where the
    pure-bf16 config stores them bf16."""
    opt = train_lib.make_optimizer(1e-3)
    p_bf16 = vit.init_params(jax.random.key(0), CFG, dtype=jnp.bfloat16)
    p_mixed = vit.init_params(jax.random.key(0), CFG)  # f32 masters
    mu_bf16 = jax.tree.leaves(opt.init(p_bf16)[0].mu)[0].dtype
    nu_mixed = jax.tree.leaves(opt.init(p_mixed)[0].nu)[0].dtype
    assert mu_bf16 == jnp.bfloat16  # documents the pure-bf16 behavior
    assert nu_mixed == jnp.float32


def test_sub_ulp_updates_stall_bf16_but_not_mixed():
    """A tiny-LR SGD step moves f32 masters but rounds away on bf16
    params at ~1.0 magnitude (LN scales): the stall the feature fixes."""
    images, labels = _batch()
    lr = 1e-6
    opt = optax.sgd(lr)

    p16 = vit.init_params(jax.random.key(0), CFG, dtype=jnp.bfloat16)
    s16 = train_lib.make_train_step(CFG, opt)
    p16b, _, _ = s16(p16, opt.init(p16), images, labels)

    pm = vit.init_params(jax.random.key(0), CFG)
    sm = train_lib.make_train_step(CFG, opt, compute_dtype=jnp.bfloat16)
    pmb, _, _ = sm(pm, opt.init(pm), images, labels)

    ln16_before = np.asarray(p16["blocks"][0]["ln1_s"], np.float32)
    ln16_after = np.asarray(p16b["blocks"][0]["ln1_s"], np.float32)
    lnm_before = np.asarray(pm["blocks"][0]["ln1_s"], np.float32)
    lnm_after = np.asarray(pmb["blocks"][0]["ln1_s"], np.float32)
    # bf16 at magnitude 1.0 has ulp 2^-8 = 0.0039 >> lr*grad: frozen
    assert (ln16_after == ln16_before).all()
    # f32 masters accumulate the same sub-ulp update
    assert (lnm_after != lnm_before).any()
    assert np.abs(lnm_after - lnm_before).max() < 1e-4  # and it IS tiny


def test_mixed_forward_is_bf16():
    """The compute cast reaches the forward: mixed logits match the
    pure-bf16 forward bitwise (same bf16 weights), not the f32 one."""
    images, _ = _batch()
    pm = vit.init_params(jax.random.key(0), CFG)
    logits_f32 = vit.forward(pm, images, CFG)["logits"]
    logits_mixed = vit.forward(
        train_lib.cast_params(pm, jnp.bfloat16), images, CFG)["logits"]
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                       if jnp.issubdtype(x.dtype, jnp.floating) else x, pm)
    logits_bf16 = vit.forward(p16, images, CFG)["logits"]
    assert logits_mixed.dtype == logits_bf16.dtype
    np.testing.assert_array_equal(np.asarray(logits_mixed, np.float32),
                                  np.asarray(logits_bf16, np.float32))
    assert np.abs(np.asarray(logits_mixed, np.float32)
                  - np.asarray(logits_f32)).max() > 0  # really not f32


def test_mixed_trains_sharded_dp_tp():
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    with mesh:
        params, opt_state, step_fn, infer_fn = train_lib.setup_sharded(
            CFG, mesh, seed=0, lr=3e-3, compute_dtype=jnp.bfloat16)
        assert jax.tree.leaves(params)[0].dtype == jnp.float32
        images, labels = _batch()
        losses = []
        for _ in range(8):
            params, opt_state, loss = step_fn(
                params, opt_state, images, labels)
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        logits = infer_fn(params, images)
        assert logits.shape == (8, 8)


def test_mixed_accum_matches_full_batch():
    images, labels = _batch(2)
    opt = optax.sgd(1e-2)
    params = vit.init_params(jax.random.key(0), CFG)
    s1 = train_lib.make_train_step(CFG, opt, accum_steps=1,
                                   compute_dtype=jnp.bfloat16)
    s2 = train_lib.make_train_step(CFG, opt, accum_steps=4,
                                   compute_dtype=jnp.bfloat16)
    p1, _, l1 = s1(params, opt.init(params), images, labels)
    p2, _, l2 = s2(params, opt.init(params), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), rtol=2e-3)
    # the forward runs in bf16 per microbatch: grads agree only to bf16
    # rounding (the f32 accumulation is exact, the summands are not)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=1e-3)


def test_mixed_mae_and_distill_smoke():
    from interactive_vit_tpu.models import mae

    enc = vit.ViTConfig("mae_mp_enc", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=0)
    mcfg = mae.MAEConfig("mae_mp_test", encoder="mae_mp_enc",
                         dec_width=32, dec_depth=1, dec_heads=2,
                         enc_override=enc)
    mp = mae.init_params(jax.random.key(0), mcfg)
    mstep = train_lib.make_mae_train_step(mcfg, optax.adam(1e-3),
                                          compute_dtype=jnp.bfloat16)
    opt = optax.adam(1e-3)
    images, labels = _batch()
    _, _, ml = mstep(mp, opt.init(mp), images, jax.random.key(0))
    assert np.isfinite(float(ml))

    student = vit.ViTConfig("deit_mp_test", img_size=32, patch=16,
                            width=64, depth=2, heads=4, num_classes=8,
                            distilled=True)
    tp = vit.init_params(jax.random.key(7), CFG)
    sp = vit.init_params(jax.random.key(0), student)
    dstep = train_lib.make_distill_train_step(
        student, CFG, tp, opt, compute_dtype=jnp.bfloat16)
    _, _, dl = dstep(sp, opt.init(sp), images, labels)
    assert np.isfinite(float(dl))


def test_cli_mixed_flag():
    from interactive_vit_tpu.tools import train as cli

    vit.VARIANTS["mp_test"] = CFG
    try:
        cli.main(["--variant", "mp_test", "--steps", "3", "--batch", "8",
                  "--memorize", "8", "--distinct-classes", "4",
                  "--dtype", "mixed", "--log-every", "1"])
    finally:
        del vit.VARIANTS["mp_test"]
