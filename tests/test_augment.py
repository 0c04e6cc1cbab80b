"""On-device training augmentations (data/augment.py) + soft-label loss.

The reference trains nothing (``/root/reference/main/context.py:79-88``);
these pin the on-device augmentation stack's semantics: every op is a
deterministic static-shape function of a PRNG key, mixing ops emit soft
labels consistent with the pixels they actually mixed, and the train step
consumes soft labels through gradient accumulation unchanged.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from interactive_vit_tpu.data import augment as A
from interactive_vit_tpu.parallel import train as train_lib


def _imgs(b=4, h=16, w=16, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).random((b, 3, h, w), np.float32))


def test_disabled_config_is_identity():
    cfg = A.AugmentConfig()
    assert not cfg.enabled
    assert A.make_augment_fn(cfg, 10) is None
    x, y = _imgs(), jnp.arange(4)
    xo, yo = A.augment(jax.random.key(0), x, y, 10, cfg)
    np.testing.assert_array_equal(np.asarray(xo), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(yo), np.asarray(y))


def test_hflip_each_image_original_or_mirrored():
    x = _imgs(b=8)
    xo, _ = A.augment(jax.random.key(1), x, jnp.zeros(8, jnp.int32), 10,
                      A.AugmentConfig(hflip=True))
    xo, x = np.asarray(xo), np.asarray(x)
    kinds = set()
    for i in range(8):
        if np.array_equal(xo[i], x[i]):
            kinds.add("id")
        else:
            np.testing.assert_array_equal(xo[i], x[i][..., ::-1])
            kinds.add("flip")
    assert kinds == {"id", "flip"}  # p=0.5 over 8 images: both occur


def test_shift_crop_is_a_window_of_the_padded_image():
    pad, h, w = 3, 10, 12
    base = np.arange(h * w, dtype=np.float32).reshape(1, 1, h, w) + 1.0
    x = jnp.asarray(np.broadcast_to(base, (5, 3, h, w)).copy())
    xo, _ = A.augment(jax.random.key(2), x, jnp.zeros(5, jnp.int32), 10,
                      A.AugmentConfig(crop_pad=pad))
    padded = np.pad(np.asarray(x), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    xo = np.asarray(xo)
    offsets = set()
    for i in range(5):
        found = [
            (oy, ox)
            for oy in range(2 * pad + 1) for ox in range(2 * pad + 1)
            if np.array_equal(xo[i], padded[i, :, oy:oy + h, ox:ox + w])
        ]
        assert found, f"image {i} is not any crop of its padded original"
        offsets.add(found[0])
    assert len(offsets) > 1  # offsets actually vary across the batch


def test_color_jitter_bounds_on_constant_image():
    # constant gray image: contrast & saturation are identities, so the
    # output must be input * brightness with the factor in [1-s, 1+s]
    s = 0.4
    x = jnp.full((6, 3, 8, 8), 2.0, jnp.float32)
    xo, _ = A.augment(jax.random.key(3), x, jnp.zeros(6, jnp.int32), 10,
                      A.AugmentConfig(color_jitter=s))
    f = np.asarray(xo) / 2.0
    per_img = f.reshape(6, -1)
    np.testing.assert_allclose(
        per_img, np.broadcast_to(per_img[:, :1], per_img.shape), rtol=1e-5)
    assert ((per_img[:, 0] >= 1 - s - 1e-5)
            & (per_img[:, 0] <= 1 + s + 1e-5)).all()
    assert np.std(per_img[:, 0]) > 0  # factors vary per image


def test_cutout_zeroes_one_box():
    k = 5
    x = jnp.asarray(np.ones((4, 3, 16, 16), np.float32))
    xo, _ = A.augment(jax.random.key(4), x, jnp.zeros(4, jnp.int32), 10,
                      A.AugmentConfig(cutout=k))
    xo = np.asarray(xo)
    for i in range(4):
        zero = xo[i, 0] == 0  # same box on every channel
        np.testing.assert_array_equal(zero, xo[i, 1] == 0)
        n = int(zero.sum())
        assert 0 < n <= k * k
        ys, xs = np.nonzero(zero)
        # contiguous box: the bounding rectangle is exactly the zero set
        assert n == (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)


def _recover_lams(y_soft, labels):
    """Per-image weight on the ORIGINAL label (vs the reversed partner)."""
    y = np.asarray(y_soft)
    return np.array([y[i, labels[i]] for i in range(len(labels))])


def test_mixup_pixels_match_label_weights():
    b = 6
    x = _imgs(b=b, seed=5)
    labels = np.arange(b)  # distinct classes: weights are recoverable
    xo, yo = A.augment(jax.random.key(6), x, jnp.asarray(labels), b,
                       A.AugmentConfig(mixup_alpha=0.8))
    lam = _recover_lams(yo, labels)
    assert (lam >= 0.5 - 1e-6).all()  # pinned to the majority half
    np.testing.assert_allclose(lam, lam[0], atol=1e-6)  # batch-wide lam
    want = lam[0] * np.asarray(x) + (1 - lam[0]) * np.asarray(x)[::-1]
    np.testing.assert_allclose(np.asarray(xo), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(yo).sum(-1), 1.0, atol=1e-6)


def test_cutmix_box_area_matches_label_weight():
    b, h, w = 4, 16, 16
    x = jnp.asarray(np.random.default_rng(7).random((b, 3, h, w),
                                                    np.float32))
    labels = np.arange(b)
    xo, yo = A.augment(jax.random.key(8), x, jnp.asarray(labels), b,
                       A.AugmentConfig(cutmix_alpha=1.0))
    xo, xr = np.asarray(xo), np.asarray(x)[::-1]
    lam = _recover_lams(yo, labels)
    for i in range(b):
        frac_partner = float(
            np.isclose(xo[i], xr[i]).all(axis=0).mean())
        assert frac_partner == pytest.approx(1 - lam[i], abs=1 / (h * w))
    np.testing.assert_allclose(np.asarray(yo).sum(-1), 1.0, atol=1e-6)


def test_mixup_cutmix_switch_picks_one():
    x = _imgs(b=4, seed=9)
    cfg = A.AugmentConfig(mixup_alpha=0.8, cutmix_alpha=1.0)
    seen = set()
    for s in range(8):
        xo, _ = A.augment(jax.random.key(100 + s), x,
                          jnp.arange(4), 4, cfg)
        xo = np.asarray(xo)
        # cutmix output pixels come verbatim from x or x[::-1]; mixup
        # pixels are strict blends (lam in (0.5, 1) almost surely)
        verbatim = (np.isclose(xo, np.asarray(x))
                    | np.isclose(xo, np.asarray(x)[::-1])).mean()
        seen.add("cutmix" if verbatim > 0.999 else "mixup")
    assert seen == {"mixup", "cutmix"}


def test_determinism_and_step_variation():
    x, y = _imgs(), jnp.arange(4)
    fn = A.make_augment_fn(
        A.AugmentConfig(hflip=True, cutout=4, mixup_alpha=0.5), 10,
        base_key=jax.random.key(11))
    x1, y1 = fn(3, x, y)
    x2, y2 = fn(3, x, y)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    x3, _ = fn(4, x, y)
    assert not np.array_equal(np.asarray(x1), np.asarray(x3))


def test_cross_entropy_soft_equals_int_and_smoothing():
    logits = jnp.asarray(
        np.random.default_rng(12).standard_normal((5, 7)), jnp.float32)
    labels = jnp.asarray([0, 3, 6, 2, 2])
    onehot = jax.nn.one_hot(labels, 7)
    a = float(train_lib.cross_entropy(logits, labels))
    b = float(train_lib.cross_entropy(logits, onehot))
    assert a == pytest.approx(b, rel=1e-6)
    # the int path's closed-form smoothing == the explicit soft target
    s = 0.1
    c = float(train_lib.cross_entropy(logits, labels, smoothing=s))
    d = float(train_lib.cross_entropy(
        logits, onehot * (1 - s) + s / 7.0))
    assert c == pytest.approx(d, rel=1e-6)
    assert c != pytest.approx(a, rel=1e-4)


def test_train_step_consumes_soft_labels_with_accum():
    from interactive_vit_tpu.models import vit

    cfg = vit.ViTConfig("t", img_size=16, patch=8, width=32, depth=1,
                        heads=2, num_classes=5)
    params = vit.init_params(jax.random.key(0), cfg)
    opt = train_lib.make_optimizer(1e-3)
    step = train_lib.make_train_step(cfg, opt, remat=False, accum_steps=2,
                                     label_smoothing=0.05)
    opt_state = opt.init(params)
    x = _imgs(b=4, h=16, w=16, seed=13)
    _, y = A.augment(jax.random.key(14), x, jnp.arange(4) % 5, 5,
                     A.AugmentConfig(mixup_alpha=0.8))
    assert y.shape == (4, 5)
    p2, _, loss = jax.jit(step)(params, opt_state, x, y)
    assert np.isfinite(float(loss))
    # params actually moved
    delta = jax.tree.reduce(
        lambda a, l: a + float(jnp.abs(l).sum()),
        jax.tree.map(lambda a, b: a - b, p2, params), 0.0)
    assert delta > 0
