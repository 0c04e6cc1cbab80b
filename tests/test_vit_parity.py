"""ViT parity vs torch CPU reference — the BASELINE.json 1e-4 contract.

Config 1 of BASELINE.json: "ViT-Tiny/16 @224 single-image classify +
per-layer attention-map dump (CPU)". Same random weights flow into both
frameworks through the ``weights.to_torchvision`` converter, which also
proves real torchvision checkpoints would load identically.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit, weights
from torch_vit_ref import TorchViTRef

CFG = vit.ViTConfig("vit_test", img_size=32, patch=16, width=64,
                    depth=3, heads=4, num_classes=10)


@pytest.fixture(scope="module")
def both_models():
    params = vit.init_params(jax.random.key(0), CFG)
    sd = weights.to_torchvision(params, CFG)
    tm = TorchViTRef(CFG)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    tm.eval()
    return params, tm


def test_state_dict_names_cover_torch_model(both_models):
    params, tm = both_models
    sd = weights.to_torchvision(params, CFG)
    torch_names = set(tm.state_dict().keys())
    assert set(sd.keys()) == torch_names


def test_logits_parity(both_models):
    params, tm = both_models
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 32, 32), dtype=np.float32)

    ours = vit.forward(params, jnp.asarray(x), CFG)["logits"]
    theirs, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(
        np.asarray(ours), theirs.numpy(), atol=1e-4, rtol=1e-4
    )
    # the contract is <=1e-4; in f32 we expect far better
    assert np.max(np.abs(np.asarray(ours) - theirs.numpy())) < 1e-4


def test_attention_maps_parity(both_models):
    params, tm = both_models
    rng = np.random.default_rng(1)
    x = rng.random((1, 3, 32, 32), dtype=np.float32)

    out = vit.forward(params, jnp.asarray(x), CFG, want_attn=True)
    _, theirs = tm(torch.from_numpy(x), need_weights=True)
    # ours: [L, B, H, N, N]; torch: [L, B, H, N, N]
    np.testing.assert_allclose(
        np.asarray(out["attn"]), theirs.numpy(), atol=1e-4
    )


def test_attention_rollout_properties(both_models):
    params, _ = both_models
    x = jnp.asarray(np.random.default_rng(2).random((1, 3, 32, 32), np.float32))
    out = vit.forward(params, x, CFG, want_attn=True)
    r = np.asarray(out["rollout"])
    n = CFG.tokens
    assert r.shape == (1, n, n)
    np.testing.assert_allclose(r.sum(-1), np.ones((1, n)), atol=1e-5)  # rows are distributions
    assert (r >= 0).all()


def test_cls_trajectory(both_models):
    params, _ = both_models
    x = jnp.asarray(np.random.default_rng(3).random((2, 3, 32, 32), np.float32))
    out = vit.forward(params, x, CFG, want_cls_trajectory=True)
    assert out["cls"].shape == (CFG.depth + 1, 2, CFG.width)


def test_from_torchvision_roundtrip(both_models):
    params, tm = both_models
    back = weights.from_torchvision(
        {k: v.numpy() for k, v in tm.state_dict().items()}, CFG
    )
    for (p1, p2) in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-7)


def test_preprocess_matches_torch_transform():
    """Eval transform parity: resize(256/224*size) -> center crop -> normalize."""
    from interactive_vit_tpu.ops.layers import preprocess

    rng = np.random.default_rng(4)
    x = rng.random((3, 300, 400), dtype=np.float32)
    y = preprocess(jnp.asarray(x), 224)
    assert y.shape == (3, 224, 224)

    # torch reference path: antialias=True is what torchvision's PIL-backed
    # eval transform does, and jax.image.resize antialiases downsampling too
    t = torch.from_numpy(x)[None]
    t = torch.nn.functional.interpolate(
        t, size=(256, int(round(400 * 256 / 300))), mode="bilinear",
        align_corners=False, antialias=True,
    )
    th, tw = t.shape[-2:]
    top, left = (th - 224) // 2, (tw - 224) // 2
    t = t[:, :, top : top + 224, left : left + 224]
    mean = torch.tensor([0.485, 0.456, 0.406]).view(3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(3, 1, 1)
    t = (t[0] - mean) / std
    np.testing.assert_allclose(np.asarray(y), t.numpy(), atol=1e-4)


def test_preprocess_mm_matches_jax_image():
    """The matmul preprocess is interchangeable with the jax.image path
    (resize-as-separable-matmul with crop folded into row selection)."""
    from interactive_vit_tpu.ops.layers import preprocess
    from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

    for h, w in [(300, 400), (224, 224), (500, 280)]:
        x = np.random.default_rng(0).random((3, h, w)).astype(np.float32)
        a = np.asarray(preprocess(jnp.asarray(x), 224))
        b = np.asarray(preprocess_mm(jnp.asarray(x), 224))
        np.testing.assert_allclose(a, b, atol=1e-4)

    # batched input
    xb = np.random.default_rng(1).random((2, 3, 256, 320)).astype(np.float32)
    a = np.asarray(preprocess(jnp.asarray(xb), 224))
    b = np.asarray(preprocess_mm(jnp.asarray(xb), 224))
    np.testing.assert_allclose(a, b, atol=1e-4)
