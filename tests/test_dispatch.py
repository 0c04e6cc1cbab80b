"""Attention dispatch policy (ops/dispatch.py): one table keyed by the
backend string, the dtype, whether the maps are wanted and the head
dim."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import dispatch
from interactive_vit_tpu.ops.attention import attention_reference


@pytest.mark.parametrize("platform,dtype,want,dh,expected", [
    ("gpu", jnp.bfloat16, True, 64, "gpu_probs"),
    ("gpu", jnp.bfloat16, False, 64, "cudnn"),
    ("gpu", jnp.float32, True, 64, "reference"),
    ("gpu", jnp.float32, False, 64, "reference"),
    ("gpu", jnp.float16, True, 64, "reference"),
    ("cpu", jnp.bfloat16, True, 64, "reference"),
    ("cpu", jnp.bfloat16, False, 64, "reference"),
    ("cpu", jnp.float32, True, 64, "reference"),
    ("METAL", jnp.bfloat16, True, 64, "reference"),
    ("METAL", jnp.bfloat16, False, 64, "reference"),
    # head dims: the probs kernel takes powers of two, cuDNN multiples
    # of 8 up to 128
    ("gpu", jnp.bfloat16, True, 80, "reference"),
    ("gpu", jnp.bfloat16, False, 80, "cudnn"),
    ("gpu", jnp.bfloat16, True, 48, "reference"),
    ("gpu", jnp.bfloat16, False, 48, "cudnn"),
    ("gpu", jnp.bfloat16, True, 128, "gpu_probs"),
    ("gpu", jnp.bfloat16, False, 128, "cudnn"),
    ("gpu", jnp.bfloat16, True, 256, "gpu_probs"),
    ("gpu", jnp.bfloat16, False, 256, "reference"),
    ("gpu", jnp.bfloat16, True, 36, "reference"),
    ("gpu", jnp.bfloat16, False, 36, "reference"),
    ("gpu", jnp.float32, True, 80, "reference"),
    ("cpu", jnp.bfloat16, False, 80, "reference"),
])
def test_choose_attention_table(platform, dtype, want, dh, expected):
    """The backend string passed in decides; f32 (the parity path) never
    gets a kernel; only "gpu" has kernels, each for the head dims it
    takes."""
    assert dispatch.choose_attention(dtype, want, dh, platform) == expected


@pytest.mark.parametrize("want", [True, False])
def test_choose_attention_defaults_to_this_backend(want):
    assert jax.default_backend() == "cpu"
    assert dispatch.choose_attention(jnp.bfloat16, want, 64) == "reference"


def _registered_head_dims():
    """(name, head dim) of every registered config that routes attention
    through the dispatcher: the vit family (ViT, DeiT, DINO, DINOv2), the
    MoE family and the CLIP vision tower."""
    from interactive_vit_tpu.models import clip, moe, vit

    cfgs = dict(vit.VARIANTS)
    cfgs.update(moe.VARIANTS)
    cfgs["clip_vision"] = clip.CLIPVisionConfig()
    return sorted((k, c.width // c.heads) for k, c in cfgs.items())


@pytest.mark.parametrize("name,dh", _registered_head_dims())
def test_gpu_choice_runs_for_every_registered_head_dim(name, dh):
    """On "gpu" in bf16 the probs kernel is picked only for head dims it
    takes (ViT-H/14's 80 is not a power of two: plain path), and cuDNN
    only for head dims it takes; the chosen path then runs at that head
    dim (the Triton kernel in interpret mode) and matches the plain
    path."""
    from interactive_vit_tpu.ops.gpu_attention import attention_probs

    maps = dispatch.choose_attention(jnp.bfloat16, True, dh, "gpu")
    assert maps == ("gpu_probs" if dh & (dh - 1) == 0 else "reference")
    assert dispatch.choose_attention(jnp.bfloat16, False, dh, "gpu") == (
        "cudnn" if dh % 8 == 0 and dh <= 128 else "reference")
    if maps == "gpu_probs":
        ks = jax.random.split(jax.random.key(dh), 3)
        q, k, v = (jax.random.normal(x, (1, 1, 20, dh), jnp.float32)
                   .astype(jnp.bfloat16) for x in ks)
        out, probs = attention_probs(q, k, v, interpret=True)
        ro, rp = attention_reference(q, k, v, want_attn=True)
        assert float(jnp.abs(probs.astype(jnp.float32) - rp).max()) < 1e-2
        assert float(jnp.abs(out.astype(jnp.float32)
                             - ro.astype(jnp.float32)).max()) < 5e-2


@pytest.mark.parametrize("name", [
    "flash", "flash_vjp", "int8-scores", "int8-scores-qk", "fused",
    "headwise", "nope"])
def test_deleted_kernel_names_raise(name):
    with pytest.raises(ValueError, match="unknown attention policy"):
        dispatch.default_attn_impl(name)


def test_policy_names_resolve():
    assert dispatch.POLICIES == ("auto", "reference")
    assert dispatch.default_attn_impl("reference") is None
    assert dispatch.default_attn_impl("auto") is dispatch.auto_attention
    assert dispatch.default_attn_impl() is dispatch.auto_attention


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("want", [True, False])
def test_auto_attention_off_gpu_is_the_plain_path(dtype, want):
    ks = jax.random.split(jax.random.key(0), 3)
    q, k, v = (jax.random.normal(x, (2, 3, 20, 16), jnp.float32)
               .astype(dtype) for x in ks)
    got = dispatch.auto_attention(q, k, v, want_attn=want, n_real=17)
    ref = attention_reference(q, k, v, want_attn=want, n_real=17)
    np.testing.assert_array_equal(np.asarray(got[0], np.float32),
                                  np.asarray(ref[0], np.float32))
    assert (got[1] is None) == (not want)


def test_server_attn_flag_offers_only_policies():
    """``--attn`` choices come from the one policy table."""
    import argparse
    import sys

    from interactive_vit_tpu.serving import server

    captured = {}

    def fake_parse(self, args=None, namespace=None):
        captured["attn"] = next(a for a in self._actions
                                if a.dest == "attn").choices
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = fake_parse
    argv = sys.argv
    try:
        sys.argv = ["ivt-server"]
        with pytest.raises(SystemExit):
            server.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
        sys.argv = argv
    assert list(captured["attn"]) == list(dispatch.POLICIES)


def test_vit_block_routes_through_attn_impl():
    """vit.block hands q/k/v to the implementation it is given, so the
    dispatcher's choice is what runs."""
    from interactive_vit_tpu.models import vit

    cfg = vit.ViTConfig("vit_dp", img_size=16, patch=8, width=32, depth=1,
                        heads=2, num_classes=3)
    params = vit.init_params(jax.random.key(0), cfg)
    seen = []

    def impl(q, k, v, want_attn=False, n_real=None):
        seen.append((q.shape, want_attn))
        return attention_reference(q, k, v, want_attn=want_attn,
                                   n_real=n_real)

    x = jnp.ones((1, cfg.tokens, 32))
    vit.block(params["blocks"][0], x, cfg, want_attn=True, attn_impl=impl)
    assert seen == [((1, 2, cfg.tokens, 16), True)]
