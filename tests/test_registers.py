"""DINOv2-class ViTs: register tokens + LayerScale residuals.

The torch oracle below is a naming-faithful transliteration of the timm
``vit_*_dinov2`` / ``*_reg4_dinov2`` construction (timm itself is not in
this image): fused-qkv pre-LN attention with ``ls1.gamma``/``ls2.gamma``
LayerScale, ``reg_token`` inserted after CLS **post position-add** with
no positional embedding, CLS feature output (num_classes=0). Pins
``weights.from_timm`` and the forward semantics to the real checkpoint
format. Reference contract: the generic model explosion
(``/root/reference/main/context.py:38-47``) — registers ride the same
tappable node surface.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit, weights

CFG = vit.ViTConfig("dinov2_micro", img_size=32, patch=8, width=48,
                    depth=2, heads=4, num_classes=0, layer_scale=1e-5,
                    registers=2)


class TorchBlock(nn.Module):
    """timm Block with LayerScale: norm1/attn.qkv/attn.proj/ls1,
    norm2/mlp.fc1/fc2/ls2 — the exact state-dict names."""

    class LS(nn.Module):
        def __init__(self, d):
            super().__init__()
            self.gamma = nn.Parameter(torch.ones(d) * 1e-5)

        def forward(self, x):
            return x * self.gamma

    class Attn(nn.Module):
        def __init__(self, d, heads):
            super().__init__()
            self.qkv = nn.Linear(d, 3 * d)
            self.proj = nn.Linear(d, d)
            self.heads = heads

        def forward(self, x):
            b, n, d = x.shape
            h = self.heads
            qkv = self.qkv(x).reshape(b, n, 3, h, d // h)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            a = (q @ k.transpose(-2, -1)) / math.sqrt(d // h)
            o = (a.softmax(-1) @ v).transpose(1, 2).reshape(b, n, d)
            return self.proj(o)

    class Mlp(nn.Module):
        def __init__(self, d, md):
            super().__init__()
            self.fc1 = nn.Linear(d, md)
            self.fc2 = nn.Linear(md, d)

        def forward(self, x):
            return self.fc2(nn.functional.gelu(self.fc1(x)))

    def __init__(self, d, heads, md):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = self.Attn(d, heads)
        self.ls1 = self.LS(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = self.Mlp(d, md)
        self.ls2 = self.LS(d)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class TorchDinov2(nn.Module):
    def __init__(self, cfg, no_embed_class=False):
        super().__init__()
        d = cfg.width
        grid = (cfg.img_size // cfg.patch) ** 2
        self.patch_embed_proj = nn.Conv2d(3, d, cfg.patch, cfg.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_token = nn.Parameter(torch.zeros(1, cfg.registers, d))
        self.no_embed_class = no_embed_class
        rows = grid if no_embed_class else grid + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, rows, d))
        self.blocks = nn.ModuleList(
            [TorchBlock(d, cfg.heads, cfg.mlp_dim)
             for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def state_dict_timm(self):
        sd = {}
        for k, v in self.state_dict().items():
            k = k.replace("patch_embed_proj", "patch_embed.proj")
            sd[k] = v.numpy()
        return sd

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed_proj(x).flatten(2).transpose(1, 2)  # [B,N,D]
        cls = self.cls_token.expand(b, -1, -1)
        if self.no_embed_class:
            x = x + self.pos_embed
            x = torch.cat([cls, x], dim=1)
        else:
            x = torch.cat([cls, x], dim=1) + self.pos_embed
        regs = self.reg_token.expand(b, -1, -1)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]  # CLS features


def _oracle(no_embed_class=False, seed=0):
    torch.manual_seed(seed)
    m = TorchDinov2(CFG, no_embed_class=no_embed_class).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    return m


@pytest.mark.parametrize("no_embed_class", [False, True])
def test_from_timm_feature_parity(no_embed_class):
    """Converted reg+LayerScale checkpoints match the torch oracle —
    including timm's no_embed_class storage (grid-only pos table)."""
    m = _oracle(no_embed_class)
    params = weights.from_timm(m.state_dict_timm(), CFG)
    assert params["reg_tokens"].shape == (1, 2, 48)
    assert params["pos_emb"].shape == (1, CFG.pos_tokens, 48)
    x = np.random.default_rng(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    out = vit.forward(params, jnp.asarray(x), CFG)
    got = np.asarray(out["logits"])  # num_classes=0 -> CLS features
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_config_contract():
    assert CFG.prefix_tokens == 3 and CFG.tokens == 16 + 3
    assert CFG.pos_tokens == 16 + 1
    with pytest.raises(ValueError, match="distilled \\+ registers"):
        vit.ViTConfig("bad", distilled=True, registers=4)
    for name in ("dinov2_s14", "dinov2_b14_reg"):
        cfg = vit.VARIANTS[name]
        assert cfg.layer_scale == 1e-5 and cfg.num_classes == 0
    assert vit.VARIANTS["dinov2_s14_reg"].registers == 4


def test_register_rows_are_pos_free():
    params = vit.init_params(jax.random.key(0), CFG)
    img = jnp.asarray(np.random.default_rng(2).random(
        (1, 3, 32, 32), np.float32))
    t = vit.embed(params, img, CFG)
    assert t.shape == (1, CFG.tokens, 48)
    # rows 1..R are exactly the register params: no pos was added
    np.testing.assert_array_equal(np.asarray(t[0, 1:3]),
                                  np.asarray(params["reg_tokens"][0]))


def test_layer_scale_guard_rejects_kernels():
    """An attention implementation handed to the block (the dispatcher's
    ``auto_attention``) cannot skip the LayerScale gammas: with both
    gammas zeroed the block is the identity."""
    from interactive_vit_tpu.ops.dispatch import auto_attention

    params = vit.init_params(jax.random.key(0), CFG)
    p = dict(params["blocks"][0])
    p["ls1"] = jnp.zeros_like(p["ls1"])
    p["ls2"] = jnp.zeros_like(p["ls2"])
    x = jax.random.normal(jax.random.key(1), (1, CFG.tokens, 48))
    y, _, _ = vit.block(p, x, CFG, attn_impl=auto_attention)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_adapt_pos_embed_keeps_registers_out():
    params = vit.init_params(jax.random.key(0), CFG)
    cfg48 = dataclasses.replace(CFG, name="dinov2_micro@48", img_size=48)
    out = vit.adapt_checkpoint(params, cfg48)
    assert out["pos_emb"].shape == (1, 6 * 6 + 1, 48)  # grid + CLS only
    np.testing.assert_array_equal(np.asarray(out["reg_tokens"]),
                                  np.asarray(params["reg_tokens"]))
    # and the derived model still runs
    img = jnp.asarray(np.random.default_rng(3).random(
        (1, 3, 48, 48), np.float32))
    feats = vit.forward(out, img, cfg48)["logits"]
    assert feats.shape == (1, 48)
    assert np.isfinite(np.asarray(feats)).all()


def test_graph_surface_serves_registers():
    """The generated graph evaluates through the executor; attention taps
    span the full token count (CLS + registers + patches)."""
    from unittest import mock

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.wire.schema import graph_from_json

    with mock.patch.dict(vit.VARIANTS, {"dinov2_micro": CFG}):
        reg = Registry()
        register_builtin(reg)
        model = make_vit_model("dinov2_micro", with_categories=False)
        model.register(reg)
        g = graph_from_json(model.generate_graph_json())
        img = np.random.default_rng(4).random((1, 3, 32, 32), np.float32)
        for n in g.nodes:
            if not n.inputs and n.name.endswith(":transform"):
                g.add_input(jnp.asarray(img), n, "o")
        outs = Executor(reg).run(g, taps="all")
        shapes = {v.shape for d in outs.values() for v in d.values()}
        assert (1, 4, 19, 19) in shapes  # attn over CLS+2reg+16 patches


def test_layer_scale_sharded_forward_matches_local():
    """ls gammas replicate under TP (they scale the full-width branch
    output); DP x TP forward == local."""
    from interactive_vit_tpu.parallel import mesh as mesh_lib

    params = vit.init_params(jax.random.key(0), CFG)
    img = jnp.asarray(np.random.default_rng(5).random(
        (8, 3, 32, 32), np.float32))
    want = np.asarray(vit.forward(params, img, CFG)["logits"])
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    with mesh:
        sp = mesh_lib.shard_params(params, mesh)
        xs = jax.device_put(img, mesh_lib.batch_sharding(mesh))
        got = np.asarray(jax.jit(
            lambda p, i: vit.forward(p, i, CFG)["logits"])(sp, xs))
    np.testing.assert_allclose(got, want, atol=1e-4)
