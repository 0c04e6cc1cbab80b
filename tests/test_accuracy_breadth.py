"""Accuracy breadth: for every registered image family, at its smallest
variant and in float32 and bfloat16, the executor's generated graph
(transform -> ... -> head, as served) matches the family's monolithic
jnp forward on the same seeded weights.

float32 is the parity contract (1e-4 of the output scale). bfloat16 is
held to BF16_REL of the output scale: the two paths round at different
points (the graph norms every token before the head reads CLS, fusions
differ), and bf16 keeps 8 significant bits.

Not covered here: clip_text_b32 (token input, tests/test_clip_text.py),
the MAE pretraining graph (random masking, tests/test_mae.py), and
vit_moe_s16 in bfloat16 (XLA's CPU backend has no bf16 x bf16 -> f32
kernel for the expert dispatch dots; it runs on the GPU).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.models.autoregister import make_model
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.wire.schema import graph_from_json

F32_REL = 1e-4
BF16_REL = 5e-2


def _vit(params, x, cfg):
    from interactive_vit_tpu.models import vit

    return vit.forward(params, x, cfg)["logits"]


def _family(variant):
    """(monolithic forward(params, x), config) for ``variant``."""
    from interactive_vit_tpu.models import (
        clip, convnext, moe, resnet, swin, tome, vgg, vit,
    )

    if variant == "clip_b32":
        cfg = clip.CLIPVisionConfig()
        return lambda p, x: clip.forward(p, x, cfg)["embedding"]
    if variant == "vgg16":
        return vgg.forward
    if variant == "resnet50":
        return resnet.forward
    if variant.startswith("convnext_"):
        cfg = convnext.VARIANTS[variant]
        return lambda p, x: convnext.forward(p, x, cfg)
    if variant.startswith("swin_"):
        cfg = swin.VARIANTS[variant]
        return lambda p, x: swin.forward(p, x, cfg)["logits"]
    if variant.startswith("vit_moe"):
        cfg = moe.VARIANTS[variant]
        return lambda p, x: moe.forward(p, x, cfg)["logits"]
    if "_tome" in variant:
        cfg = tome.VARIANTS[variant]
        return lambda p, x: tome.forward(p, x, cfg)["logits"]
    cfg = vit.VARIANTS[variant]
    return lambda p, x: _vit(p, x, cfg)


FAMILIES = ["vit_t16", "deit_t16", "dino_s16", "dinov2_s14",
            "dinov2_s14_reg", "clip_b32", "vgg16", "resnet50",
            "convnext_t", "swin_t", "vit_moe_s16", "vit_s16_tome"]


CASES = [(v, d) for v in FAMILIES for d in ("float32", "bfloat16")
         if (v, d) != ("vit_moe_s16", "bfloat16")]


@pytest.mark.parametrize("variant,dtype", CASES)
def test_graph_matches_monolithic_forward(variant, dtype):
    dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model = make_model(variant, dtype=dt, seed=0)
    reg = Registry()
    register_builtin(reg)
    model.register(reg)
    g = graph_from_json(model.generate_graph_json())
    img = np.random.default_rng(0).random((1, 3, 224, 224), np.float32)
    g.add_input(img, g.nodes[0], "o")
    last = model.prefix() + model.list_node_names()[-1].split(":", 1)[1]
    out_idx = next(n.index for n in g.nodes if n.name == last)
    got = Executor(reg).run(g, taps={(out_idx, "o")})[out_idx]["o"]

    transform = model.layers[0][2]
    x = transform({}, {"o": jnp.asarray(img)})["o"]
    fwd = _family(variant)
    ref = jax.jit(fwd)(model.params, x)

    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    rel = F32_REL if dtype == "float32" else BF16_REL
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (variant, dtype, err, scale)
