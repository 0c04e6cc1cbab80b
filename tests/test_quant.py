"""Weight-only int8 quantization (ops/quant.py): numeric contract.

No pretrained weights exist in this image (zero egress), so the shipped
guarantee is numerical: per-channel symmetric quantization bounds the
weight error at scale/2, dequantization commutes with the matmul, and the
full ViT forward under int8 stays within the error expected from ~1%
per-layer weight noise. Accuracy (top-1 delta) must be validated on real
checkpoints before production use.
"""

import numpy as np

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.ops import layers as L
from interactive_vit_tpu.ops import quant


def test_roundtrip_exact_for_grid_weights():
    """Weights already on the quantization grid reproduce exactly."""
    rng = np.random.default_rng(0)
    scale = 0.01
    q = rng.integers(-127, 128, size=(64, 32)).astype(np.float32)
    q[0, :] = 127  # pin the per-column max so the scale is exactly `scale`
    w = jnp.asarray(q * scale)
    wq = quant.quantize_weight(w)
    assert wq[quant.QKEY].dtype == jnp.int8
    np.testing.assert_allclose(
        np.asarray(quant.dequantize_weight(wq)), np.asarray(w), rtol=1e-6)


def test_quant_error_bound():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((128, 96)).astype(np.float32))
    wq = quant.quantize_weight(w)
    err = np.abs(np.asarray(quant.dequantize_weight(wq)) - np.asarray(w))
    bound = np.asarray(wq[quant.SKEY]) / 2 + 1e-7
    assert (err <= bound[None, :]).all()


def test_linear_matches_dequantized():
    """(x @ q) * s == x @ dequant(w): scale commutes with the matmul."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((4, 7, 128)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((128, 64)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    wq = quant.quantize_weight(w)
    got = L.linear(x, wq, b)
    want = L.linear(x, quant.dequantize_weight(wq), b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_quantize_tree_structure():
    cfg = vit.VARIANTS["vit_t16"]
    params = vit.init_params(jax.random.key(0), cfg)
    qparams = quant.quantize_tree(params)
    blk = qparams["blocks"][0]
    assert quant.is_quantized(blk["qkv_w"])
    assert quant.is_quantized(blk["fc1_w"])
    assert not quant.is_quantized(blk["ln1_s"])  # norms untouched
    assert blk["qkv_b"].dtype == params["blocks"][0]["qkv_b"].dtype
    # first/last layers stay dense (standard weight-only exclusion)
    assert not quant.is_quantized(qparams["patch_embed"]["w"])
    assert not quant.is_quantized(qparams["head"]["w"])
    assert not quant.is_quantized(qparams["pos_emb"])


def test_vit_forward_int8_close_to_f32():
    """Full ViT-Tiny forward under weight-only int8 tracks f32 closely and
    preserves the argmax on a margin-checked input."""
    cfg = vit.VARIANTS["vit_t16"]
    params = vit.init_params(jax.random.key(0), cfg)
    qparams = quant.quantize_tree(params)
    x = jnp.asarray(
        np.random.default_rng(3).random((2, 3, 224, 224), np.float32))
    ref = vit.forward(params, x, cfg, want_attn=True)
    got = vit.forward(qparams, x, cfg, want_attn=True)
    r, g = np.asarray(ref["logits"]), np.asarray(got["logits"])
    # random-init logits are O(1); quantization noise compounds over 12
    # blocks but must stay well under the logit scale
    assert np.max(np.abs(r - g)) < 0.15 * (np.max(np.abs(r)) + 1e-6)
    # attention maps stay valid distributions
    a = np.asarray(got["attn"][0])
    np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-3)


def test_graph_path_runs_quantized(tmp_path):
    """The staged executor evaluates a quantized model graph end-to-end
    (int8 leaf-dicts ride the captures pytree)."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.wire.schema import GraphLibrary, graph_from_json

    cfg = vit.ViTConfig("vit_q8", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=10)
    vit.VARIANTS["vit_q8"] = cfg
    try:
        reg = Registry()
        register_builtin(reg)
        lib = GraphLibrary(str(tmp_path))
        model = make_vit_model("vit_q8", quantize=True)
        model.register(reg, lib)
        g = graph_from_json(lib.load("vit_q8.json"))
        img = np.random.default_rng(4).random((3, 32, 32)).astype(np.float32)
        g.add_input(img, g.nodes[0], "o")
        outs = Executor(reg=reg).run(g, taps="primary")
        head = max(i for i in outs if outs[i])
        logits = list(outs[head].values())[0]
        assert np.isfinite(logits).all()
    finally:
        del vit.VARIANTS["vit_q8"]


# -- W8A8 (dynamic activation quantization, int8 matmuls) --------------------


def test_quantize_acts_roundtrip_bound():
    """Per-token activation quantization error is bounded by scale/2."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((3, 17, 64)).astype(np.float32))
    q, s = quant.quantize_acts(x)
    assert q.dtype == jnp.int8
    err = np.abs(np.asarray(q, np.float32) * np.asarray(s) - np.asarray(x))
    assert (err <= np.asarray(s) / 2 + 1e-7).all()
    # zero rows don't produce NaNs
    q0, s0 = quant.quantize_acts(jnp.zeros((2, 4, 8)))
    assert np.isfinite(np.asarray(s0)).all()
    assert (np.asarray(q0) == 0).all()


def test_linear_w8a8_matches_dequantized():
    """W8A8 linear tracks the f32 matmul within the combined weight +
    activation quantization noise (both bounded by their scales)."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 9, 128)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((128, 64)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    wq = quant.quantize_weight(w, mode="w8a8")
    assert quant.is_w8a8(wq) and not quant.is_quantized(wq)
    got = np.asarray(L.linear(x, wq, b))
    want = np.asarray(L.linear(x, w, b))
    # ~1% relative error class: int8 grids on both operands over D=128
    assert np.max(np.abs(got - want)) < 0.05 * np.max(np.abs(want))


def test_vit_forward_w8a8_close_to_f32():
    """Full ViT-Tiny forward under W8A8: noisier than weight-only int8 but
    the logits must stay in-family and the maps valid distributions."""
    cfg = vit.VARIANTS["vit_t16"]
    params = vit.init_params(jax.random.key(0), cfg)
    qparams = quant.quantize_tree(params, mode="w8a8")
    blk = qparams["blocks"][0]
    assert quant.is_w8a8(blk["fc1_w"])
    x = jnp.asarray(
        np.random.default_rng(7).random((2, 3, 224, 224), np.float32))
    ref = vit.forward(params, x, cfg, want_attn=True)
    got = vit.forward(qparams, x, cfg, want_attn=True)
    r, g = np.asarray(ref["logits"]), np.asarray(got["logits"])
    assert np.max(np.abs(r - g)) < 0.3 * (np.max(np.abs(r)) + 1e-6)
    a = np.asarray(got["attn"][0])
    np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-3)


def test_w8a8_param_specs_shard_like_dense():
    """W8A8 leaves inherit the dense parent's TP layout (parallel/mesh)."""
    from jax.sharding import PartitionSpec as P

    from interactive_vit_tpu.parallel.mesh import param_spec

    assert param_spec("blocks/0/qkv_w/int8a8_q") == P(None, "model")
    assert param_spec("blocks/0/qkv_w/int8a8_s") == P("model")
    assert param_spec("blocks/0/proj_w/int8a8_q") == P("model", None)
    assert param_spec("blocks/0/proj_w/int8a8_s") == P(None)


def test_graph_path_runs_w8a8(tmp_path):
    """The staged executor evaluates a W8A8 model graph end-to-end (the
    plugin quantizes fc1/fc2 only; attention linears stay dense so the
    fused-block/XLA attention path is preserved)."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.wire.schema import GraphLibrary, graph_from_json

    cfg = vit.ViTConfig("vit_qa8", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=10)
    vit.VARIANTS["vit_qa8"] = cfg
    try:
        reg = Registry()
        register_builtin(reg)
        lib = GraphLibrary(str(tmp_path))
        model = make_vit_model("vit_qa8", quantize="w8a8")
        blk = model.params["blocks"][0]
        assert quant.is_w8a8(blk["fc1_w"])
        assert not quant.is_w8a8(blk["qkv_w"])  # attention stays dense
        model.register(reg, lib)
        g = graph_from_json(lib.load("vit_qa8.json"))
        img = np.random.default_rng(8).random((3, 32, 32)).astype(np.float32)
        g.add_input(img, g.nodes[0], "o")
        outs = Executor(reg=reg).run(g, taps="primary")
        head = max(i for i in outs if outs[i])
        logits = list(outs[head].values())[0]
        assert np.isfinite(logits).all()
    finally:
        del vit.VARIANTS["vit_qa8"]
