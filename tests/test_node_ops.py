"""Built-in node-kind semantics vs the reference WGSL/torch behaviors."""

import os
import base64
import json

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.wire.schema import graph_from_json

# the reference's own saved graphs, as committed copies in this repo
GRAPHS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "static", "graphs")


@pytest.fixture
def ex():
    r = Registry()
    register_builtin(r)
    return Executor(r)


def run_one(ex, kind, params, inputs):
    g = Graph()
    n = g.add_node(kind, params)
    for ch, v in inputs.items():
        g.add_input(np.asarray(v, np.float32), n, ch)
    return ex.run(g, taps="all")[0]


def test_binop_all_ops(ex):
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([4.0, 5.0, 6.0], np.float32)
    for op, fn in [("+", np.add), ("-", np.subtract), ("*", np.multiply), ("/", np.divide)]:
        out = run_one(ex, "binop", {"op": op}, {"a": a, "b": b})
        np.testing.assert_allclose(out["c"], fn(a, b), rtol=1e-6)


def test_slice_semantics(ex):
    # y = x[1, :, :] : fixed dim0=1, free in 1->out 0, in 2->out 1
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    params = {
        "fixed": json.dumps([{"dim": 0, "val": 1}]),
        "free": json.dumps([{"in_dim": 1, "out_dim": 0}, {"in_dim": 2, "out_dim": 1}]),
    }
    out = run_one(ex, "slice", params, {"o": x})
    np.testing.assert_array_equal(out["o"], x[1])


def test_slice_with_transpose(ex):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    params = {
        "fixed": json.dumps([{"dim": 0, "val": 0}]),
        "free": json.dumps([{"in_dim": 1, "out_dim": 1}, {"in_dim": 2, "out_dim": 0}]),
    }
    out = run_one(ex, "slice", params, {"o": x})
    np.testing.assert_array_equal(out["o"], x[0].T)


def test_shuffle_permutation(ex):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    params = {
        "fixed": json.dumps([]),
        "free": json.dumps(
            [
                {"in_dim": 0, "out_dim": 2},
                {"in_dim": 1, "out_dim": 0},
                {"in_dim": 2, "out_dim": 1},
            ]
        ),
    }
    out = run_one(ex, "shuffle", params, {"o": x})
    np.testing.assert_array_equal(out["o"], np.transpose(x, (1, 2, 0)))


def test_const_and_noise(ex):
    out = run_one(ex, "const", {"value": "0.8", "dims": "[2, 3]"}, {})
    np.testing.assert_allclose(out["o"], np.full((2, 3), 0.8, np.float32))

    n1 = run_one(ex, "noise", {"dims": "[16]", "seed": "1"}, {})["o"]
    n2 = run_one(ex, "noise", {"dims": "[16]", "seed": "2"}, {})["o"]
    assert n1.shape == (16,)
    assert np.all((np.asarray(n1) >= 0) & (np.asarray(n1) < 1))
    assert not np.array_equal(np.asarray(n1), np.asarray(n2))


def test_conv2d_identity_kernel(ex):
    x = np.random.default_rng(0).random((1, 8, 8)).astype(np.float32)
    out = run_one(ex, "conv2d", {"w": "3", "h": "3"}, {"o": x})  # default = identity
    np.testing.assert_allclose(out["o"], x[:, 1:-1, 1:-1], atol=1e-6)


def test_conv2d_box_blur_matches_numpy(ex):
    rng = np.random.default_rng(1)
    x = rng.random((2, 10, 12)).astype(np.float32)
    k = np.full((3, 3), 1 / 9, np.float32)
    params = {
        "w": "3",
        "h": "3",
        "matrix": base64.b64encode(k.tobytes()).decode(),
    }
    out = run_one(ex, "conv2d", params, {"o": x})["o"]
    # reference: direct valid conv, output shrinks by 2*(k//2)
    expect = np.zeros((2, 8, 10), np.float32)
    for c in range(2):
        for i in range(8):
            for j in range(10):
                expect[c, i, j] = (x[c, i : i + 3, j : j + 3] * k).sum()
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_conv2d_2d_input(ex):
    x = np.random.default_rng(2).random((6, 6)).astype(np.float32)
    out = run_one(ex, "conv2d", {"w": "3", "h": "3"}, {"o": x})["o"]
    assert out.shape == (4, 4)


def test_resize_shapes(ex):
    x = np.random.default_rng(0).random((3, 32, 48)).astype(np.float32)
    out = run_one(ex, "resize", {"dims": "[16, 24]"}, {"o": x})["o"]
    assert out.shape == (3, 16, 24)


def test_reference_saved_graph_noise_json_evaluates(ex):
    """The saved noise demo graph evaluates fully server-side."""
    with open(os.path.join(GRAPHS, "demo_noise.json")) as f:
        obj = json.load(f)
    g = graph_from_json(obj)
    out = ex.run(g, taps="all")
    # node 3 = final binop "+": noise * 0.5 + 0.5 per demo_noise.json
    c = np.asarray(out[3]["c"])
    assert c.shape == (128, 128)
    assert np.isfinite(c).all()
    np.testing.assert_allclose(c, np.asarray(out[0]["o"]) * 0.5 + 0.5,
                               rtol=1e-6)


def test_reference_saved_graph_slice_json_evaluates(ex):
    with open(os.path.join(GRAPHS, "demo_slice.json")) as f:
        obj = json.load(f)
    g = graph_from_json(obj)
    # img_src is an identity node: bind a synthetic CHW image to it
    img = np.random.default_rng(0).random((3, 20, 30)).astype(np.float32)
    g.add_input(img, g.nodes[0], "o")
    out = ex.run(g, taps="all")
    np.testing.assert_array_equal(out[1]["o"], img[1])         # slice [1,:,:]
    np.testing.assert_array_equal(out[2]["o"], img[1].T)       # shuffle swap
    conv = np.asarray(out[3]["o"])                      # valid 3x3 conv2d
    assert conv.shape[-2:] == (18, 28) and np.isfinite(conv).all()


def test_contents_serve_editable_html():
    """Server-delivered editable node UIs (the contents/ contract,
    reference main/context.py:90-92): every parameterized builtin ships
    data-param-bound inputs; conv2d ships its editable matrix table with
    current values."""
    import base64 as b64

    reg = Registry()
    register_builtin(reg)
    assert 'data-param="A"' in reg.get_node("cos").contents({"A": "2.0"})
    assert 'value="2.0"' in reg.get_node("cos").contents({"A": "2.0"})
    binop = reg.get_node("binop").contents({"op": "*"})
    assert 'data-param="op"' in binop and 'value="*" selected' in binop
    assert 'data-param="dims"' in reg.get_node("noise").contents({})
    assert 'data-param="value"' in reg.get_node("const").contents({})
    assert 'data-param="dims"' in reg.get_node("resize").contents({})
    sl = reg.get_node("slice").contents(
        {"fixed": '[{"dim": 0, "val": 2}]',
         "free": '[{"in_dim": 1, "out_dim": 0}]'})
    assert "y = x[2, d0]" in sl

    m = np.arange(9, dtype="<f4")
    html = reg.get_node("conv2d").contents(
        {"h": "3", "w": "3", "matrix": b64.b64encode(m.tobytes()).decode()})
    assert 'data-matrix' in html and 'data-cell="2,2"' in html
    assert 'value="8"' in html


# -- dense-feature visualization nodes (DINO-style) ---------------------------


def _tokens(b=2, n=17, d=32, seed=3):
    """Random token sequence with a CLS slot: [B, 1+16, D] (4x4 grid)."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, d)).astype(np.float32)


def test_pca_view_matches_numpy_pca(ex):
    x = _tokens()
    out = run_one(ex, "pca_view", {"skip": "1"}, {"o": x})["o"]
    assert out.shape == (2, 3, 4, 4)
    assert out.min() >= 0.0 and out.max() <= 1.0 + 1e-6

    # numpy reference PCA per image; eigenvector SIGN is arbitrary, so
    # each channel must match either the reference map or its flip
    for b in range(2):
        t = x[b, 1:].astype(np.float64)
        t = t - t.mean(axis=0, keepdims=True)
        _, vecs = np.linalg.eigh(t.T @ t / t.shape[0])
        proj = t @ vecs[:, -3:][:, ::-1]  # [P, 3], PC1 first
        lo, hi = proj.min(axis=0), proj.max(axis=0)
        ref = (proj - lo) / np.maximum(hi - lo, 1e-8)
        got = out[b].reshape(3, 16).T  # [P, 3]
        for c in range(3):
            err_same = np.abs(got[:, c] - ref[:, c]).max()
            err_flip = np.abs(got[:, c] - (1.0 - ref[:, c])).max()
            # tolerance = the 8-bit rendering quantum (1/255 ~ 4e-3): the
            # node uses matmul-only subspace iteration, not exact eigh,
            # and sub-quantum error is invisible in the RGB map
            assert min(err_same, err_flip) < 8e-3, (c, err_same, err_flip)


def test_pca_view_rejects_nonsquare_grid(ex):
    from interactive_vit_tpu.graph.executor import NodeError

    with pytest.raises(NodeError):
        run_one(ex, "pca_view", {"skip": "1"}, {"o": _tokens(n=18)})


def test_patch_sim_cls_query(ex):
    x = _tokens()
    out = run_one(ex, "patch_sim", {}, {"o": x})["o"]
    assert out.shape == (2, 3, 4, 4)
    # all three channels identical (grayscale replicate)
    np.testing.assert_array_equal(out[:, 0], out[:, 1])

    for b in range(2):
        cls, patches = x[b, 0], x[b, 1:]
        sim = patches @ cls / (
            np.linalg.norm(patches, axis=1) * np.linalg.norm(cls))
        ref = ((sim + 1) / 2).reshape(4, 4)
        np.testing.assert_allclose(out[b, 0], ref, atol=1e-5)


def test_patch_sim_patch_query_is_self_similar(ex):
    x = _tokens()
    out = run_one(ex, "patch_sim", {"row": "2", "col": "1"}, {"o": x})["o"]
    # the query patch has cosine similarity 1 with itself -> value 1.0
    assert out[0, 0, 2, 1] == pytest.approx(1.0, abs=1e-5)
    assert out.min() >= 0.0 and out.max() <= 1.0 + 1e-6


def test_similarity_zero_embedding_is_finite(ex):
    """A zero embedding (e.g. a const-0 node wired in) must yield zero
    similarity, not NaN logits (unguarded 0/0 in the L2 normalize)."""
    a = np.zeros((4,), np.float32)
    b = np.ones((3, 4), np.float32)
    out = run_one(ex, "similarity", {}, {"a": a, "b": b})["o"]
    assert np.isfinite(np.asarray(out)).all()
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-6)


def test_viewer_sinks_accept_partial_wiring(ex):
    """attn_view/overlay are optional-input sinks: wiring only one channel
    must evaluate (the frontend routinely wires just 'attn' or just 'r')."""
    g = Graph()
    n = g.add_node("attn_view", {})
    g.add_input(np.zeros((1, 2, 5, 5), np.float32), n, "attn")
    ex.run(g, taps="all")  # no missing-input error


def test_pca_view_model_scale_tokens(ex):
    """Subspace iteration at real model scale (D=384, 196 patches).

    Trained-feature token clouds have a few dominant directions (that is
    what makes the DINO PCA figure work); iid Gaussian tokens do NOT —
    their Marchenko-Pastur spectrum has no eigengap, so individual PCs
    are unrecoverable by any iterative method AND visually meaningless.
    Test with a planted spectrum (3 strong directions over noise), the
    regime the node exists for."""
    rng = np.random.default_rng(7)
    u = np.linalg.qr(rng.standard_normal((384, 3)))[0]  # planted dirs
    coef = rng.standard_normal((196, 3)) * np.array([9.0, 6.0, 4.0])
    x1 = (coef @ u.T + 0.5 * rng.standard_normal((196, 384))) \
        .astype(np.float32)
    x = np.concatenate([np.zeros((1, 384), np.float32), x1])[None]

    out = run_one(ex, "pca_view", {"skip": "1"}, {"o": x})["o"]
    assert out.shape == (1, 3, 14, 14)
    t = x[0, 1:].astype(np.float64)
    t = t - t.mean(axis=0, keepdims=True)
    _, vecs = np.linalg.eigh(t.T @ t / t.shape[0])
    proj = t @ vecs[:, -3:][:, ::-1]
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    ref = (proj - lo) / np.maximum(hi - lo, 1e-8)
    got = out[0].reshape(3, 196).T
    for c in range(3):
        err = min(np.abs(got[:, c] - ref[:, c]).max(),
                  np.abs(got[:, c] - (1.0 - ref[:, c])).max())
        assert err < 8e-3, (c, err)
