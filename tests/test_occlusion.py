"""Occlusion-sensitivity node: forward-only sliding-mask attribution.

No reference analog (its server computed single forwards under
``torch.no_grad``, ``/root/reference/main/context.py:79-88``). These
tests pin the drop-grid math against independent numpy replications of
the published construction (Zeiler & Fergus sliding occluder), the
coverage-normalized canvas render, the per-sample batching semantics,
and the executor contracts the node shares with the gradient kinds
(dynamic captures without recompiles, per-node error attribution, eager
parity) — plus the one contract it does NOT share: its replay keeps
kernel-backed node fns (``differentiates = False``).
"""

import numpy as np
import pytest

from interactive_vit_tpu.graph.executor import Executor, NodeError
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import NodeKind, Registry
from interactive_vit_tpu.ops.node_ops import register_builtin


@pytest.fixture
def reg():
    r = Registry()
    register_builtin(r)
    return r


@pytest.fixture
def ex(reg):
    return Executor(reg)


def occ_chain(x, occ_params, mid=("cos", {"A": "1.0", "b": "0.0"})):
    """input -> mid node -> occlusion; returns (graph, occ node index)."""
    g = Graph()
    m = g.add_node(mid[0], mid[1])
    o = g.add_node("occlusion", occ_params)
    g.connect(m, "o", o, "o")
    g.add_input(np.asarray(x, np.float32), m, "o")
    return g, o.index


def numpy_occlusion(x, fwd, patch, stride, fill=0.0):
    """Independent replication of the node's algorithm: per-window score
    drop grid + coverage-normalized canvas. ``fwd`` maps the full array
    to a scalar score. Unbatched [C,H,W] only."""
    H, W = x.shape[-2:]
    ph, pw = min(patch, H), min(patch, W)
    gh = 1 + -(-(H - ph) // stride)
    gw = 1 + -(-(W - pw) // stride)
    base = fwd(x)
    drops = np.zeros((gh, gw), np.float32)
    canvas = np.zeros((H, W), np.float32)
    count = np.zeros((H, W), np.float32)
    for i in range(gh):
        for j in range(gw):
            py = min(i * stride, H - ph)
            px = min(j * stride, W - pw)
            xo = x.copy()
            xo[..., py:py + ph, px:px + pw] = fill
            d = base - fwd(xo)
            drops[i, j] = d
            canvas[py:py + ph, px:px + pw] += d
            count[py:py + ph, px:px + pw] += 1.0
    heat = canvas / np.maximum(count, 1.0)
    heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-12)
    return drops, np.broadcast_to(heat, (3, H, W))


def test_drop_grid_matches_analytic_cos(ex):
    # model = cos(x); score = sum cos(x). Occluding window R with fill 0
    # drops the score by sum_R (cos(x) - cos(0)) = sum_R (cos(x) - 1).
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8)).astype(np.float32)
    g, o = occ_chain(x, {"target": "sum", "patch": "4", "stride": "4"})
    out = ex.run(g, taps={(o, "g"), (o, "o")})
    drops, heat = numpy_occlusion(
        x, lambda a: np.sum(np.cos(a)), patch=4, stride=4)
    assert out[o]["g"].shape == (2, 2)
    np.testing.assert_allclose(out[o]["g"], drops, atol=1e-4)
    # stride == patch: each pixel covered exactly once -> the canvas is
    # the drop broadcast per window, relu'd and max-normalized
    assert out[o]["o"].shape == (3, 8, 8)  # input-shaped (img_view-ready)
    np.testing.assert_allclose(out[o]["o"], heat, atol=1e-4)


def test_overlapping_windows_coverage_normalized(ex):
    # stride < patch: pixels sit under several windows; the canvas must
    # average the drops over the covering windows (count-normalized)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 6, 6)).astype(np.float32)
    g, o = occ_chain(x, {"target": "sum", "patch": "4", "stride": "2"})
    out = ex.run(g, taps={(o, "g"), (o, "o")})
    drops, heat = numpy_occlusion(
        x, lambda a: np.sum(np.cos(a)), patch=4, stride=2)
    np.testing.assert_allclose(out[o]["g"], drops, atol=1e-4)
    np.testing.assert_allclose(out[o]["o"], heat, atol=1e-4)


def test_edge_windows_clamp_to_full_coverage(ex):
    # H=7, patch=4, stride=3: origins 0, 3 -> the last window clamps to
    # start 3 (= H - patch), so the bottom/right edges are covered
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 7, 7)).astype(np.float32)
    g, o = occ_chain(x, {"target": "sum", "patch": "4", "stride": "3"})
    out = ex.run(g, taps={(o, "g")})
    drops, _ = numpy_occlusion(
        x, lambda a: np.sum(np.cos(a)), patch=4, stride=3)
    assert out[o]["g"].shape == drops.shape
    np.testing.assert_allclose(out[o]["g"], drops, atol=1e-4)


def test_batched_leaf_per_sample_maps(ex):
    # [B,C,H,W] leaf: each sample gets its own drop map. Sample 0 carries
    # all its mass in the top-left window, sample 1 in the bottom-right:
    # the per-sample argmax windows must differ accordingly.
    x = np.zeros((2, 3, 8, 8), np.float32)
    x[0, :, 0:4, 0:4] = 2.0
    x[1, :, 4:8, 4:8] = 2.0
    g = Graph()
    o = g.add_node("occlusion",
                   {"target": "sum", "patch": "4", "stride": "4"}).index
    g.add_input(x, g.nodes[o], "o")  # identity forward (leaf == wired)
    out = ex.run(g, taps={(o, "g"), (o, "o")})
    gmap = out[o]["g"]
    assert gmap.shape == (2, 2, 2)
    assert np.unravel_index(np.argmax(gmap[0]), (2, 2)) == (0, 0)
    assert np.unravel_index(np.argmax(gmap[1]), (2, 2)) == (1, 1)
    assert out[o]["o"].shape == (2, 3, 8, 8)
    # analytic: occluding the blob with 0 drops sum(x) by 16 px * 3 ch * 2
    np.testing.assert_allclose(gmap[0, 0, 0], 96.0, atol=1e-3)
    np.testing.assert_allclose(gmap[0, 1, 1], 0.0, atol=1e-3)


def test_class_target_and_dynamic_scrub_no_recompile(ex):
    # target=class on an identity forward: score = sum over rows of
    # column c. Scrubbing class and fill re-keys the cached program.
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 8)).astype(np.float32)
    g, o = occ_chain(x, {"target": "class", "class": "1", "patch": "4",
                         "stride": "4"})
    out1 = ex.run(g, taps={(o, "g")})
    assert not ex.last_stats.cache_hit

    def fwd_class(a, c, fill=0.0):
        return np.sum(np.cos(a)[..., c])

    drops1, _ = numpy_occlusion(
        x, lambda a: fwd_class(a, 1), patch=4, stride=4)
    np.testing.assert_allclose(out1[o]["g"], drops1, atol=1e-4)
    g.nodes[o].params["class"] = "6"
    g.nodes[o].params["fill"] = "0.5"
    out2 = ex.run(g, taps={(o, "g")})
    assert ex.last_stats.cache_hit  # dynamic captures, same program
    drops2, _ = numpy_occlusion(
        x, lambda a: fwd_class(a, 6), patch=4, stride=4, fill=0.5)
    np.testing.assert_allclose(out2[o]["g"], drops2, atol=1e-4)


class _TwinProbe(NodeKind):
    """Counts trace-time calls of fn vs its grad twin."""

    def __init__(self):
        super().__init__("twin_probe")
        self.fn_calls = 0
        self.twin_calls = 0

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        def f(ins):
            self.fn_calls += 1
            return {"o": ins["o"] * 2.0}

        return f

    def grad_safe_fn(self, params):
        def f(ins):
            self.twin_calls += 1
            return {"o": ins["o"] * 2.0}

        return f


def test_replay_keeps_kernel_fn_not_grad_twin(reg):
    # occlusion's replay is forward-only (differentiates=False): the
    # executor must re-trace the cone through each kind's regular fn —
    # on the GPU that keeps the attention kernels — NOT the grad twin. The
    # saliency control confirms differentiated replays still twin.
    probe = _TwinProbe()
    probe.register(reg)
    ex = Executor(reg)
    x = np.ones((3, 4, 4), np.float32)
    g = Graph()
    p = g.add_node("twin_probe", {})
    o = g.add_node("occlusion", {"target": "sum", "patch": "2"})
    g.connect(p, "o", o, "o")
    g.add_input(x, p, "o")
    ex.run(g, taps={(o.index, "g")})
    assert probe.twin_calls == 0
    assert probe.fn_calls >= 2  # main eval + >=1 replay trace

    probe2 = _TwinProbe()
    r2 = Registry()
    register_builtin(r2)
    probe2.register(r2)
    ex2 = Executor(r2)
    g2 = Graph()
    p2 = g2.add_node("twin_probe", {})
    s2 = g2.add_node("saliency", {"target": "sum"})
    g2.connect(p2, "o", s2, "o")
    g2.add_input(np.ones((4,), np.float32), p2, "o")
    ex2.run(g2, taps={(s2.index, "g")})
    assert probe2.twin_calls >= 1


def test_non_image_leaf_raises_node_error(ex):
    x = np.ones((4, 5), np.float32)  # a bare matrix — not image-shaped
    g, o = occ_chain(x, {"target": "sum"})
    with pytest.raises(NodeError) as ei:
        ex.run(g, taps={(o, "g")})
    assert "image-shaped" in str(ei.value)


def test_bad_params_attributed(ex):
    x = np.ones((3, 8, 8), np.float32)
    for bad in ({"target": "blorp"}, {"patch": "0"}, {"stride": "-1"}):
        g, o = occ_chain(x, bad)
        with pytest.raises(NodeError):
            ex.run(g, taps={(o, "g")})


def test_occlusion_through_vit_blocks(reg):
    # the real product shape: image -> embed -> blocks -> head ->
    # occlusion; the drop grid covers the image at the patch geometry
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    cfg = vit.ViTConfig("vit_occ", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=10)
    vit.VARIANTS["vit_occ"] = cfg
    try:
        make_vit_model("vit_occ").register(reg)
    finally:
        del vit.VARIANTS["vit_occ"]
    ex = Executor(reg)
    g = Graph()
    emb = g.add_node("vit_occ:embed")
    b0 = g.add_node("vit_occ:blocks.0")
    b1 = g.add_node("vit_occ:blocks.1")
    head = g.add_node("vit_occ:head")
    o = g.add_node("occlusion",
                   {"target": "max", "patch": "16", "stride": "16"}).index
    g.connect(emb, "o", b0, "o")
    g.connect(b0, "o", b1, "o")
    g.connect(b1, "o", head, "o")
    g.connect(head, "o", g.nodes[o], "o")
    img = np.random.default_rng(0).random((1, 3, 32, 32)).astype(np.float32)
    g.add_input(img, emb, "o")
    out = ex.run(g, taps={(o, "o"), (o, "g"), (head.index, "o")})
    assert out[o]["g"].shape == (1, 2, 2)  # 32/16 grid, batch-leading
    assert out[o]["o"].shape == img.shape
    assert np.isfinite(out[o]["g"]).all()
    assert out[o]["o"].max() == pytest.approx(1.0, abs=1e-4)


def test_eager_matches_staged(ex):
    x = np.linspace(-1.0, 1.0, 3 * 8 * 8,
                    dtype=np.float32).reshape(3, 8, 8)
    g, o = occ_chain(x, {"target": "sum", "patch": "4", "stride": "4"})
    outputs, errors = ex.run_eager(g)
    assert errors == {}
    staged = ex.run(g, taps={(o, "g"), (o, "o")})
    np.testing.assert_allclose(outputs[o]["g"], staged[o]["g"], atol=1e-5)
    np.testing.assert_allclose(outputs[o]["o"], staged[o]["o"], atol=1e-5)
