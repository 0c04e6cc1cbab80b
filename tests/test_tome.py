"""ToMe token-merging tests: matching semantics, the proportional-
attention theorem, the shrinking-ladder forward, and the graph surface.

The merge math is pinned against a per-sample numpy loop
(``tome_ops.bipartite_merge_reference``); the exactness theorem — merging
IDENTICAL tokens with proportional attention reproduces the unmerged
attention output — is checked directly, because it is the property that
makes ToMe a fidelity-controlled approximation rather than a heuristic.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.ir import Graph
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.models import tome, vit
from interactive_vit_tpu.models.tome_plugin import make_tome_model
from interactive_vit_tpu.ops import tome_ops
from interactive_vit_tpu.ops.attention import attention_reference
from interactive_vit_tpu.ops.node_ops import register_builtin

CFG = tome.ToMeViTConfig("tome_test", img_size=32, patch=8, width=64,
                         depth=3, heads=4, num_classes=10, r=3)


@pytest.fixture(scope="module")
def setup():
    params = tome.init_params(jax.random.key(0), CFG)
    tome.VARIANTS["tome_test"] = CFG
    model = make_tome_model("tome_test", params=params,
                            with_categories=False)
    reg = Registry()
    register_builtin(reg)
    model.register(reg)
    return params, model, reg


# -- merge op semantics --------------------------------------------------------


def test_merge_matches_reference_loop():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 8)).astype(np.float32)
    s = rng.integers(1, 4, size=(2, 13)).astype(np.float32)
    metric = rng.standard_normal((2, 13, 6)).astype(np.float32)
    xo, so, lut = tome_ops.bipartite_merge(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(metric), r=4)
    xr, sr, lr = tome_ops.bipartite_merge_reference(x, s, metric, r=4)
    assert xo.shape == (2, 9, 8)
    np.testing.assert_array_equal(np.asarray(lut), lr)
    np.testing.assert_allclose(np.asarray(so), sr, atol=1e-5)
    np.testing.assert_allclose(np.asarray(xo), xr, atol=1e-4)


def test_merge_conserves_sizes_and_protects_cls():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((3, 17, 16)), jnp.float32)
    s = jnp.ones((3, 17), jnp.float32)
    # three consecutive rounds (sizes accumulate across rounds)
    for n_expect in (12, 7, 4):
        metric = x
        x, s, lut = tome_ops.bipartite_merge(x, s, metric, r=5)
        assert x.shape[1] == n_expect
        # every original token is represented exactly once somewhere
        np.testing.assert_allclose(np.asarray(s).sum(-1), 17.0, atol=1e-4)
        # CLS (old index 0) stays at new index 0
        np.testing.assert_array_equal(np.asarray(lut)[:, 0], 0)


def test_merge_count_clamps():
    # r larger than the mergeable half clamps; protected token survives
    assert tome_ops.merge_counts(17, 100) == 8   # na=9, protect=1
    assert tome_ops.merge_counts(2, 5) == 0      # na=1, protect=1
    assert tome_ops.merge_counts(5, 2) == 2
    x = jnp.ones((1, 2, 4))
    s = jnp.ones((1, 2))
    xo, so, lut = tome_ops.bipartite_merge(x, s, x, r=5)
    assert xo.shape == (1, 2, 4)  # nothing to merge: identity
    np.testing.assert_array_equal(np.asarray(lut), [[0, 1]])


def test_proportional_attention_equals_duplicate_keys():
    """softmax(qk + log s) v  ==  attention over s physical copies."""
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((1, 2, 3, 8)), jnp.float32)
    k1 = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
    v1 = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
    # duplicate key/value 0 three times, key/value 2 twice
    dup = [0, 0, 0, 1, 2, 2, 3]
    k2, v2 = k1[:, :, dup], v1[:, :, dup]
    out_dup, _ = attention_reference(q, jnp.asarray(k2), jnp.asarray(v2))
    bias = jnp.log(jnp.asarray([[3.0, 1.0, 2.0, 1.0]]))
    out_prop, _ = attention_reference(q, jnp.asarray(k1),
                                      jnp.asarray(v1), key_bias=bias)
    np.testing.assert_allclose(np.asarray(out_dup), np.asarray(out_prop),
                               atol=1e-5)


def test_merging_identical_tokens_is_exact():
    """The ToMe theorem: merging two IDENTICAL tokens and attending with
    proportional bias reproduces the unmerged attention exactly."""
    rng = np.random.default_rng(11)
    n, d = 9, 16
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    x[0, 7] = x[0, 2]  # a-token (idx 2, a-row 1) == b-token (idx 7, b-row 3)
    xj = jnp.asarray(x)
    s = jnp.ones((1, n), jnp.float32)
    xm, sm, lut = tome_ops.bipartite_merge(xj, s, xj, r=1)
    assert xm.shape == (1, n - 1, d)
    assert float(sm.sum()) == n
    # the merged pair collapsed into one token of size 2
    assert int(np.asarray(lut)[0, 2]) == int(np.asarray(lut)[0, 7])
    # attention outputs agree for every surviving token
    wq = jnp.asarray(rng.standard_normal((d, d)), jnp.float32)

    def heads(t):
        y = (t @ wq).reshape(t.shape[0], t.shape[1], 2, d // 2)
        return y.transpose(0, 2, 1, 3)

    out_full, _ = attention_reference(heads(xj), heads(xj), heads(xj))
    out_m, _ = attention_reference(heads(xm), heads(xm), heads(xm),
                                   key_bias=jnp.log(sm))
    # map each surviving token's full-set row to its merged-set row
    lut0 = np.asarray(lut)[0]
    full = np.asarray(out_full)[0].transpose(1, 0, 2)   # [N, H, dh]
    merged = np.asarray(out_m)[0].transpose(1, 0, 2)    # [N-1, H, dh]
    for old in range(n):
        np.testing.assert_allclose(full[old], merged[lut0[old]],
                                   atol=1e-4)


def test_merge_map_render_colors_groups():
    a = jnp.asarray([[0, 1, 2, 1, 3]], jnp.int32)  # CLS + 2x2 grid
    img = tome_ops.merge_map_render(a, skip=1)
    assert img.shape == (1, 3, 2, 2)
    arr = np.asarray(img).reshape(3, 4)
    # patches 0 and 2 share token 1 -> identical color; patch 1 differs
    np.testing.assert_allclose(arr[:, 0], arr[:, 2], atol=1e-6)
    assert float(np.abs(arr[:, 0] - arr[:, 1]).max()) > 1e-3
    assert float(arr.min()) >= 0.0 and float(arr.max()) <= 1.0


# -- model forward --------------------------------------------------------------


def test_forward_ladder_shapes_and_rollout(setup):
    params, _, _ = setup
    img = jnp.asarray(np.random.default_rng(0).random((2, 3, 32, 32)),
                      jnp.float32)
    out = tome.forward(params, img, CFG, want_attn=True)
    assert out["logits"].shape == (2, 10)
    # N ladder: 17 -> 14 -> 11 -> 8 (r=3)
    lens = [a.shape[-1] for a in out["attn"]]
    assert lens == [CFG.n_tokens(i) for i in range(CFG.depth)] == [17, 14, 11]
    assert out["attn"][0].shape == (2, CFG.heads, 17, 17)
    # rollout: surviving tokens' attribution over the ORIGINAL 17, rows
    # stay stochastic through merges (size-weighted averages of
    # stochastic rows)
    assert out["rollout"].shape == (2, CFG.n_tokens(CFG.depth), 17)
    np.testing.assert_allclose(
        np.asarray(out["rollout"]).sum(-1), 1.0, atol=1e-3)


def test_plain_vit_checkpoint_loads(setup):
    # the whole point: any same-geometry vit pytree serves accelerated
    base = vit.ViTConfig("b", img_size=32, patch=8, width=64, depth=3,
                         heads=4, num_classes=10)
    vp = vit.init_params(jax.random.key(9), base)
    img = jnp.asarray(np.random.default_rng(1).random((1, 3, 32, 32)),
                      jnp.float32)
    out = tome.forward(vp, img, CFG)
    assert out["logits"].shape == (1, 10)


def test_r_zero_matches_plain_vit(setup):
    params, _, _ = setup
    img = jnp.asarray(np.random.default_rng(2).random((1, 3, 32, 32)),
                      jnp.float32)
    cfg0 = tome.ToMeViTConfig("t0", img_size=32, patch=8, width=64,
                              depth=3, heads=4, num_classes=10, r=0)
    got = tome.forward(params, img, cfg0)["logits"]
    want = vit.forward(params, img, cfg0)["logits"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4)


# -- graph surface --------------------------------------------------------------


def test_generated_graph_wires_tome_channels(setup):
    _, model, _ = setup
    obj = model.generate_graph_json()
    schan = [(e["in_port"]["node"], e["out_port"]["node"])
             for e in obj["edges"] if e["in_port"]["channel"] == "s"]
    achan = [(e["in_port"]["node"], e["out_port"]["node"])
             for e in obj["edges"] if e["in_port"]["channel"] == "a"]
    assert len(schan) == CFG.depth - 1 and schan == achan
    # consecutive block nodes (transform, embed precede blocks)
    assert schan[0] == (2, 3)


def test_tome_taps_through_executor(setup):
    params, model, reg = setup
    img = np.random.default_rng(0).random((3, 32, 32), dtype=np.float32)
    ex = Executor(reg)
    g = Graph()
    prev, nodes = None, {}
    for ln in model.list_node_names():
        if ln.endswith(":transform"):
            continue
        n = g.add_node(ln)
        nodes[ln] = n
        if prev is not None:
            g.connect(prev, "o", n, "o")
            if (":blocks." in prev.name and ":blocks." in n.name):
                g.connect(prev, "s", n, "s")
                g.connect(prev, "a", n, "a")
        prev = n
    g.add_input(img, g.nodes[0], "o")
    last = nodes[f"{model.name}:blocks.{CFG.depth - 1}"]
    taps = {(last.index, "merge"), (last.index, "attn"),
            (last.index, "s"),
            (nodes[f"{model.name}:head"].index, "o")}
    out = ex.run(g, taps=taps)
    # merge map renders the ORIGINAL 4x4 patch grid
    assert out[last.index]["merge"].shape == (1, 3, 4, 4)
    # pre-merge maps over this block's input tokens (11 at block 2)
    assert out[last.index]["attn"].shape == (1, CFG.heads, 11, 11)
    np.testing.assert_allclose(
        np.asarray(out[last.index]["s"]).sum(-1), 17.0, atol=1e-4)
    # chain output == monolithic forward
    mono = tome.forward(params, jnp.asarray(img[None]), CFG)["logits"]
    np.testing.assert_allclose(
        np.asarray(out[nodes[f"{model.name}:head"].index]["o"]),
        np.asarray(mono), atol=1e-4)


def test_merge_tap_without_assignment_chain_errors(setup):
    _, model, reg = setup
    ex = Executor(reg)
    g = Graph()
    prev = None
    for ln in model.list_node_names():
        if ln.endswith(":transform"):
            continue
        n = g.add_node(ln)
        if prev is not None:
            g.connect(prev, "o", n, "o")  # no s/a chain
        prev = n
        if ln.endswith(":blocks.1"):
            break
    img = np.random.default_rng(0).random((3, 32, 32), dtype=np.float32)
    g.add_input(img, g.nodes[0], "o")
    from interactive_vit_tpu.graph.executor import NodeError

    with pytest.raises(NodeError, match="'a' channel"):
        ex.run(g, taps={(g.nodes[-1].index, "merge")})
