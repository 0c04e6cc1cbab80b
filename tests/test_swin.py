"""Swin: torch parity + the tappable node surface.

The torch oracle is built here layer-for-layer against the torchvision
``swin_t`` (v1) structure and STATE-DICT NAMING (torchvision itself is
not in this image), so ``swin.from_torch`` and the forward semantics
(LN-before-roll, roll direction, -100 seam mask, scale-then-dot order,
relative-position bias construction, patch-merge concat order, clamped
shift when the window covers the map) are pinned to the real checkpoint
format.

Geometry under test (tiny, fast on CPU, full behavior coverage):
stage 0 runs 8x8 maps with 4x4 windows — block 1 SHIFTS by 2 and the
seam mask is active; stage 1 runs 4x4 maps where window==map, so the
shift clamps to 0 (torchvision does the same).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax.numpy as jnp

from interactive_vit_tpu.models import swin

CFG = swin.SwinConfig(
    "swin_test", img_size=32, patch=4, embed_dim=16, depths=(2, 2),
    heads=(2, 4), window=4, mlp_ratio=2, num_classes=10)


# -- independent torch oracle (torchvision swin v1 semantics + naming) -------


def _torch_shifted_window_attention(x, attn, window, shift, heads):
    """torchvision ``shifted_window_attention`` (v1), eval mode."""
    b, h, w, c = x.shape
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nh, nw = h // window, w // window
    t = window * window
    xw = x.view(b, nh, window, nw, window, c)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, t, c)
    qkv = F.linear(xw, attn.qkv.weight, attn.qkv.bias)
    qkv = qkv.reshape(xw.size(0), t, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    scores = q.matmul(k.transpose(-2, -1))
    idx = torch.from_numpy(swin.relative_position_index(window))
    bias = attn.relative_position_bias_table[idx.reshape(-1)]
    bias = bias.reshape(t, t, heads).permute(2, 0, 1)
    scores = scores + bias.unsqueeze(0)
    if shift > 0:
        mask = torch.from_numpy(swin.shift_attn_mask(h, window, shift))
        scores = scores.view(b, nh * nw, heads, t, t) + mask[:, None]
        scores = scores.view(-1, heads, t, t)
    probs = F.softmax(scores, dim=-1)
    y = probs.matmul(v).transpose(1, 2).reshape(xw.size(0), t, c)
    y = F.linear(y, attn.proj.weight, attn.proj.bias)
    y = y.view(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, h, w, c)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y


class _Attn(nn.Module):
    def __init__(self, c, heads, window):
        super().__init__()
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads) * 0.02)


class _Block(nn.Module):
    def __init__(self, c, heads, window, shift, ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, eps=CFG.ln_eps)
        self.attn = _Attn(c, heads, window)
        self.norm2 = nn.LayerNorm(c, eps=CFG.ln_eps)
        self.mlp = nn.Sequential(
            nn.Linear(c, ratio * c), nn.GELU(), nn.Dropout(0.0),
            nn.Linear(ratio * c, c), nn.Dropout(0.0))
        self._meta = (heads, window, shift)

    def forward(self, x):
        heads, window, shift = self._meta
        x = x + _torch_shifted_window_attention(
            self.norm1(x), self.attn, window, shift, heads)
        return x + self.mlp(self.norm2(x))


class _Merge(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.reduction = nn.Linear(4 * c, 2 * c, bias=False)
        self.norm = nn.LayerNorm(4 * c, eps=CFG.ln_eps)

    def forward(self, x):
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class _Permute(nn.Module):
    def forward(self, x):
        return x.permute(0, 2, 3, 1)


class TorchSwin(nn.Module):
    """torchvision-identical structure and state-dict key names (v1)."""

    def __init__(self, cfg: swin.SwinConfig):
        super().__init__()
        seq = [nn.Sequential(
            nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch,
                      stride=cfg.patch),
            _Permute(),
            nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps))]
        for s, depth in enumerate(cfg.depths):
            c = cfg.stage_dim(s)
            seq.append(nn.Sequential(*[
                _Block(c, cfg.heads[s], cfg.window, cfg.stage_shift(s, b),
                       cfg.mlp_ratio)
                for b in range(depth)]))
            if s + 1 < len(cfg.depths):
                seq.append(_Merge(c))
        self.features = nn.Sequential(*seq)
        cf = cfg.stage_dim(len(cfg.depths) - 1)
        self.norm = nn.LayerNorm(cf, eps=cfg.ln_eps)
        self.head = nn.Linear(cf, cfg.num_classes)

    @torch.no_grad()
    def forward(self, x):
        x = self.features(x)
        x = self.norm(x)
        x = x.mean(dim=(1, 2))
        return self.head(x)


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(0)
    tm = TorchSwin(CFG)
    tm.eval()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(0).random((2, 3, 32, 32)).astype(np.float32)
    logits = tm(torch.from_numpy(x)).numpy()
    return sd, x, logits


def test_state_dict_names_match_torchvision(oracle):
    """The oracle's key naming is the torchvision layout from_torch
    expects (features.0.0 conv, features.{1,3}.b blocks, features.2
    merge, norm, head) — pin a representative set so a refactor of the
    oracle can't silently detach it from the converter."""
    sd, _, _ = oracle
    for k in [
        "features.0.0.weight", "features.0.2.weight",
        "features.1.0.attn.qkv.weight",
        "features.1.1.attn.relative_position_bias_table",
        "features.1.0.mlp.0.weight", "features.1.0.mlp.3.bias",
        "features.2.reduction.weight", "features.2.norm.weight",
        "features.3.1.norm2.bias", "norm.weight", "head.bias",
    ]:
        assert k in sd, k


def test_forward_parity_vs_torch(oracle):
    sd, x, ref = oracle
    params = swin.from_torch(sd, CFG)
    got = np.asarray(swin.forward(params, jnp.asarray(x), CFG)["logits"])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_shifted_block_differs_from_unshifted(oracle):
    """The seam mask and roll must actually change the computation: block
    (0,1) with its shift forced to 0 diverges from the shifted oracle."""
    sd, x, ref = oracle
    params = swin.from_torch(sd, CFG)
    xj = swin.patch_embed(params["patch_embed"], jnp.asarray(x), CFG)
    p = params["stages"][0][1]
    y_shift, _ = swin.block(p, xj, CFG, 0, CFG.stage_shift(0, 1))
    y_plain, _ = swin.block(p, xj, CFG, 0, 0)
    assert CFG.stage_shift(0, 1) == 2
    assert not np.allclose(np.asarray(y_shift), np.asarray(y_plain),
                           atol=1e-5)


def test_shift_clamps_when_window_covers_map():
    # stage 1 maps are 4x4 with a 4x4 window: one window, shift pointless
    assert CFG.stage_shift(1, 1) == 0


def test_node_chain_matches_forward(oracle):
    """The tappable decomposition composes to the monolithic forward
    (patch_embed through head; transform skipped — the oracle feeds raw
    tensors), and the attention tap has the window-map shape."""
    sd, x, ref = oracle
    params = swin.from_torch(sd, CFG)
    cur = {"o": jnp.asarray(x)}
    probs = None
    for name, extra, fn in swin.layer_fns(CFG):
        if name == "transform":
            continue
        p = swin.layer_params(params, name)
        if "attn" in extra:
            outs = fn(p, cur, want=frozenset({"attn"}))
            probs = outs["attn"]
        else:
            outs = fn(p, cur)
        cur = {"o": outs["o"]}
    np.testing.assert_allclose(np.asarray(cur["o"]), ref,
                               atol=1e-4, rtol=1e-4)
    # last block: stage 1 = 4x4 map, ONE 4x4 window, 4 heads, T=16
    assert probs.shape == (2, 1, 4, 16, 16)
    # each row is a softmax distribution
    np.testing.assert_allclose(np.asarray(probs).sum(-1), 1.0, atol=1e-5)


def test_served_over_executor_with_attn_tap(oracle):
    """swin registers as a model plugin and serves its chain through the
    real executor, logits matching torch and a shifted block's window
    maps tappable."""
    import tempfile

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model
    from interactive_vit_tpu.wire.schema import GraphLibrary

    sd, x, ref = oracle
    params = swin.from_torch(sd, CFG)
    reg = Registry()
    lib = GraphLibrary(tempfile.mkdtemp())
    model = make_swin_model(params=params, cfg=CFG)
    model.register(reg, lib)
    assert lib.exists("swin_test.json")

    ex = Executor(reg)
    g = Graph()
    chain = ["swin_test:patch_embed"]
    for s, depth in enumerate(CFG.depths):
        chain += [f"swin_test:stages.{s}.{b}" for b in range(depth)]
        if s + 1 < len(CFG.depths):
            chain.append(f"swin_test:merge.{s}")
    chain += ["swin_test:norm", "swin_test:pool", "swin_test:head"]
    nodes = [g.add_node(nm) for nm in chain]
    for a, b in zip(nodes, nodes[1:]):
        g.connect(a, "o", b, "o")
    g.add_input(x, nodes[0], "o")
    shifted = chain.index("swin_test:stages.0.1")
    outs = ex.run(g, taps=[(len(nodes) - 1, "o"), (shifted, "attn")])
    np.testing.assert_allclose(np.asarray(outs[len(nodes) - 1]["o"]), ref,
                               atol=1e-4, rtol=1e-4)
    # stage 0: 8x8 map, 4 windows of 4x4, 2 heads
    assert outs[shifted]["attn"].shape == (2, 4, 2, 16, 16)


def test_native_safetensors_roundtrip(oracle, tmp_path):
    from interactive_vit_tpu.models.weights import to_native_flat
    from interactive_vit_tpu.tools.convert import convert
    from interactive_vit_tpu.utils.safetensors_io import load_file, save_file

    import jax

    sd, x, ref = oracle
    params = jax.device_get(swin.from_torch(sd, CFG))
    path = str(tmp_path / "swin.safetensors")
    save_file(to_native_flat(params), path)
    back = convert("swin_t", "auto", load_file(path))
    got = np.asarray(swin.forward(back, jnp.asarray(x), CFG)["logits"])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_swin_t_full_geometry_shapes():
    """swin_t at the real 224 geometry: logits and per-stage window-map
    shapes (smoke; random weights, batch 1)."""
    import jax

    cfg = swin.VARIANTS["swin_t"]
    params = swin.init_params(jax.random.key(0), cfg)
    x = jnp.zeros((1, 3, 224, 224), jnp.float32)
    out = swin.forward(params, x, cfg, want_attn=True)
    assert out["logits"].shape == (1, 1000)
    assert len(out["attn"]) == sum(cfg.depths)
    # stage resolutions 56/28/14/7 -> window counts 64/16/4/1
    assert out["attn"][0].shape == (1, 64, 3, 49, 49)
    assert out["attn"][-1].shape == (1, 1, 24, 49, 49)


def test_variant_dispatch_knows_swin():
    from interactive_vit_tpu.models.autoregister import known_variants

    for v in ("swin_t", "swin_s", "swin_b"):
        assert v in known_variants()


def test_layer_scrub_speculation_covers_stage_siblings(oracle):
    """Swin layer names (stages.<s>.<b>) are speculative-warming
    candidates: tapping stages.0.0's attn yields exactly the within-
    stage sibling re-target (stages.0.1) — never cross-stage (different
    shapes = different user gesture) and never merge nodes."""
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model
    from interactive_vit_tpu.serving.speculate import tap_variants

    sd, x, _ = oracle
    params = swin.from_torch(sd, CFG)
    reg = Registry()
    from interactive_vit_tpu.ops.node_ops import register_builtin

    register_builtin(reg)
    model = make_swin_model(params=params, cfg=CFG)
    model.register(reg)

    g = Graph()
    nodes = {}
    prev = None
    for lname in model.list_node_names():
        n = g.add_node(lname)
        nodes[lname] = n
        if prev is not None:
            g.connect(prev, "o", n, "o")
        prev = n
    viewer = g.add_node("attn_view")
    g.connect(nodes["swin_test:stages.0.0"], "attn", viewer, "attn")
    g.add_input(x, g.nodes[0], "o")

    variants = tap_variants(g, "primary", reg)
    assert len(variants) == 1  # depths (2, 2): one within-stage sibling
    v, _ = variants[0]
    src = v.nodes[viewer.index].inputs["attn"].src.node.name
    assert src == "swin_test:stages.0.1"


def test_dense_feature_viewers_on_swin_stage(oracle):
    """pca_view / patch_sim consume swin's channels-last spatial stage
    features ([B,H,W,C] — no CLS token) through the real executor."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model
    from interactive_vit_tpu.ops.node_ops import register_builtin

    sd, x, _ = oracle
    params = swin.from_torch(sd, CFG)
    reg = Registry()
    register_builtin(reg)
    model = make_swin_model(params=params, cfg=CFG)
    model.register(reg)

    g = Graph()
    emb = g.add_node("swin_test:patch_embed")
    blk = g.add_node("swin_test:stages.0.0")
    pca = g.add_node("pca_view")
    sim = g.add_node("patch_sim", {"row": "3", "col": "5"})
    g.connect(emb, "o", blk, "o")
    g.connect(blk, "o", pca, "o")
    g.connect(blk, "o", sim, "o")
    g.add_input(x, emb, "o")

    out = Executor(reg).run(
        g, taps=[(pca.index, "o"), (sim.index, "o")])
    # stage 0 at img 32 / patch 4: 8x8 spatial map
    pv = np.asarray(out[pca.index]["o"])
    sv = np.asarray(out[sim.index]["o"])
    assert pv.shape == (2, 3, 8, 8) and sv.shape == (2, 3, 8, 8)
    assert np.isfinite(pv).all() and np.isfinite(sv).all()
    assert pv.min() >= 0.0 and pv.max() <= 1.0
    # the query patch similarity vs itself is exactly 1 -> pixel 1.0
    assert np.allclose(sv[:, 0, 3, 5], 1.0, atol=1e-5)


def test_selective_window_and_head_taps(oracle):
    """attn_win / attn_heads node params slice the window-map tap (and
    participate in the compile signature — they change shapes)."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model

    sd, x, _ = oracle
    params = swin.from_torch(sd, CFG)
    reg = Registry()
    model = make_swin_model(params=params, cfg=CFG)
    model.register(reg)
    ex = Executor(reg)

    def run_tap(node_params):
        g = Graph()
        emb = g.add_node("swin_test:patch_embed")
        blk = g.add_node("swin_test:stages.0.1", node_params)
        g.connect(emb, "o", blk, "o")
        g.add_input(x, emb, "o")
        return np.asarray(ex.run(g, taps=[(blk.index, "attn")])
                          [blk.index]["attn"])

    full = run_tap(None)                       # [B, nW, h, T, T]
    assert full.shape == (2, 4, 2, 16, 16)
    win = run_tap({"attn_win": "2"})           # [B, h, T, T]
    assert win.shape == (2, 2, 16, 16)
    np.testing.assert_allclose(win, full[:, 2], atol=1e-6)
    both = run_tap({"attn_win": "1", "attn_heads": "[1]"})
    assert both.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(both, full[:, 1, 1:2], atol=1e-6)
    with pytest.raises(Exception):
        run_tap({"attn_win": "99"})


def test_swin_exports_as_aot_artifact(oracle, tmp_path):
    """The swin chain (shifted windows + merges) survives the jax.export
    deployment artifact round-trip, window-map tap included."""
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.export import export_graph, load_artifact
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model

    sd, x, _ = oracle
    params = swin.from_torch(sd, CFG)
    reg = Registry()
    model = make_swin_model(params=params, cfg=CFG)
    model.register(reg)
    g = Graph()
    chain = ["swin_test:patch_embed", "swin_test:stages.0.0",
             "swin_test:stages.0.1", "swin_test:merge.0",
             "swin_test:stages.1.0", "swin_test:stages.1.1",
             "swin_test:norm", "swin_test:pool", "swin_test:head"]
    nodes = [g.add_node(n) for n in chain]
    for a, b in zip(nodes, nodes[1:]):
        g.connect(a, "o", b, "o")
    g.add_input(x, nodes[0], "o")
    ex = Executor(reg)
    taps = [(1, "attn"), (len(nodes) - 1, "o")]
    want = ex.run(g, taps=taps)
    out_dir = str(tmp_path / "swin_art")
    export_graph(g, out_dir, taps=taps, executor=ex)
    got = load_artifact(out_dir)(x)
    np.testing.assert_allclose(np.asarray(got[1]["attn"]),
                               np.asarray(want[1]["attn"]), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(got[len(nodes) - 1]["o"]),
        np.asarray(want[len(nodes) - 1]["o"]), atol=1e-5)


# -- W8A8 MLP path (round 4) --------------------------------------------------


def test_make_swin_model_quantize_contract():
    """quantize='w8a8' quantizes ONLY fc1/fc2 (qkv stays dense);
    quantize=True quantizes every linear. Both forwards stay within the quantization
    noise class of the dense model and grad twins exist."""
    import jax

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models.swin_plugin import make_swin_model
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.ops.quant import is_quantized, is_w8a8

    dense = make_swin_model(cfg=CFG)
    m = make_swin_model(cfg=CFG, quantize="w8a8")
    p0 = m.params["stages"][0][0]
    assert is_w8a8(p0["fc1_w"]) and is_w8a8(p0["fc2_w"])
    assert not is_quantized(p0["qkv_w"])
    mw = make_swin_model(cfg=CFG, quantize=True)
    pw = mw.params["stages"][0][0]
    assert is_quantized(pw["qkv_w"]) and is_quantized(pw["fc1_w"])
    assert m.grad_layers is not None and mw.grad_layers is not None

    img = np.random.default_rng(5).random((3, 32, 32), np.float32)

    def logits(model):
        reg = Registry()
        register_builtin(reg)
        model.register(reg)
        g = Graph()
        prev = None
        for nm in model.list_node_names():
            n = g.add_node(nm)
            if prev is not None:
                g.connect(prev, "o", n, "o")
            prev = n
        g.add_input(img, g.nodes[0], "o")
        out = Executor(reg).run(g, taps="primary")
        return np.asarray(out[prev.index]["o"], np.float32)

    ld = logits(dense)
    for model in (m, mw):
        lq = logits(model)
        assert np.argmax(lq, -1).shape == np.argmax(ld, -1).shape
        # quantization noise class: well below the logit spread
        assert np.max(np.abs(lq - ld)) < 0.15 * (np.ptp(ld) + 1e-9)


def test_autoregister_swin_quantize_routes():
    """make_model('swin_t', quantize=...) reaches the swin maker (no
    'int8 not wired' fallback) — pinned via the quantized param tree."""
    from interactive_vit_tpu.models.autoregister import make_model
    from interactive_vit_tpu.ops.quant import is_w8a8

    m = make_model("swin_t", quantize="w8a8")
    assert is_w8a8(m.params["stages"][0][0]["fc1_w"])
