"""Training step: loss decreases on a fixed batch; DP x TP sharded."""

import os

import numpy as np

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.parallel import mesh as mesh_lib
from interactive_vit_tpu.parallel import train as train_lib

CFG = vit.ViTConfig("vit_train", img_size=32, patch=16, width=64,
                    depth=2, heads=4, num_classes=8)


def test_loss_decreases_sharded():
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    with mesh:
        params, opt_state, step, infer = train_lib.setup_sharded(
            CFG, mesh, seed=0, lr=1e-3
        )
        rng = np.random.default_rng(0)
        images = jnp.asarray(rng.random((8, 3, 32, 32), dtype=np.float32))
        labels = jnp.asarray(rng.integers(0, 8, size=(8,)))

        losses = []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state, images, labels)
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses
        assert all(np.isfinite(losses))


def test_train_step_remat_matches_no_remat():
    import optax

    params = vit.init_params(jax.random.key(1), CFG)
    opt = optax.sgd(1e-2)
    rng = np.random.default_rng(1)
    images = jnp.asarray(rng.random((4, 3, 32, 32), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, 8, size=(4,)))

    s1 = train_lib.make_train_step(CFG, opt, remat=True)
    s2 = train_lib.make_train_step(CFG, opt, remat=False)
    p1, _, l1 = s1(params, opt.init(params), images, labels)
    p2, _, l2 = s2(params, opt.init(params), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_config_from_env(monkeypatch):
    from interactive_vit_tpu.config import Config

    monkeypatch.setenv("IVT_MAX_BATCH", "16")
    monkeypatch.setenv("IVT_DEBUG_NANS", "true")
    monkeypatch.setenv("IVT_ATTN_IMPL", "reference")
    cfg = Config.from_env()
    assert cfg.max_batch == 16
    assert cfg.debug_nans is True
    assert cfg.attn_impl == "reference"
    assert cfg.port == 8000  # default survives


def test_plugin_dir_discovery():
    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.ir import Graph
    from interactive_vit_tpu.graph.registry import Registry, scan_plugins

    reg = Registry()
    scan_plugins([os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "nodes")], reg)
    assert "scale" in reg
    ex = Executor(reg)
    g = Graph()
    n = g.add_node("scale", {"s": "2.0", "t": "1.0"})
    x = np.linspace(0, 1, 8, dtype=np.float32)
    g.add_input(x, n, "o")
    out = ex.run(g)
    np.testing.assert_allclose(out[0]["o"], 2.0 * x + 1.0, rtol=1e-6)


def test_train_cli_checkpoint_and_resume(tmp_path):
    """The full driver loop: schedule+clip optimizer, periodic train-state
    checkpoints, and --resume continuing from the saved step."""
    from interactive_vit_tpu.tools import train as cli

    vit.VARIANTS["vit_train"] = CFG
    try:
        out = str(tmp_path / "ckpt")
        cli.main(["--variant", "vit_train", "--steps", "4", "--batch", "8",
                  "--mesh", "data=4,model=2", "--warmup", "2",
                  "--clip-norm", "1.0", "--save-every", "2",
                  "--eval-every", "2", "--output", out, "--log-every", "1"])
        import os
        assert os.path.exists(os.path.join(out, "state"))
        assert os.path.exists(os.path.join(out, "params"))

        # resume restores (params, opt_state, step) and continues; the
        # optimizer flags must match the original run (they define the
        # opt_state structure)
        cli.main(["--variant", "vit_train", "--steps", "6", "--batch", "8",
                  "--mesh", "data=4,model=2", "--warmup", "2",
                  "--clip-norm", "1.0", "--save-every", "2",
                  "--output", out, "--resume", "--log-every", "1"])
        mesh2, params_like, opt_like = _fresh_state()
        params2, _, step2 = cli.load_state(
            os.path.join(out, "state"), mesh2, params_like, opt_like)
        assert step2 == 6
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(params2))
    finally:
        del vit.VARIANTS["vit_train"]


def _fresh_state():
    # optimizer config must match the run that WROTE the state (it
    # defines the opt_state pytree structure orbax restores into)
    opt = train_lib.make_optimizer(3e-4, warmup_steps=2, total_steps=6,
                                   clip_norm=1.0)
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    with mesh:
        params, opt_state, _, _ = train_lib.setup_sharded(
            CFG, mesh, optimizer=opt)
    return mesh, params, opt_state


def test_swin_trains_sharded_with_remat():
    """The swin family trains through the same sharded step (DP mesh;
    remat via swin.forward's block_wrapper), and the remat step matches
    the no-remat step exactly."""
    import optax

    from interactive_vit_tpu.models import swin

    scfg = swin.SwinConfig("swin_train", img_size=32, patch=4,
                           embed_dim=16, depths=(2, 2), heads=(2, 4),
                           window=4, mlp_ratio=2, num_classes=8)
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.random((8, 3, 32, 32), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, 8, size=(8,)))
    with mesh:
        params, opt_state, step, infer = train_lib.setup_sharded(
            scfg, mesh, seed=0, lr=1e-3
        )
        losses = []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state, images,
                                           labels)
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses
        assert all(np.isfinite(losses))
        assert np.asarray(infer(params, images)).shape == (8, 8)

    sp = swin.init_params(jax.random.key(1), scfg)
    opt = optax.sgd(1e-2)
    s1 = train_lib.make_train_step(scfg, opt, remat=True)
    s2 = train_lib.make_train_step(scfg, opt, remat=False)
    p1, _, l1 = s1(sp, opt.init(sp), images, labels)
    p2, _, l2 = s2(sp, opt.init(sp), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=k equals the full-batch step (loss-mean linearity)."""
    import optax

    params = vit.init_params(jax.random.key(2), CFG)
    opt = optax.sgd(1e-2)
    rng = np.random.default_rng(3)
    images = jnp.asarray(rng.random((8, 3, 32, 32), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, 8, size=(8,)))

    s_full = train_lib.make_train_step(CFG, opt, remat=False)
    s_acc = train_lib.make_train_step(CFG, opt, remat=False, accum_steps=4)
    p1, _, l1 = s_full(params, opt.init(params), images, labels)
    p2, _, l2 = s_acc(params, opt.init(params), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_grad_accumulation_sharded_and_jitted():
    mesh = mesh_lib.make_mesh({"data": 2}, jax.devices()[:2])
    with mesh:
        params, opt_state, step, _ = train_lib.setup_sharded(
            CFG, mesh, seed=0, lr=1e-3, accum_steps=2)
        rng = np.random.default_rng(4)
        images = jnp.asarray(rng.random((8, 3, 32, 32), dtype=np.float32))
        labels = jnp.asarray(rng.integers(0, 8, size=(8,)))
        losses = []
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, images,
                                           labels)
            losses.append(float(loss))
        assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_remat_dots_policy_matches():
    import optax

    params = vit.init_params(jax.random.key(5), CFG)
    opt = optax.sgd(1e-2)
    rng = np.random.default_rng(6)
    images = jnp.asarray(rng.random((4, 3, 32, 32), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, 8, size=(4,)))
    s_ref = train_lib.make_train_step(CFG, opt, remat=False)
    s_dots = train_lib.make_train_step(CFG, opt, remat="dots")
    p1, _, l1 = s_ref(params, opt.init(params), images, labels)
    p2, _, l2 = s_dots(params, opt.init(params), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_distilled_remat_matches_no_remat():
    """Regression: the block_wrapper fast path sliced x[:, :1] — on a
    distilled (2-prefix-token) model that silently computed head_dist on
    the CLS token (jnp clamps the out-of-range x[:, 1] read), so remat
    training produced wrong logits AND wrong gradients with no error."""
    import optax

    cfg = vit.ViTConfig("deit_train", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=8, distilled=True)
    params = vit.init_params(jax.random.key(7), cfg)
    opt = optax.sgd(1e-2)
    rng = np.random.default_rng(8)
    images = jnp.asarray(rng.random((4, 3, 32, 32), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, 8, size=(4,)))
    s_ref = train_lib.make_train_step(cfg, opt, remat=False)
    s_rem = train_lib.make_train_step(cfg, opt, remat=True)
    p1, _, l1 = s_ref(params, opt.init(params), images, labels)
    p2, _, l2 = s_rem(params, opt.init(params), images, labels)
    np.testing.assert_allclose(float(l1), float(l2), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_resume_layout_marker(tmp_path):
    """Train-state checkpoints record the qkv column layout; resume with
    flags that resolve to the other layout is a hard error, not a silent
    load of permuted columns (the layout follows --mesh/--attn/--dtype)."""
    import optax
    import pytest

    from interactive_vit_tpu.tools import train as cli

    mesh = mesh_lib.make_mesh({"data": 2}, jax.devices()[:2])
    with mesh:
        opt = optax.sgd(1e-2)
        params, opt_state, _, _ = train_lib.setup_sharded(
            CFG, mesh, optimizer=opt)
        path = str(tmp_path / "state")
        cli.save_state(path, params, opt_state, 3, head_major=True)
        with pytest.raises(ValueError, match="layout mismatch"):
            cli.load_state(path, mesh, params, opt_state,
                           expect_head_major=False)
        p2, _, step = cli.load_state(path, mesh, params, opt_state,
                                     expect_head_major=True)
        assert step == 3

        # legacy checkpoint (no marker): loads, validation skipped
        from interactive_vit_tpu.utils.checkpoint import save_params
        legacy = str(tmp_path / "legacy")
        save_params(legacy, {"params": params, "opt_state": opt_state,
                             "step": jnp.asarray(5)})
        _, _, step = cli.load_state(legacy, mesh, params, opt_state,
                                    expect_head_major=True)
        assert step == 5


def test_swin_train_attn_dispatch_is_none():
    """swin trains windowed attention through XLA autodiff: the train
    step needs no attention implementation, and the attention policies
    that remain name no training kernel ("flash_vjp" is gone)."""
    import pytest

    from interactive_vit_tpu.models import swin
    from interactive_vit_tpu.ops.dispatch import default_attn_impl

    cfg = swin.VARIANTS["swin_t"]
    assert not train_lib.wants_head_major(
        cfg, mesh_lib.make_mesh({"data": 1, "model": 2}, jax.devices()[:2]))
    with pytest.raises(ValueError, match="unknown attention policy"):
        default_attn_impl("flash_vjp")


def test_ema_update_math_and_int_leaves():
    from interactive_vit_tpu.tools.train import make_ema_update

    fn = make_ema_update(0.5)
    e0 = {"w": jnp.asarray([2.0, 4.0]), "n": jnp.asarray([3], jnp.int32)}
    p1 = {"w": jnp.asarray([0.0, 0.0]), "n": jnp.asarray([7], jnp.int32)}
    e1 = fn(e0, p1)
    np.testing.assert_allclose(np.asarray(e1["w"]), [1.0, 2.0])
    # int leaves (step counters, quant scales) take the current value
    assert int(e1["n"][0]) == 7
    e2 = fn(e1, {"w": jnp.asarray([4.0, 4.0]), "n": p1["n"]})
    np.testing.assert_allclose(np.asarray(e2["w"]), [2.5, 3.0])


def test_train_cli_ema_checkpoint_resume(tmp_path):
    """--ema-decay: the averaged weights are evaluated/exported, ride the
    train state, survive --resume, and a PRE-EMA checkpoint resumed with
    EMA enabled re-seeds the average instead of failing."""
    import os

    from interactive_vit_tpu.tools import train as cli
    from interactive_vit_tpu.utils.checkpoint import load_params

    vit.VARIANTS["vit_train"] = CFG
    try:
        out = str(tmp_path / "ckpt")
        cli.main(["--variant", "vit_train", "--steps", "4", "--batch", "8",
                  "--ema-decay", "0.5", "--save-every", "2",
                  "--eval-every", "2", "--output", out,
                  "--log-every", "1"])
        # the state tree carries the ema subtree
        mesh2, params_like, opt_like = _fresh_state_plain()
        p2, _, step2, ema2 = cli.load_state(
            os.path.join(out, "state"), mesh2, params_like, opt_like,
            want_ema=True)
        assert step2 == 4 and ema2 is not None
        # EMA != raw params after a few steps (decay 0.5 lags training)
        diff = sum(float(jnp.abs(a - b).sum()) for a, b in zip(
            jax.tree.leaves(ema2), jax.tree.leaves(p2)))
        assert diff > 0
        # exported params == the (unpermuted) EMA weights, not raw
        exported = load_params(os.path.join(out, "params"))
        np.testing.assert_allclose(
            np.asarray(exported["cls_token"]),
            np.asarray(ema2["cls_token"]), atol=1e-6)

        # resume continues with the saved average
        cli.main(["--variant", "vit_train", "--steps", "6", "--batch", "8",
                  "--ema-decay", "0.5", "--save-every", "2",
                  "--output", out, "--resume", "--log-every", "1"])

        # the EMA accumulates in f32 even when training is bf16
        # (bf16(0.9999) == 1.0: a bf16 average would never move)
        _, _, _, ema_f = cli.load_state(
            os.path.join(out, "state"), mesh2, params_like, opt_like,
            want_ema=True)
        assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(ema_f))

        # an EMA-bearing state resumes cleanly WITHOUT the flag too
        # (the average is simply ignored; review finding)
        cli.main(["--variant", "vit_train", "--steps", "8", "--batch", "8",
                  "--save-every", "2", "--output", out, "--resume",
                  "--log-every", "1"])

        # a pre-EMA state resumed WITH --ema-decay re-seeds from params
        out2 = str(tmp_path / "ckpt2")
        cli.main(["--variant", "vit_train", "--steps", "2", "--batch", "8",
                  "--save-every", "2", "--output", out2,
                  "--log-every", "1"])
        cli.main(["--variant", "vit_train", "--steps", "4", "--batch", "8",
                  "--ema-decay", "0.5", "--save-every", "2",
                  "--output", out2, "--resume", "--log-every", "1"])
    finally:
        del vit.VARIANTS["vit_train"]


def _fresh_state_plain():
    mesh = mesh_lib.make_mesh(None, jax.devices()[:1])
    with mesh:
        params, opt_state, _, _ = train_lib.setup_sharded(CFG, mesh)
    return mesh, params, opt_state


def test_convnext_trains_sharded_with_remat():
    """ConvNeXt through the full sharded train step (DP mesh, per-CNBlock
    remat, rank-4 conv kernels in the decay set, plain-forward infer)."""
    from interactive_vit_tpu.models import convnext

    cfg = convnext.ConvNeXtConfig("cnx_train", depths=(1, 1), dims=(8, 16),
                                  num_classes=8, img_size=32, resize_to=34)
    mesh = mesh_lib.make_mesh({"data": 4, "model": 1}, jax.devices()[:4])
    with mesh:
        params, opt_state, step_fn, infer_fn = train_lib.setup_sharded(
            cfg, mesh, lr=1e-2, remat=True)
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 8, size=(8,))
        images = jnp.asarray(
            rng.normal(size=(8, 3, 32, 32)).astype(np.float32) * 0.3
            + (labels[:, None, None, None] / 8).astype(np.float32))
        labels = jnp.asarray(labels)
        losses = []
        for _ in range(5):
            params, opt_state, loss = step_fn(params, opt_state, images,
                                              labels)
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        logits = infer_fn(params, jnp.asarray(images))
        assert logits.shape == (8, 8)
    # conv kernels (rank 4) ARE decayed; LN/gamma/bias are not
    mask = train_lib._decay_mask(params)
    assert bool(mask["stem"]["w"]) and bool(mask["stages"][0][0]["dw_w"])
    assert not mask["stages"][0][0]["gamma"] and not mask["stem"]["ln"]["g"]
    assert bool(mask["stages"][0][0]["fc1"]["w"])


def test_merge_pretrained_trunk_fresh_head():
    """SSL finetune init (--init): a headless MAE-style encoder export
    loads the trunk (head-major-repacked for the TP layout), the fresh
    classifier head survives, and a wrong-depth checkpoint raises."""
    import dataclasses

    import pytest

    from interactive_vit_tpu.models.weights import (
        from_native_flat, to_native_flat,
    )

    feat_cfg = dataclasses.replace(CFG, num_classes=0)
    src = vit.init_params(jax.random.key(3), feat_cfg)
    # export -> reload round trip, exactly what --init reads
    tree = from_native_flat(to_native_flat(src))
    tree.setdefault("head", {})
    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    with mesh:
        params, _, _, _ = train_lib.setup_sharded(CFG, mesh, seed=0)
        head_major = train_lib.wants_head_major(CFG, mesh)
        assert head_major  # TP mesh -> head-major qkv columns
        merged, loaded, skipped = train_lib_merge(
            params, tree, CFG, head_major)
    assert "blocks" in loaded and "head" in skipped
    # trunk equals the checkpoint modulo the head-major permute
    back = mesh_lib.unpermute_qkv_head_major(
        {"blocks": merged["blocks"]}, CFG.heads)
    for a, b in zip(jax.tree.leaves(back["blocks"]),
                    jax.tree.leaves(src["blocks"])):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(merged["pos_emb"]),
                                  np.asarray(src["pos_emb"]))
    # the head stayed the fresh init
    np.testing.assert_array_equal(np.asarray(merged["head"]["w"]),
                                  np.asarray(params["head"]["w"]))
    # merged params must be consumable by the sharded step
    with mesh:
        opt = train_lib.make_optimizer(1e-3)
        _, opt_state, step_fn, _ = train_lib.setup_sharded(
            CFG, mesh, optimizer=opt)
        rng = np.random.default_rng(0)
        images = jnp.asarray(rng.random((8, 3, 32, 32), dtype=np.float32))
        labels = jnp.asarray(rng.integers(0, 8, size=(8,)))
        _, _, loss = step_fn(merged, opt.init(merged), images, labels)
        assert np.isfinite(float(loss))

    # wrong trunk depth -> clear error
    import dataclasses as dc
    shallow = vit.init_params(
        jax.random.key(4), dc.replace(feat_cfg, depth=1))
    bad = from_native_flat(to_native_flat(shallow))
    with mesh:
        with pytest.raises(ValueError, match="trunk failed to load"):
            train_lib_merge(params, bad, CFG, head_major)


def train_lib_merge(params, tree, cfg, head_major):
    from interactive_vit_tpu.tools.train import merge_pretrained

    return merge_pretrained(params, tree, cfg, head_major)


def test_pretrain_then_finetune_cli(tmp_path):
    """The full SSL story end-to-end at toy scale: ivt-pretrain writes a
    plain-ViT encoder export, ivt-train --init consumes it."""
    from interactive_vit_tpu.models import mae
    from interactive_vit_tpu.tools import pretrain as pretrain_cli
    from interactive_vit_tpu.tools import train as train_cli

    vit.VARIANTS["vit_train"] = CFG
    mae.VARIANTS["mae_train"] = mae.MAEConfig(
        "mae_train", "vit_train", dec_width=32, dec_depth=1, dec_heads=2)
    try:
        enc = str(tmp_path / "enc.safetensors")
        pretrain_cli.main([
            "--variant", "mae_train", "--steps", "2", "--batch", "8",
            "--memorize", "8", "--distinct-classes", "4",
            "--export-encoder", enc, "--log-every", "1"])
        import os
        assert os.path.exists(enc)
        train_cli.main([
            "--variant", "vit_train", "--steps", "2", "--batch", "8",
            "--init", enc, "--memorize", "8", "--distinct-classes", "4",
            "--log-every", "1"])
    finally:
        del vit.VARIANTS["vit_train"]
        del mae.VARIANTS["mae_train"]


def test_auto_remat_against_an_explicit_memory_limit():
    """Remat turns OFF when the no-remat working set fits the device's
    memory and ON when it does not; the limit is passed explicitly."""
    cfg = vit.VARIANTS["vit_b16"]
    assert train_lib.auto_remat(cfg, 8, hbm_bytes=80 << 30) is False
    assert train_lib.auto_remat(cfg, 4096, hbm_bytes=80 << 30) is True
    assert train_lib.auto_remat(cfg, 8, hbm_bytes=1 << 30) is True


def test_auto_remat_unknown_limit_keeps_remat_on(monkeypatch):
    cfg = vit.VARIANTS["vit_b16"]
    monkeypatch.setattr(train_lib, "device_memory_bytes", lambda: None)
    assert train_lib.auto_remat(cfg, 8) is True
    monkeypatch.setattr(train_lib, "device_memory_bytes",
                        lambda: 80 << 30)
    assert train_lib.auto_remat(cfg, 8) is False


def test_device_memory_bytes_reads_memory_stats():
    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            if isinstance(self.stats, Exception):
                raise self.stats
            return self.stats

    assert train_lib.device_memory_bytes(
        Dev({"bytes_limit": 123})) == 123
    assert train_lib.device_memory_bytes(Dev(None)) is None
    assert train_lib.device_memory_bytes(Dev({})) is None
    assert train_lib.device_memory_bytes(
        Dev(RuntimeError("no stats"))) is None
