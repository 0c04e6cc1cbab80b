"""chip_smoke.py's own logic, on the CPU: phase selection, the result
line, failure handling, and the request it sends (on a small model)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("four,expected", [
    (False, ["device", "serve", "parity", "kernels"]),
    (True, ["device", "four"])])
def test_phase_selection(cs, four, expected):
    assert cs.select_phases(four) == expected
    assert set(expected) <= set(cs.PHASES)


def test_kernel_cases_match_the_dispatch_table(cs):
    """The kernels phase asserts the GPU choice for each case; those
    expectations are the dispatch table's."""
    from interactive_vit_tpu.ops import dispatch

    assert {dh for (_, _, _, dh), _ in cs.KERNEL_CASES} == {64, 80}
    for (_, _, _, dh), expect in cs.KERNEL_CASES:
        for want, impl in expect.items():
            assert dispatch.choose_attention(
                "bfloat16", want, dh, "gpu") == impl


def test_result_line_format(cs):
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_failing_phase_stops_the_run(cs):
    ran, logs = [], []

    def ok(state):
        ran.append("a")

    def bad(state):
        cs.check(False, "boom")

    def never(state):
        ran.append("c")

    assert cs.run_phases([("a", ok), ("b", bad), ("c", never)], {},
                         log=logs.append) is False
    assert ran == ["a"]
    assert any("phase b: FAILED" in ln for ln in logs)
    assert any("boom" in ln for ln in logs)
    assert cs.run_phases([("a", ok)], {}, log=logs.append) is True


def test_no_accelerator_exits_nonzero_without_result(cs, capsys,
                                                      monkeypatch):
    """On the CPU the device phase fails: exit code 1, no JSON line."""
    import tempfile

    from interactive_vit_tpu.utils import compile_cache

    monkeypatch.setattr(cs, "_graphs_copy", tempfile.mkdtemp)
    monkeypatch.setattr(compile_cache, "enable", lambda *a: None)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "phase device: FAILED" in out
    assert '"ok": true' not in out


def test_script_alone_refuses(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_maps_request_roundtrip_on_a_small_model(cs, monkeypatch):
    """The wire request the serve phase sends: logits, every block's maps
    and the chained rollout, checked by the phase's own checker."""
    import jax

    from interactive_vit_tpu.graph.executor import Executor
    from interactive_vit_tpu.graph.registry import Registry
    from interactive_vit_tpu.models import vit
    from interactive_vit_tpu.models.vit_plugin import make_vit_model
    from interactive_vit_tpu.ops.node_ops import register_builtin
    from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm
    from interactive_vit_tpu.wire.codec import Request, Response

    cfg = vit.ViTConfig("vit_smk", img_size=32, patch=16, width=32,
                        depth=3, heads=2, num_classes=5)
    monkeypatch.setitem(vit.VARIANTS, "vit_smk", cfg)
    monkeypatch.setattr(cs, "VARIANT", "vit_smk")
    reg = Registry()
    register_builtin(reg)
    make_vit_model("vit_smk", with_categories=False).register(reg)
    img = np.random.default_rng(0).random((3, 32, 32), np.float32)
    req = Request()
    req.decode(cs.maps_request(img))
    assert len(req.taps) == 1 + cfg.depth + 1
    out = Executor(reg).run(req.graph, taps=req.taps)
    taps = cs.split_maps_response(Response.decode(Response(out).encode()))
    cs.check_maps_taps(*taps)
    logits, maps, rollout = taps
    x = preprocess_mm(img[None], 32)
    ref = vit.forward(vit.init_params(jax.random.key(0), cfg), x, cfg,
                      want_attn=True)
    err = cs.tap_errors(taps, (np.asarray(ref["logits"]),
                               [np.asarray(a) for a in ref["attn"]],
                               np.asarray(ref["rollout"])))
    assert err["logits"] < cs.F32_TOL and err["maps"] < cs.F32_TOL
    assert err["rollout"] < cs.F32_TOL


_FOUR_ON_CPU = """
import importlib.util, os, shutil, sys
repo = sys.argv[1]
sys.path.insert(0, repo)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(repo, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from interactive_vit_tpu.models import vit
vit.VARIANTS["vit_smk4"] = vit.ViTConfig(
    "vit_smk4", img_size=32, patch=16, width=64, depth=2, heads=4,
    num_classes=5)
cs.VARIANT = "vit_smk4"
state = {"graphs": cs._graphs_copy()}
try:
    ok = cs.run_phases([("four", cs.phase_four)], state)
finally:
    shutil.rmtree(state["graphs"], ignore_errors=True)
sys.exit(0 if ok else 1)
"""


def test_four_phase_on_four_virtual_devices():
    """The --four phase's mesh, requests and comparisons on four virtual
    CPU devices at a small width (the card run compiles the same path at
    vit_b16's)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _FOUR_ON_CPU, REPO],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "phase four: ok" in r.stdout
    assert r.stdout.count("mesh f32 vs f32 reference") == 2
    assert r.stdout.count("mesh bf16 vs one device bf16") == 4


def test_map_checker_catches_bad_rows(cs, monkeypatch):
    from interactive_vit_tpu.models import vit

    cfg = vit.ViTConfig("vit_smk2", img_size=32, patch=16, width=32,
                        depth=1, heads=2, num_classes=5)
    monkeypatch.setitem(vit.VARIANTS, "vit_smk2", cfg)
    monkeypatch.setattr(cs, "VARIANT", "vit_smk2")
    n = cfg.tokens
    good = np.full((1, 2, n, n), 1.0 / n, np.float32)
    cs.check_maps_taps(np.zeros((1, 5), np.float32), [good],
                       np.eye(n, dtype=np.float32)[None])
    with pytest.raises(cs.PhaseError, match="rows sum"):
        cs.check_maps_taps(np.zeros((1, 5), np.float32), [good * 2],
                           np.eye(n, dtype=np.float32)[None])
    with pytest.raises(cs.PhaseError, match="x: logits"):
        cs.check_bf16({"logits": 1.0, "logits_scale": 1.0, "maps": 0.0,
                       "rollout": 0.0, "rollout_scale": 1.0}, "x")
