"""bench.py's comparison plan: one process, order A, B, B, A."""

import sys

import pytest

import bench


@pytest.mark.parametrize("ab,key,a,b", [
    ("attn", "attn", "reference", "auto"),
    ("dtype", "dtype_name", "int8w8a8", "bfloat16")])
def test_ab_runs_order(ab, key, a, b):
    runs = bench.ab_runs(ab, "vit_b16", "bfloat16", "auto")
    assert [r[key] for r in runs] == [a, b, b, a]
    assert all(r["variant"] == "vit_b16" for r in runs)
    other = {"attn": "dtype_name", "dtype_name": "attn"}[key]
    assert len({r[other] for r in runs}) == 1


def test_ab_needs_a_batch(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py", "--ab", "attn"])
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 2
    assert "--ab needs --batch" in capsys.readouterr().err
