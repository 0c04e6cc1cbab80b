"""Compile-cache placement (utils/compile_cache.py): the environment
variable wins; otherwise one fixed directory inside the checkout."""

import os

import pytest

from interactive_vit_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_inside_the_checkout_and_ignored():
    assert cc.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("requested,expected", [
    (None, "default"), ("", None), ("/x/y", "/x/y")])
def test_cache_dir_without_env(monkeypatch, requested, expected):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    want = cc.DEFAULT_DIR if expected == "default" else expected
    assert cc.cache_dir(requested) == want


@pytest.mark.parametrize("requested", [None, "", "/x/y"])
def test_env_var_wins(monkeypatch, requested):
    monkeypatch.setenv(cc.ENV_VAR, "/from/env")
    assert cc.cache_dir(requested) == "/from/env"


def test_enable_sets_nothing_when_env_set(monkeypatch):
    monkeypatch.setenv(cc.ENV_VAR, "/from/env")
    calls = []
    import jax

    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable() == "/from/env"
    assert calls == []


def test_enable_sets_the_default(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    calls = []
    import jax

    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable() == cc.DEFAULT_DIR
    assert ("jax_compilation_cache_dir", cc.DEFAULT_DIR) in calls


def test_enable_off(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    calls = []
    import jax

    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.enable("") is None
    assert calls == []
