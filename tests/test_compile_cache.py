"""Placement of the persistent XLA compilation cache: the environment
variable wins and nothing is set in code; otherwise one fixed directory
inside the checkout."""

from pathlib import Path

import jax

from asr_jax.runtime import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
    assert calls == []


def test_default_is_fixed_path_in_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parents[1]
    want = repo / ".jax_cache"
    assert compile_cache.DEFAULT_DIR == want
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache() == str(want)
    assert calls == [("jax_compilation_cache_dir", str(want))] * 2
    assert want.is_dir()
    assert ".jax_cache" in (repo / ".gitignore").read_text().split()
