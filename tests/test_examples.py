"""Smoke tests: every runnable example must execute end to end in CI.

Examples are user-facing documentation; without coverage they rot the
moment an API they demonstrate changes. Each runs via runpy exactly as a
user would invoke it (interpret-mode kernels on CPU).
"""

import os
import runpy
import sys

import pytest

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch, tmp_path):
    """The examples turn on JAX's persistent compile cache; with the
    variable set the helper leaves JAX's config alone, so the test workers
    share no cache directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


def _run(name, argv=()):
    old_argv = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(_EXAMPLES, name), run_name="__main__")
    finally:
        sys.argv = old_argv


def test_example_train_lm(capsys):
    _run("train_lm.py")
    out = capsys.readouterr().out
    assert "step 9: loss" in out


def test_example_distill_dit(capsys):
    _run("distill_dit.py")
    out = capsys.readouterr().out
    assert "step 4: rCM loss" in out


def test_example_serve(capsys):
    _run("serve.py")
    out = capsys.readouterr().out
    assert "stats:" in out and "completed': 3" in out


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 (emulated) devices"
)
def test_example_train_lm_sharded(capsys):
    _run("train_lm.py", ["--sharded"])
    out = capsys.readouterr().out
    assert "step 9: loss" in out
