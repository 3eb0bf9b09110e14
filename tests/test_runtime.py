"""Process set-up rules: compile-cache placement, no silent CPU runs."""

import os
import subprocess
import sys

import jax
import pytest

from conftest import ORACLE, REPO

from fasim_tpu import runtime


def _cache_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it; the program sets
    nothing of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _cache_updates(monkeypatch)
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the variable the cache sits at one fixed path inside the
    checkout (never temporary, per-process or per-run)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _cache_updates(monkeypatch)
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache() == os.path.join(
        REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


def _env_without_device():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_cli_exits_without_gpu(tmp_path):
    """JAX_PLATFORMS unset and no GPU: the CLI names the missing device
    and exits non-zero instead of scanning on the CPU."""
    r = subprocess.run(
        [sys.executable, "-m", "fasim_tpu.cli", "-f1",
         os.path.join(ORACLE, "testDNAt.fa"), "-f2",
         os.path.join(ORACLE, "H19t.fa"), "-O", str(tmp_path) + "/"],
        env=_env_without_device(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"]])
def test_chip_smoke_fails_without_gpu(argv):
    """chip_smoke.py (phase 0) and bench.py stop before any work on a
    machine without a GPU and print no result line."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, argv[0]), *argv[1:]],
        env=_env_without_device(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert '"ok"' not in r.stdout
