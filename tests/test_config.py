"""Compile-cache directory choice (utils/config.py)."""
import pytest

from wavesandeigenvalues_jl_tpu.utils import config


@pytest.mark.parametrize("env, expect", [
    ({}, config.COMPILE_CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({"WAE_COMPILE_CACHE": "0"}, None),
])
def test_compile_cache_dir(monkeypatch, env, expect):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and the package sets
    nothing; unset: one fixed directory inside the checkout."""
    for k in ("JAX_COMPILATION_CACHE_DIR", "WAE_COMPILE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert config.compile_cache_dir() == expect


def test_compile_cache_dir_is_gitignored():
    import os
    root = os.path.dirname(config.COMPILE_CACHE_DIR)
    assert os.path.exists(os.path.join(root, "chip_smoke.py"))
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(config.COMPILE_CACHE_DIR) + "/" in ignored
