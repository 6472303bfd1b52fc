"""Process set-up helpers: the compile-cache location and the device."""

import jax
import pytest

from lvt_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    got = runtime.enable_compile_cache()
    assert got == str(runtime.DEFAULT_CACHE_DIR)
    assert (runtime.DEFAULT_CACHE_DIR.parent / "lvt_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == got


def test_cache_variable_is_left_to_jax(monkeypatch, tmp_path,
                                       restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_the_cpu():
    assert runtime.device_summary()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()
