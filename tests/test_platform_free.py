"""What no longer depends on the platform: the compile-cache location,
what tableImpl=auto runs, and when the native library is rebuilt."""

import os

import jax
import pytest

from kmer_counter import engine
from kmer_counter.io import native
from kmer_counter.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_var(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize(
    "impl,two", [("one", False), ("two", True), ("auto", engine.AUTO_TABLE_IMPL == "two")]
)
def test_table_impl_resolution(impl, two):
    assert engine.use_two_level(impl) is two


def test_auto_table_impl_is_a_table():
    assert engine.AUTO_TABLE_IMPL in ("one", "two")


def test_native_stale_when_missing(tmp_path):
    src = tmp_path / "kmer_io.cpp"
    src.write_text("//")
    assert native.is_stale(str(tmp_path / "libkmer_io.so"), str(src))


def test_native_stale_when_source_is_newer(tmp_path):
    lib, src = tmp_path / "libkmer_io.so", tmp_path / "kmer_io.cpp"
    lib.write_bytes(b"")
    src.write_text("//")
    os.utime(lib, (1_000_000, 1_000_000))
    os.utime(src, (2_000_000, 2_000_000))
    assert native.is_stale(str(lib), str(src))


def test_native_fresh_when_library_is_newer(tmp_path):
    lib, src = tmp_path / "libkmer_io.so", tmp_path / "kmer_io.cpp"
    lib.write_bytes(b"")
    src.write_text("//")
    os.utime(src, (1_000_000, 1_000_000))
    os.utime(lib, (2_000_000, 2_000_000))
    assert not native.is_stale(str(lib), str(src))
