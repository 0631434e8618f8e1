"""Process-level plumbing: the persistent compile cache's directory, card
pinning for one-process-per-card runs, atomic native builds, and the
host-only model-builder pool."""

import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_cache(monkeypatch):
    """Run enable_compilation_cache as if first called in this process,
    and restore JAX's cache settings afterwards."""
    import jax
    from advntr_tpu import runtime
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.setattr(runtime, "_initialized", False)
    yield runtime
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compilation_cache_honours_env(fresh_cache, monkeypatch, tmp_path):
    import jax
    cache = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache)
    assert fresh_cache.compilation_cache_dir() == cache
    fresh_cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == cache
    assert os.path.isdir(cache)


def test_compilation_cache_default_inside_checkout(fresh_cache,
                                                   monkeypatch):
    import jax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    default = os.path.join(REPO_ROOT, ".jax_cache")
    assert fresh_cache.DEFAULT_CACHE_DIR == default
    assert fresh_cache.compilation_cache_dir() == default
    fresh_cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == default
    with open(os.path.join(REPO_ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("visible,index,card", [(None, 2, "2"),
                                                ("4,5,6,7", 1, "5"),
                                                ("3", 0, "3")])
def test_pin_to_card(monkeypatch, visible, index, card):
    from jax._src import xla_bridge
    from advntr_tpu.parallel.distributed import pin_to_card
    monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                        lambda: False)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert pin_to_card(index) == card
    assert os.environ["CUDA_VISIBLE_DEVICES"] == card


def test_pin_to_card_refuses(monkeypatch):
    from jax._src import xla_bridge
    from advntr_tpu.parallel.distributed import pin_to_card
    monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                        lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    with pytest.raises(ValueError, match="not among the visible cards"):
        pin_to_card(2)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before JAX's backend"):
        pin_to_card(0)


def test_native_build_publishes_atomically(monkeypatch, tmp_path):
    """The compiler writes a per-process temporary file that os.replace
    publishes; an up-to-date library is not rebuilt."""
    from advntr_tpu import native_bridge as nb
    src = tmp_path / "k.cc"
    src.write_text("int f() { return 1; }\n")
    so = str(tmp_path / "build" / "libk.so")
    monkeypatch.setattr(nb, "_BUILD_DIR", str(tmp_path / "build"))
    seen = []

    def fake_compiler(cmd):
        out = cmd[cmd.index("-o") + 1]
        seen.append(out)
        assert out != so and not os.path.exists(so)
        with open(out, "w") as fh:
            fh.write("lib")

    monkeypatch.setattr(nb.subprocess, "check_call", fake_compiler)
    nb._build(str(src), so)
    assert seen == [f"{so}.tmp.{os.getpid()}"]
    assert open(so).read() == "lib"
    assert os.listdir(tmp_path / "build") == ["libk.so"]
    nb._build(str(src), so)
    assert len(seen) == 1


def test_host_process_pool_hides_accelerators():
    from advntr_tpu.engine.finder import host_process_pool
    with host_process_pool(1) as pool:
        env = pool.submit(os.getenv, "JAX_PLATFORMS").result(timeout=120)
        cards = pool.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result(
            timeout=120)
    assert (env, cards) == ("cpu", "")
