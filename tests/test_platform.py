"""Platform plumbing: the compile-cache location, the CLIs' -platform
choices, and a main path that imports nothing beyond its declared
dependencies."""

import importlib
import os
import subprocess
import sys

import pytest

import jax

from ngx.utils.compile_cache import CHECKOUT, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ["dagger", "enjoy", "eval_agents", "keyboard_play", "perf",
        "record_demos", "socket_env"]
# a meta-path hook that makes the optional packages unimportable
BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import jax
jax.config.update("jax_platforms", "cpu")
"""


def _run(code, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache") == os.path.join(
        CHECKOUT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_sets_nothing(monkeypatch, tmp_path,
                                            restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_entries_land_in_env_dir(tmp_path):
    r = _run("import jax, jax.numpy as jnp\n"
             "from ngx.utils.compile_cache import enable_compile_cache\n"
             "enable_compile_cache()\n"
             "print(jax.jit(lambda x: jnp.cos(x) * 3)(jnp.ones(4)))\n",
             JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"),
             JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    assert r.returncode == 0, r.stderr
    entries = os.listdir(tmp_path / "cc")
    assert any(e.startswith("jit__lambda") for e in entries), entries


@pytest.mark.parametrize("cli", CLIS)
def test_cli_platform_choices(cli, capsys):
    main = importlib.import_module(f"ngx.cli.{cli}").main
    # argparse consumes options in order: a valid -platform reaches -h
    # (exit 0), an invalid one errors out first (exit 2)
    with pytest.raises(SystemExit) as ok:
        main(["-platform", "gpu", "-h"])
    assert ok.value.code == 0
    with pytest.raises(SystemExit) as bad:
        main(["-platform", "tpu"])
    assert bad.value.code == 2
    assert "invalid choice: 'tpu'" in capsys.readouterr().err


def test_main_path_needs_no_optional_packages():
    r = _run(BLOCK + """
import ngx, ngx.vector, ngx.rl.train, bench, chip_smoke
from ngx.rl.train import PPOConfig, make_train
cfg = PPOConfig(num_envs=16, rollout_steps=4, epochs=1, num_minibatches=2,
                hidden=(8, 8))
init, step = make_train(cfg)
carry, m = jax.jit(step)(init(jax.random.key(0)), jax.random.key(1))
assert all(bool(jax.numpy.isfinite(v)) for v in m.values()), m
loaded = sorted({k.split(".")[0] for k in sys.modules}
                & {"flax", "orbax", "matplotlib"})
print("LOADED", loaded)
""")
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_missing_extras_raise_naming_the_extra(tmp_path):
    r = _run(BLOCK + f"""
from ngx.utils.checkpoint import save_pytree
from ngx.compat.render import render_env
for fn, extra in ((lambda: save_pytree({str(tmp_path / 'x')!r}, {{}}), "ckpt"),
                  (lambda: render_env(None), "render")):
    try:
        fn()
    except ImportError as e:
        assert "[" + extra + "]" in str(e), e
        print("EXTRA", extra)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["EXTRA", "ckpt", "EXTRA", "render"], r.stdout
