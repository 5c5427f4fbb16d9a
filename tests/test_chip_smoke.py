"""chip_smoke.py off the card: its comparison helpers, and its refusal to
report a result without a GPU or without the rest of the checkout."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke as cs
import ngx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compare_exact_reports_first_mismatch():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert cs.compare_exact("x", a, a.copy()) == 12
    b = a.copy()
    b[2, 1] = 99
    with pytest.raises(cs.SmokeFailure, match=r"1 of 12 .* at \(2, 1\)"):
        cs.compare_exact("x", a, b)
    with pytest.raises(cs.SmokeFailure, match="dtype"):
        cs.compare_exact("x", a, a.astype(np.int64))


def test_compare_close_is_allclose_without_nans():
    b = np.array([1.0, -2.0, 0.0], np.float32)
    a = b * (1 + 5e-7)
    abs_dev, rel_dev = cs.compare_close("y", a, b, rtol=1e-6)
    assert 0 < rel_dev <= 1e-6 and abs_dev > 0
    with pytest.raises(cs.SmokeFailure, match="outside rtol"):
        cs.compare_close("y", b * (1 + 1e-4), b, rtol=1e-6)
    # an absolute floor admits deviations around zero
    cs.compare_close("y", b + 1e-7, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.compare_close("y", np.array([np.nan]), np.array([np.nan]), 1.0)


def test_compare_state_and_trees():
    spec = ngx.make_spec(cs.ENV_ID)
    st, _ = jax.vmap(ngx.make_reset(spec))(
        jax.random.split(jax.random.key(0), 4))
    st = jax.device_get(st)
    assert cs.compare_state("s", st, st) > 0
    agent = st.agent.copy()
    agent[1, 0] += 1
    moved = st.replace(agent=agent)
    with pytest.raises(cs.SmokeFailure, match=r"s\.agent"):
        cs.compare_state("s", moved, st)
    tree = {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}
    assert cs.compare_trees("p", tree, tree, 1e-4, 1e-6) == (0.0, 0.0)
    off = {"w": tree["w"] * 1.01, "b": tree["b"]}
    with pytest.raises(cs.SmokeFailure, match=r"p\['w'\]"):
        cs.compare_trees("p", off, tree, 1e-4, 1e-6)


def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a CUDA GPU" in r.stderr


def test_refuses_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
