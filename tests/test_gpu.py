"""Card-only checks, run with ``NGX_TEST_GPU=1 python -m pytest tests/ -m
gpu`` on a GPU machine (they skip elsewhere): small-batch forms of
chip_smoke.py's env and update comparisons against the CPU device."""

import numpy as np
import pytest

import jax

import chip_smoke as cs
import ngx
from ngx.transforms import lidar_in_front
from ngx.vector import make_vec

pytestmark = pytest.mark.gpu


def test_env_rollout_gpu_bit_identical_to_cpu(gpu):
    vec = make_vec(lidar_in_front(ngx.make_spec(cs.ENV_ID)))

    def rollout(keys, k):
        state, _ = vec.reset(keys)
        return vec.rollout(state, k, None, 32)

    keys = jax.random.split(jax.random.key(0), 512)
    cpu = jax.devices("cpu")[0]
    (gs, gt), _, _ = cs.compiled_run(gpu, rollout, keys, jax.random.key(1))
    (cs_, ct), _, _ = cs.compiled_run(cpu, rollout, keys, jax.random.key(1))
    cs.compare_state("state", gs, cs_)
    cs.compare_exact("actions", gt.actions, ct.actions)
    cs.compare_exact("dones", gt.dones, ct.dones)
    cs.compare_close("obs", gt.obs, ct.obs, cs.ENV_RTOL)


def test_update_gpu_matches_cpu(gpu):
    from ngx.rl.train import PPOConfig

    cfg = PPOConfig(num_envs=256, rollout_steps=16)
    with jax.default_device(gpu):
        train_step, _, (ts, last_obs, traj), _ = cs.collect_batch(cfg)
    cpu = jax.devices("cpu")[0]
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        g, _, _ = cs.compiled_run(gpu, train_step.learn, ts, last_obs, traj,
                                  key)
        c, _, _ = cs.compiled_run(cpu, train_step.learn, ts, last_obs, traj,
                                  key)
    cs.compare_update("update", g, c)
    assert np.isfinite(np.asarray(g[1][1])).all()
