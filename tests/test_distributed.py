"""REAL multi-process jax.distributed test: 2 OS processes x 4 virtual CPU
devices each join one coordinator and run the shard_map SPMD rollout over a
single global 8-device mesh; the psum'd metrics must match a single-process
8-device run of the identical program bit-for-bit.

This is the stand-in for multi-host scaling on one machine: it exercises
ngx.parallel.initialize_distributed (the jax.distributed.initialize wrapper)
and proves the global-mesh + shard_map + psum recipe is process-count
invariant.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import ngx
from ngx.parallel import (audit_train_step_collectives, collective_instrs,
                          make_env_mesh, make_spmd_rollout)

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, STEPS = 64, 12


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_spmd_rollout_matches_single_process():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # isolate from any inherited single-process jax state
    env.pop("JAX_NUM_PROCESSES", None)

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_distributed_worker.py"),
             str(pid), "2", coordinator, str(BATCH), str(STEPS)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        res = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert res, f"no RESULT line:\n{out}\n{err}"
        outs.append(json.loads(res[0][len("RESULT "):]))

    # both processes saw the global 8-device topology and agree on the
    # replicated psum'd metrics
    assert all(o["device_count"] == 8 for o in outs), outs
    assert outs[0]["mean_reward"] == outs[1]["mean_reward"], outs
    assert outs[0]["episodes"] == outs[1]["episodes"], outs

    # single-process 8-virtual-device run of the identical program
    spec = ngx.make_spec("NovelGridworld-Pogostick-v1")
    mesh = make_env_mesh()
    assert mesh.size == 8
    launch = make_spmd_rollout(spec, mesh, BATCH, STEPS)
    mean_r, episodes = launch(jax.random.key(0))
    assert float(mean_r) == outs[0]["mean_reward"], (
        float(mean_r), outs[0]["mean_reward"])
    assert int(episodes) == outs[0]["episodes"]


def test_scaling_harness_small():
    """The scaling harness runs end-to-end on a tiny config and produces
    sane numbers.  The CI bound is deliberately loose (virtual CPU devices
    share one host's cores and CI machines vary)."""
    from ngx.rl.scaling import measure_scaling

    # best of 5 timed steps per mesh: a co-running process on the shared
    # cores slows single steps, not all of them
    r = measure_scaling(device_counts=(1, 2), per_device_batch=32,
                        rollout_steps=4, repeats=5, mode="fixed-total",
                        hidden=(16, 16))
    assert r["throughput"][1] > 0 and r["throughput"][2] > 0
    # sanity-only bound: virtual devices time-share the host's cores, so a
    # co-running process can tank the ratio (observed under a concurrent
    # eval job); the structural evidence is the HLO audit below
    assert r["efficiency"][2] > 0.15, r


# ---------------------------------------------------------------------------
# Compiled-HLO collective audit (structural multi-device evidence): prove the
# sharding layout structurally — the env path compiles to ZERO inter-device
# collectives and the train step's only cross-device traffic is the gradient
# all-reduce plus scalar metric/normalization psums.
# ---------------------------------------------------------------------------

def test_hlo_audit_env_path_has_no_collectives():
    """The sharded SPMD env rollout must compile to exactly the two scalar
    metric psums (all-reduce of one f32 + one s32) and NOTHING else — no
    all-gather/permute/all-to-all of env state anywhere.  This is the
    structural form of the >=80% scaling claim: stepping is elementwise
    along the env axis, so adding chips adds zero communication."""
    spec = ngx.make_spec("NovelGridworld-Pogostick-v1")
    mesh = make_env_mesh()
    launch = make_spmd_rollout(spec, mesh, BATCH, STEPS)
    hlo = jax.jit(launch).lower(jax.random.key(0)).compile().as_text()
    cols = collective_instrs(hlo)
    kinds = {k for k, _, _ in cols}
    assert kinds <= {"all-reduce"}, cols
    total = sum(b for _, b, _ in cols)
    # two replicated scalars (f32 mean-reward sum + s32 episode count);
    # XLA may emit each as a tuple all-reduce or fuse them
    assert total <= 16, cols
    print(f"\nenv-path collectives: {len(cols)} all-reduces, "
          f"{total} bytes total (scalar metrics only)")


def test_hlo_audit_train_step_gradient_allreduce_only():
    """The full sharded PPO train step: every collective must be an
    all-reduce, and they partition into (a) the gradient sync — per-leaf or
    fused, each <= the policy+value parameter payload — and (b) scalar
    psums (advantage normalization moments, metric means).  No env-state
    collective (all-gather / permute / reduce-scatter) may appear: the
    rollout stays shard-local under the mesh.  Reports the bytes moved per
    update."""
    from jax.sharding import Mesh
    from ngx.rl.train import PPOConfig, make_train

    mesh = Mesh(np.asarray(jax.devices()), ("env",))
    cfg = PPOConfig(num_envs=8 * 16, rollout_steps=8, num_minibatches=2,
                    epochs=2, hidden=(64, 64))
    with mesh:
        init, train_step = make_train(cfg, mesh)
        carry = init(jax.random.key(0))
        hlo = jax.jit(train_step).lower(
            carry, jax.random.key(1)).compile().as_text()
    r = audit_train_step_collectives(hlo, carry[0].params, carry[1])
    per_update = (r["gradient_bytes"] * cfg.epochs * cfg.num_minibatches
                  + r["scalar_bytes"])
    print(f"\ntrain-step collectives: {r['gradient_all_reduces']} gradient "
          f"all-reduce instr(s) totalling {r['gradient_bytes']} bytes "
          f"(params = {r['params_bytes']} B), {r['scalar_all_reduces']} "
          f"scalar psums; approx bytes/update = {per_update} "
          f"({cfg.epochs}x{cfg.num_minibatches} minibatch syncs)")


def test_mesh_train_step_with_bc_anchor_and_solve_shaping():
    """The shard-local update composes with the BC-anchor loss term and
    solve shaping (the solver recipe under a mesh): the closed-over demo
    arrays replicate into every shard and the pmean'd gradients stay
    finite."""
    from jax.sharding import Mesh
    from ngx.rl.train import PPOConfig, make_train

    mesh = Mesh(np.asarray(jax.devices()), ("env",))
    cfg = PPOConfig(num_envs=8 * 16, rollout_steps=8, num_minibatches=2,
                    epochs=1, hidden=(16, 16), bc_coef=0.05,
                    solve_shaped=True)
    rng = np.random.RandomState(0)
    bc = (rng.rand(64, 63).astype(np.float32), np.zeros((64,), np.int32))
    with mesh:
        init, train_step = make_train(cfg, mesh, bc_data=bc)
        carry = init(jax.random.key(0))
        carry, m = jax.jit(train_step)(carry, jax.random.key(1))
    assert np.isfinite(float(m["pg_loss"])) and np.isfinite(
        float(m["v_loss"]))


def test_spmd_rollout_packed_carry_bit_identical():
    """The sharded SPMD rollout with the bit-packed carry must produce the
    exact metrics of the unpacked form (packing is lossless; same RNG
    streams), and its compiled HLO stays collective-free on the env path."""
    spec = ngx.make_spec("NovelGridworld-Pogostick-v1")
    mesh = make_env_mesh()
    a = make_spmd_rollout(spec, mesh, BATCH, STEPS)
    b = make_spmd_rollout(spec, mesh, BATCH, STEPS, packed=True)
    ra = a(jax.random.key(3))
    rb = b(jax.random.key(3))
    assert float(ra[0]) == float(rb[0]) and int(ra[1]) == int(rb[1])
    hlo = jax.jit(b).lower(jax.random.key(3)).compile().as_text()
    cols = collective_instrs(hlo)
    assert {k for k, _, _ in cols} <= {"all-reduce"}
    assert sum(x for _, x, _ in cols) <= 16, cols
