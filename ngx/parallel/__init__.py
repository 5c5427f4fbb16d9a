"""Device-mesh sharding for the env batch: the multi-chip / multi-host layer.

The reference's entire distributed story is a localhost JSON-over-TCP socket
pair (reference ``tests/socket_env.py:23-51``).  Here the env batch is a
global ``jax.Array`` sharded along an ``env`` mesh axis: every chip steps its
own shard of environments inside one pjit program (zero cross-chip traffic on
the env path — stepping is elementwise along the batch), and cross-chip
collectives only appear where they belong: metric reductions and the learner's
gradient psum (:mod:`ngx.rl`).  Multi-host runs use the standard
single-controller recipe: ``jax.distributed.initialize`` per host, one global
mesh over all chips, each host feeding its local shard.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..vector import Trajectory, VecEnv, make_vec

ENV_AXIS = "env"


def make_env_mesh(n_devices: Optional[int] = None,
                  devices=None, axis_name: str = ENV_AXIS) -> Mesh:
    """1-D mesh over all (or the first ``n_devices``) chips, env-sharded."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_sharded_vec(spec, mesh: Mesh, axis_name: str = ENV_AXIS) -> VecEnv:
    """Batched env whose state/obs/reward arrays are sharded along
    ``axis_name``.  The batch passed to ``reset`` must be divisible by the
    mesh size.  All returned functions are jitted with explicit shardings so
    XLA lays every per-env array out shard-local; no collective is emitted on
    the stepping path."""
    vec = make_vec(spec)
    batch_sharded = NamedSharding(mesh, P(axis_name))
    # Every EnvState/obs leaf has a leading env axis — shard dim 0, replicate
    # the rest.  jax.tree maps the same NamedSharding over each leaf; XLA
    # extends P('env') with implicit replication on trailing dims.

    reset = jax.jit(vec.reset, out_shardings=batch_sharded)

    step = jax.jit(vec.step, out_shardings=batch_sharded)

    def rollout(state, key, policy, T):
        fn = jax.jit(vec.rollout, static_argnums=(2, 3))
        return fn(state, key, policy, T)

    return VecEnv(spec=spec, reset=reset, step=step, rollout=rollout)


def sharded_throughput_fn(spec, mesh: Mesh, batch: int, steps: int,
                          axis_name: str = ENV_AXIS):
    """The benchmark kernel, mesh-sharded: one jit launch running ``steps``
    batched steps with the batch split over every chip of ``mesh``."""
    assert batch % mesh.size == 0, (batch, mesh.size)
    vec = make_vec(spec)
    shard = NamedSharding(mesh, P(axis_name))

    @jax.jit
    def run(keys):
        state, _ = vec.reset(keys)
        state = jax.lax.with_sharding_constraint(
            state, jax.tree_util.tree_map(lambda _: shard, state))
        state, traj = vec.rollout(state, jax.random.fold_in(keys[0], 1),
                                  None, steps)
        # on-device metric reduction — the only cross-chip collective
        return state, traj.rewards.mean(), traj.dones.sum()

    def launch(key):
        keys = jax.device_put(jax.random.split(key, batch), shard)
        return run(keys)

    return launch


def make_spmd_rollout(spec, mesh: Mesh, batch: int, steps: int,
                      axis_name: str = ENV_AXIS, packed: bool = False):
    """Explicit-SPMD rollout via ``shard_map``: every chip runs its own local
    scan over ``batch / mesh.size`` envs, and the only cross-chip traffic is
    the final ``psum`` of the metrics — the pattern to scale the env axis
    across devices (collectives inserted exactly where written).

    ``packed=True`` carries each shard's state bit-packed through the local
    scan (``ngx.core.state.make_state_packers`` — lossless, bit-identical
    results); opt-in, as in :func:`ngx.vector.throughput_fn`.

    Returns ``launch(key) -> (mean_reward, episodes_done)`` (replicated
    scalars)."""
    assert batch % mesh.size == 0, (batch, mesh.size)
    local_b = batch // mesh.size
    from ..core.reset import make_reset
    from ..core.step import make_step
    import jax.numpy as jnp

    v_step = jax.vmap(make_step(spec))
    v_reset = jax.vmap(make_reset(spec))
    n_actions = spec.n_actions
    if packed:
        from ..core.state import make_state_packers
        pack_s, unpack_s, _ = make_state_packers(spec)

    def _align(tree):
        """Normalize varying-manual-axes: leaves of a reset state that don't
        depend on the per-shard keys (e.g. a constant starting inventory) are
        typed replicated under shard_map; mark everything varying so scan
        carries and cond branches type-match."""
        def fix(x):
            vma = getattr(getattr(x, "aval", None), "vma", frozenset())
            return x if axis_name in vma else \
                jax.lax.pcast(x, (axis_name,), to="varying")
        return jax.tree_util.tree_map(fix, tree)

    def local_rollout(keys):           # keys: [local_b] — this chip's shard
        state, _ = v_reset(keys)
        state = _align(state)

        def body(carry, key_t):
            state, r_sum, d_sum = carry
            if packed:
                state = unpack_s(state)
            k_act, k_reset = jax.random.split(key_t)
            actions = jax.random.randint(k_act, (local_b,), 0, n_actions)
            new_state, _, reward, done, _ = v_step(state, actions)

            def with_resets(ns):
                fresh, _ = v_reset(jax.random.split(k_reset, local_b))
                return jax.tree_util.tree_map(
                    lambda f, n: jnp.where(
                        done.reshape(done.shape + (1,) * (n.ndim - 1)), f, n),
                    fresh, ns)

            state = jax.lax.cond(jnp.any(done),
                                 lambda ns: _align(with_resets(ns)),
                                 _align, new_state)
            if packed:
                state = pack_s(state)
            return (state, r_sum + reward.sum(), d_sum + done.sum()), None

        local_key = jax.random.fold_in(keys[0], 17)
        if packed:
            state = _align(pack_s(state))
        init_carry = (state, *(_align((jnp.float32(0), jnp.int32(0)))))
        (state, r_sum, d_sum), _ = jax.lax.scan(
            body, init_carry, jax.random.split(local_key, steps))
        # the ONLY collectives: metric reductions over the env axis
        total_r = jax.lax.psum(r_sum, axis_name)
        total_d = jax.lax.psum(d_sum, axis_name)
        return total_r / (batch * steps), total_d

    spmd = jax.shard_map(
        local_rollout, mesh=mesh,
        in_specs=P(axis_name),
        out_specs=(P(), P()),
    )

    @jax.jit
    def launch(key):
        keys = jax.random.split(key, batch)
        return spmd(keys)

    return launch


_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "all-to-all",
                     "collective-permute", "reduce-scatter",
                     "collective-broadcast", "ragged-all-to-all")
_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}


def collective_instrs(hlo_text: str):
    """``(kind, nbytes, line)`` for every collective instruction in
    post-optimization HLO text (``compiled.as_text()``).  Bytes = the op's
    result payload."""
    import re

    out = []
    for line in hlo_text.splitlines():
        ls = line.strip()
        m = re.match(r"(?:ROOT\s+)?%?\S+\s*=\s*(.+?)\s+"
                     r"(" + "|".join(_COLLECTIVE_KINDS) + r")(?:-start)?\(",
                     ls)
        if not m:
            continue
        shapes, kind = m.group(1), m.group(2)
        nbytes = 0
        for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shapes):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        out.append((kind, nbytes, ls[:160]))
    return out


def audit_train_step_collectives(hlo_text: str, params, env_state):
    """Check the compiled sharded PPO train step moves only what data
    parallelism needs: every collective is an all-reduce, and each is either
    (a) a gradient sync — per-leaf or fused, each at most the parameter
    payload plus 1 KiB of scalar statistics the compiler may fuse into it
    (XLA:GPU concatenates the loss psums into the gradient buffer), together
    at most twice the payload — or (b) a scalar-sized statistic (advantage
    moments, metric sums), under 1% of the env-state bytes.  No env-state
    collective may appear.  Raises AssertionError naming the offending
    instructions; returns a summary dict."""
    cols = collective_instrs(hlo_text)
    kinds = {k for k, _, _ in cols}
    assert kinds == {"all-reduce"}, ("collectives other than all-reduce",
                                     sorted(kinds), cols)
    params_bytes = int(sum(np.prod(x.shape) * x.dtype.itemsize
                           for x in jax.tree_util.tree_leaves(params)))
    state_bytes = int(sum(np.prod(x.shape) * x.dtype.itemsize
                          for x in jax.tree_util.tree_leaves(env_state)))
    scalar_bytes = 1024
    grad_ars = [c for c in cols if c[1] > scalar_bytes]
    small_ars = [c for c in cols if c[1] <= scalar_bytes]
    assert grad_ars, ("no gradient all-reduce", cols)
    assert all(b <= params_bytes + scalar_bytes for _, b, _ in grad_ars), (
        "all-reduce larger than the parameters", params_bytes, grad_ars)
    grad_total = sum(b for _, b, _ in grad_ars)
    assert grad_total <= 2 * params_bytes, (grad_total, params_bytes)
    assert all(b < state_bytes // 100 for _, b, _ in small_ars), (
        "non-scalar statistic all-reduce", small_ars)
    return {"gradient_all_reduces": len(grad_ars),
            "gradient_bytes": grad_total, "params_bytes": params_bytes,
            "scalar_all_reduces": len(small_ars),
            "scalar_bytes": sum(b for _, b, _ in small_ars)}


def episode_metrics(traj: Trajectory):
    """Per-batch reductions computed on device (success rate, mean step cost,
    mean reward) — the structured-metrics analog of the reference's Monitor
    CSV logs (reference tests/train.py:109)."""
    return {
        "mean_reward": traj.rewards.mean(),
        "episodes_finished": traj.dones.sum(),
        "mean_step_cost": traj.step_costs.mean(),
        "steps": jnp.asarray(traj.rewards.size),
    }


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host bring-up (jax.distributed.initialize wrapper).  Call once
    per host before building meshes; afterwards jax.devices() spans the pod
    slice and make_env_mesh() shards globally."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def host_local_keys(key, global_batch: int, mesh: Mesh,
                    axis_name: str = ENV_AXIS):
    """Build the global [B] key array from per-host local data — each host
    only materialises its own shard (multi-host feed path)."""
    shard = NamedSharding(mesh, P(axis_name))
    keys = jax.random.split(key, global_batch)
    return jax.device_put(keys, shard)
