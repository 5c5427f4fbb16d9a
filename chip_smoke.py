"""Smoke test of ngx's main path on NVIDIA GPUs, checked against the CPU.

    python chip_smoke.py               # env stepping + PPO on one GPU
    python chip_smoke.py --devices 4   # the data-parallel path on four GPUs

One process drives the card and takes every reference from the CPU device of
the same process (``jax.devices("cpu")``), so no second process opens the
card.  Phases on one card:

0. device check: JAX's default device must be a GPU; prints the card's name
   and power limit (``nvidia-smi``) and the jax/jaxlib versions;
1. env stepping at 8,192 Pogostick-v1 envs — the bench kernel
   (``ngx.vector.throughput_fn``) and a 64-step ``make_vec`` rollout with
   random actions and a 32-step episode cap (every env resets).  The
   integer state and the per-step actions and dones must be bit-identical
   to the CPU's; float fields agree to rtol 1e-6 (the GPU compiler may
   contract a multiply-add into an FMA);
2. ``ActorCritic`` (64, 64) logits and values on 8,192 observations at
   "highest" matmul precision, rtol/atol 1e-5 (the deviation at the default
   precision, which may use TF32, is printed too);
3. one PPO update (GAE + 4 epochs x 8 minibatches) on one fixed 8,192 x 64
   trajectory batch fed to both devices: loss and updated params at
   "highest" precision, rtol 1e-4;
4. the trainer CLI (``ngx.cli.train.main``) for 3 updates, plain and with a
   mid-run remapaction novelty: every metric finite.

``--devices 4`` runs only the multi-device path: ``make_spmd_rollout`` and
data-parallel PPO (``make_train(cfg, mesh)``) at 8,192 global envs over four
GPUs, each against the same program on a 4-device CPU mesh, plus the
collective audit of the GPU-compiled train step.

Times printed are smoke timings of single runs, not benchmark numbers.  The
last stdout line is ``{"ok": true, "device": {...}}``; any failure exits
nonzero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ENV_ID = "NovelGridworld-Pogostick-v1"
B, T, S = 8192, 64, 256          # envs, rollout steps, bench-kernel steps
INT_FIELDS = ("map", "agent", "facing", "inventory", "step_count",
              "selected", "last_action", "last_done")
FLOAT_FIELDS = ("last_reward", "last_cost")
ENV_RTOL = 1e-6
MEAN_RTOL = 1e-5
POLICY_TOL = 1e-5
UPDATE_RTOL = 1e-4
# absolute floor of the update comparison: params that sit at ~0 (a bias
# that barely moved) have no meaningful relative error; 1e-6 is 0.4% of one
# Adam step at the trainer's lr of 2.5e-4
UPDATE_ATOL = 1e-6


class SmokeFailure(AssertionError):
    pass


def compare_exact(name, a, b):
    """Bit-identity of two arrays; returns the number of elements."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise SmokeFailure(f"{name}: shape/dtype {a.shape} {a.dtype} vs "
                           f"{b.shape} {b.dtype}")
    bad = np.argwhere(a != b)
    if bad.size:
        i = tuple(int(x) for x in bad[0])
        raise SmokeFailure(f"{name}: {len(bad)} of {a.size} elements differ;"
                           f" first at {i}: {a[i]!r} vs {b[i]!r}")
    return a.size


def max_deviation(a, b):
    """(max |a-b|, max |a-b| / |b| over elements with b != 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    nz = b != 0
    rel = float(np.max(d[nz] / np.abs(b[nz]))) if nz.any() else 0.0
    return (float(d.max()) if d.size else 0.0), rel


def compare_close(name, a, b, rtol, atol=0.0):
    """``|a - b| <= atol + rtol * |b|`` elementwise (numpy's allclose), with
    NaNs never equal; returns (max abs, max rel) deviation."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise SmokeFailure(f"{name}: shape {a.shape} vs {b.shape}")
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    dev = max_deviation(a, b)
    ok = np.abs(a.astype(np.float64) - b) <= atol + rtol * np.abs(
        b.astype(np.float64))
    if not ok.all():
        i = tuple(int(x) for x in np.argwhere(~ok)[0])
        raise SmokeFailure(
            f"{name}: {int((~ok).sum())} of {a.size} elements outside rtol "
            f"{rtol} atol {atol}; first at {i}: {a[i]!r} vs {b[i]!r}; max "
            f"abs {dev[0]:.3e} rel {dev[1]:.3e}")
    return dev


def compare_state(name, ga, ca):
    """EnvState: integer fields bit-identical, float fields to ENV_RTOL."""
    n = sum(compare_exact(f"{name}.{f}", getattr(ga, f), getattr(ca, f))
            for f in INT_FIELDS)
    for f in FLOAT_FIELDS:
        compare_close(f"{name}.{f}", getattr(ga, f), getattr(ca, f),
                      ENV_RTOL)
    return n


def compare_trees(name, ga, ca, rtol, atol):
    """Every leaf of two pytrees; returns the worst (abs, rel) deviation."""
    import jax

    worst = (0.0, 0.0)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ga),
                            jax.tree_util.tree_leaves(ca)):
        dev = compare_close(name + jax.tree_util.keystr(path), a, b, rtol,
                            atol)
        worst = (max(worst[0], dev[0]), max(worst[1], dev[1]))
    return worst


def log(msg):
    print(msg, flush=True)


def compiled_run(device, fn, *args):
    """Compile ``fn`` for ``device`` and run it once there; returns
    (host result, compile seconds, run seconds)."""
    import jax

    args = jax.device_put(args, device)
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t2 = time.perf_counter()
    return jax.device_get(out), t1 - t0, t2 - t1


def check_checkout():
    """The program must be this checkout's: a lone chip_smoke.py fails."""
    import ngx

    pkg = os.path.dirname(os.path.abspath(ngx.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SmokeFailure(f"ngx imported from {pkg}, not from this "
                           f"checkout ({HERE})")


def device_check(n_gpus):
    """Phase 0.  Returns (gpu devices, cpu devices)."""
    import jax
    import jaxlib

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"JAX's default device is {dev.platform} "
                           f"({dev.device_kind}); this smoke test needs a "
                           f"CUDA GPU")
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    cpus = jax.devices("cpu")
    if len(gpus) < n_gpus or len(cpus) < n_gpus:
        raise SmokeFailure(f"need {n_gpus} GPUs and CPU devices, found "
                           f"{len(gpus)} and {len(cpus)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
        f"{len(gpus)} x {dev.device_kind}")
    return gpus[:n_gpus], cpus[:n_gpus]


def phase_env(gpu, cpu):
    """Phase 1.  Returns the reset observations (host) for phase 2."""
    import jax
    import ngx
    from ngx.transforms import lidar_in_front
    from ngx.vector import make_vec, throughput_fn

    spec = ngx.make_spec(ENV_ID)
    key = jax.random.key(0)
    bench = throughput_fn(spec, B, S)
    (gs, gm), tc, tr = compiled_run(gpu, bench, key)
    (cs, cm), _, _ = compiled_run(cpu, bench, key)
    log(f"phase 1 smoke timing: bench kernel {B} envs x {S} steps: "
        f"compile {tc:.1f}s, run {tr*1e3:.1f}ms")
    n = compare_state("bench final state", gs, cs)
    dev = compare_close("bench mean reward", gm, cm, MEAN_RTOL)
    log(f"phase 1 bench kernel: {n} integer state elements bit-identical; "
        f"mean reward {float(gm)!r} vs cpu {float(cm)!r} (rel dev "
        f"{dev[1]:.1e}, rtol {MEAN_RTOL})")

    # an episode cap of T/2 sends every env through the auto-reset at least
    # once, so the reset path is compared too
    vec = make_vec(lidar_in_front(spec), episode_cap=T // 2)

    def rollout(keys, k):
        state, obs0 = vec.reset(keys)
        state, traj = vec.rollout(state, k, None, T)
        return state, obs0, traj

    keys = jax.random.split(jax.random.key(1), B)
    (gs, go, gt), tc, tr = compiled_run(gpu, rollout, keys, key)
    (cs, co, ct), _, _ = compiled_run(cpu, rollout, keys, key)
    log(f"phase 1 smoke timing: make_vec rollout {B} envs x {T} steps: "
        f"compile {tc:.1f}s, run {tr*1e3:.1f}ms")
    n = compare_state("rollout final state", gs, cs)
    n += compare_exact("rollout actions", gt.actions, ct.actions)
    n += compare_exact("rollout dones", gt.dones, ct.dones)
    worst = 0.0
    for name, a, b in (("reward", gt.rewards, ct.rewards),
                       ("step cost", gt.step_costs, ct.step_costs),
                       ("lidar obs", gt.obs, ct.obs),
                       ("reset obs", go, co)):
        worst = max(worst, compare_close(f"rollout {name}", a, b,
                                         ENV_RTOL)[1])
    log(f"phase 1 rollout: {n} integer elements (state, actions, dones) "
        f"bit-identical; reward, step cost and obs max rel dev "
        f"{worst:.1e} (rtol {ENV_RTOL}); {int(np.sum(gt.dones))} episode "
        f"ends")
    return co


def phase_policy(gpu, cpu, obs):
    """Phase 2."""
    import jax
    from ngx.rl.models import ActorCritic
    from ngx.transforms import lidar_in_front
    import ngx

    spec = lidar_in_front(ngx.make_spec(ENV_ID))
    model = ActorCritic(n_actions=spec.n_actions, hidden=(64, 64))
    params = jax.device_get(model.init(jax.random.key(1), obs))
    (gl, gv), _, _ = compiled_run(gpu, model.apply, params, obs)
    (cl, cv), _, _ = compiled_run(cpu, model.apply, params, obs)
    dl, dv = max_deviation(gl, cl), max_deviation(gv, cv)
    log(f"phase 2 policy at default precision: max abs dev logits "
        f"{dl[0]:.2e}, values {dv[0]:.2e} (not checked)")
    with jax.default_matmul_precision("highest"):
        (gl, gv), _, _ = compiled_run(gpu, model.apply, params, obs)
        (cl, cv), _, _ = compiled_run(cpu, model.apply, params, obs)
    dl = compare_close("logits", gl, cl, POLICY_TOL, POLICY_TOL)
    dv = compare_close("values", gv, cv, POLICY_TOL, POLICY_TOL)
    log(f"phase 2 policy at highest precision: logits {gl.shape} max abs dev"
        f" {dl[0]:.2e}, values max abs dev {dv[0]:.2e} (rtol/atol "
        f"{POLICY_TOL})")


def collect_batch(cfg, mesh=None):
    """One trajectory batch from the trainer's own acting loop on the
    default devices; returns (make_train's train_step, carry, host batch)."""
    import jax
    from ngx.rl.train import make_train

    init, train_step = make_train(cfg, mesh)
    carry = init(jax.random.key(2))
    ts, env_state, obs, _ = carry
    t0 = time.perf_counter()
    _, last_obs, traj = jax.block_until_ready(jax.jit(train_step.rollout)(
        ts.params, env_state, obs, jax.random.key(3)))
    t = time.perf_counter() - t0
    batch = jax.device_get((ts, last_obs, traj))
    return train_step, carry, batch, t


def compare_update(name, g, c):
    """Losses and params of one PPO update, GPU vs CPU (phase-3 rule)."""
    (g_ts, (gpg, gvl, gent)), (c_ts, (cpg, cvl, cent)) = g, c
    from ngx.rl.train import PPOConfig
    cfg = PPOConfig()
    total = [pg + cfg.vf_coef * vl - cfg.ent_coef * ent
             for pg, vl, ent in ((gpg, gvl, gent), (cpg, cvl, cent))]
    dl = compare_close(f"{name} loss", total[0], total[1], UPDATE_RTOL)
    compare_close(f"{name} value loss", gvl, cvl, UPDATE_RTOL)
    compare_close(f"{name} entropy", gent, cent, UPDATE_RTOL)
    dpg = max_deviation(gpg, cpg)
    dp = compare_trees(f"{name} params", g_ts.params, c_ts.params,
                       UPDATE_RTOL, UPDATE_ATOL)
    log(f"{name}: {np.size(total[0])} minibatch losses max rel dev "
        f"{dl[1]:.1e} (rtol {UPDATE_RTOL}); policy-gradient loss max abs dev"
        f" {dpg[0]:.1e} (not checked: ~0 at ratio 1); params max abs dev "
        f"{dp[0]:.1e}, max rel dev {dp[1]:.1e} (rtol {UPDATE_RTOL}, atol "
        f"{UPDATE_ATOL})")


def phase_update(gpu, cpu):
    """Phase 3, plus the compiled train step's memory analysis."""
    import jax
    from ngx.rl.train import PPOConfig

    cfg = PPOConfig(num_envs=B, rollout_steps=T)
    with jax.default_device(gpu):
        train_step, carry, (ts, last_obs, traj), t = collect_batch(cfg)
        log(f"phase 3 smoke timing: acting loop {B} x {T} (compile + run) "
            f"{t:.1f}s")
        t0 = time.perf_counter()
        compiled = jax.jit(train_step).lower(carry, jax.random.key(4)) \
            .compile()
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, m = jax.block_until_ready(compiled(carry, jax.random.key(4)))
        tr = time.perf_counter() - t0
    log(f"phase 3 smoke timing: train step {B} x {T}: compile {tc:.1f}s, "
        f"run {tr*1e3:.1f}ms")
    log(f"phase 3 train step memory_analysis(): {compiled.memory_analysis()}")
    bad = {k: float(v) for k, v in m.items() if not np.isfinite(float(v))}
    if bad:
        raise SmokeFailure(f"train step metrics not finite: {bad}")
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        g, tc, tr = compiled_run(gpu, train_step.learn, ts, last_obs, traj,
                                 key)
        c, _, _ = compiled_run(cpu, train_step.learn, ts, last_obs, traj,
                               key)
    log(f"phase 3 smoke timing: update (GAE + {cfg.epochs} epochs x "
        f"{cfg.num_minibatches} minibatches) at highest precision: compile "
        f"{tc:.1f}s, run {tr*1e3:.1f}ms")
    compare_update("phase 3 update", g, c)


def phase_cli():
    """Phase 4."""
    from ngx.cli.train import main as train_main

    base = ["-env", ENV_ID, "-num_envs", str(B), "-rollout", str(T),
            "-steps", str(3 * B * T)]
    with tempfile.TemporaryDirectory() as d:
        for name, extra in (
                ("plain", []),
                ("novelty", ["-inject_novelty_at", str(B * T),
                             "-novelty", "remapaction"])):
            t0 = time.perf_counter()
            hist = train_main(base + extra + ["-log", os.path.join(d, name)])
            t = time.perf_counter() - t0
            bad = [(i, k, v) for i, m in enumerate(hist)
                   for k, v in m.items() if not np.isfinite(v)]
            if len(hist) != 3 or bad:
                raise SmokeFailure(f"trainer CLI ({name}): {len(hist)} "
                                   f"updates, non-finite metrics {bad}")
            log(f"phase 4 trainer CLI ({name}): 3 updates, all "
                f"{len(hist[0])} metrics finite; smoke timing {t:.1f}s "
                f"including compilation")


def phase_multi(gpus, cpus):
    """--devices 4: SPMD rollout and data-parallel PPO, GPU mesh vs CPU
    mesh, plus the collective audit of the GPU-compiled train step."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import ngx
    from ngx.parallel import audit_train_step_collectives, make_spmd_rollout
    from ngx.rl.train import PPOConfig, make_train

    n = len(gpus)
    spec = ngx.make_spec(ENV_ID)
    meshes = {"gpu": Mesh(np.asarray(gpus), ("env",)),
              "cpu": Mesh(np.asarray(cpus), ("env",))}
    res = {}
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        r = jax.block_until_ready(
            make_spmd_rollout(spec, mesh, B, S)(jax.random.key(0)))
        res[name] = jax.device_get(r)
        if name == "gpu":
            log(f"multi smoke timing: spmd rollout {B} envs x {S} steps over "
                f"{n} GPUs (compile + run) {time.perf_counter() - t0:.1f}s")
    compare_exact("spmd mean reward", res["gpu"][0], res["cpu"][0])
    compare_exact("spmd episodes", res["gpu"][1], res["cpu"][1])
    log(f"multi spmd rollout: mean reward {float(res['gpu'][0])!r}, "
        f"{int(res['gpu'][1])} episodes, bit-identical to the {n}-device "
        f"CPU mesh")

    cfg = PPOConfig(num_envs=B, rollout_steps=T)
    carries, learners = {}, {}
    for name, mesh in meshes.items():
        with mesh:
            init, step = make_train(cfg, mesh)
            carry = init(jax.random.key(2))
        learners[name] = step.learn
        devs = set(mesh.devices.flat)
        for path, leaf in jax.tree_util.tree_leaves_with_path(carry):
            if leaf.sharding.device_set != devs:
                raise SmokeFailure(
                    f"{name} carry{jax.tree_util.keystr(path)} lives on "
                    f"{len(leaf.sharding.device_set)} of {n} devices")
        carries[name] = jax.device_get(carry)
    n_el = compare_state("multi init env state", carries["gpu"][1],
                         carries["cpu"][1])
    compare_close("multi init obs", carries["gpu"][2], carries["cpu"][2],
                  ENV_RTOL)
    log(f"multi init: every carry leaf on all {n} devices of its mesh; "
        f"{n_el} integer env-state elements bit-identical")

    mesh = meshes["gpu"]
    with mesh:
        train_step, carry, (ts, last_obs, traj), t = collect_batch(cfg, mesh)
        log(f"multi smoke timing: sharded acting loop {B} x {T} over {n} "
            f"GPUs (compile + run) {t:.1f}s")
        t0 = time.perf_counter()
        compiled = jax.jit(train_step).lower(carry, jax.random.key(4)) \
            .compile()
        tc = time.perf_counter() - t0
        audit = audit_train_step_collectives(compiled.as_text(),
                                             carry[0].params, carry[1])
        t0 = time.perf_counter()
        _, m = jax.block_until_ready(compiled(carry, jax.random.key(4)))
        tr = time.perf_counter() - t0
    log(f"multi collective audit of the GPU-compiled train step: {audit}")
    log(f"multi smoke timing: sharded train step over {n} GPUs: compile "
        f"{tc:.1f}s, run {tr*1e3:.1f}ms")
    bad = {k: float(v) for k, v in m.items() if not np.isfinite(float(v))}
    if bad:
        raise SmokeFailure(f"sharded train step metrics not finite: {bad}")

    out = {}
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        for name, mesh in meshes.items():
            env = NamedSharding(mesh, P(None, "env"))
            args = (jax.device_put(ts, NamedSharding(mesh, P())),
                    jax.device_put(last_obs, NamedSharding(mesh, P("env"))),
                    jax.device_put(traj, env),
                    jax.device_put(key, NamedSharding(mesh, P())))
            with mesh:
                out[name] = jax.device_get(jax.block_until_ready(
                    jax.jit(learners[name])(*args)))
    compare_update("multi data-parallel update", out["gpu"], out["cpu"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=(1, 4),
                   help="4 = run only the multi-device path on four GPUs")
    args = p.parse_args(argv)
    if args.devices > 1:
        # a CPU mesh of the same size as the reference; read when the CPU
        # backend initialises, so set before any jax use
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={args.devices}").strip()
    import jax

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        # the CPU reference runs in this same process
        jax.config.update("jax_platforms", plats + ",cpu")
    try:
        check_checkout()
        gpus, cpus = device_check(args.devices)
    except (SmokeFailure, ImportError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    from ngx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    t0 = time.perf_counter()
    try:
        if args.devices > 1:
            phase_multi(gpus, cpus)
        else:
            obs = phase_env(gpus[0], cpus[0])
            phase_policy(gpus[0], cpus[0], obs)
            phase_update(gpus[0], cpus[0])
            phase_cli()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
