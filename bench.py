"""Benchmark: env-steps/s on one device for batched Pogostick-v1 envs.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N}

vs_baseline is the speedup over the reference implementation
(gtatiya/gym-novel-gridworlds) stepping a single Python env on a host CPU —
the only runnable baseline, since the reference publishes no numbers
(BASELINE.md).  A recorded floor of 20,000 steps/s is used by default;
NGX_BENCH_MEASURE_REF=1 re-measures it live.

The stages run on JAX's default device, which must be an accelerator; the
metric text names its platform and device kind.  Any failed stage ends the
run with a nonzero exit.  ``--profile`` writes a jax.profiler trace under
results/profile/.
"""

import json
import os
import sys
import time

import numpy as np

REF_FLOOR_STEPS_PER_S = 20000.0
ENV_ID = os.environ.get("NGX_BENCH_ENV", "NovelGridworld-Pogostick-v1")

# (batch, scan_steps, timed_repeats, packed).  The HEADLINE is the
# north-star config (8192 envs — BASELINE.json's metric definition); the
# larger stages document the batch-scaling curve and ride along in the
# metric text as secondary lines.  packed=True carries the state bit-packed
# through the scan (lossless, bit-identical results;
# ngx.core.state.make_state_packers); both variants run at the headline
# batch and the best is quoted.
HEADLINE_BATCH = 8192
STAGES = [
    (8192, 8192, 2, True),
    (8192, 16384, 2, True),
    (8192, 8192, 2, False),
    (262144, 1024, 2, False),
    (65536, 1024, 2, False),
]


def measure_reference(n_steps=2000):
    """Single-env random-action throughput of the mounted reference (CPU),
    or None when the reference is not mounted."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from reference_loader import make_ref_env, reference_available
    if not reference_available():
        return None
    ref = make_ref_env(ENV_ID)
    np.random.seed(0)
    ref.reset()
    rng = np.random.RandomState(1)
    n = ref.action_space.n
    t0 = time.perf_counter()
    for _ in range(n_steps):
        _, _, done, _ = ref.step(int(rng.randint(n)))
        if done:
            ref.reset()
    return n_steps / (time.perf_counter() - t0)


def run_stage(spec, batch, steps, repeats, packed):
    """Compile, warm up and time one stage; returns env-steps/s."""
    import jax
    from ngx.vector import throughput_fn

    key = jax.random.key(0)
    t0 = time.time()
    run = throughput_fn(spec, batch, steps, packed=packed)
    jax.block_until_ready(run(key))            # compile + warmup
    print(f"[bench] B={batch} S={steps} packed={packed}: compile+warmup "
          f"{time.time()-t0:.1f}s", file=sys.stderr, flush=True)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        _, mean_r = jax.block_until_ready(run(jax.random.fold_in(key, i + 1)))
        times.append(time.perf_counter() - t0)
        assert np.isfinite(float(mean_r))
    sps = batch * steps / min(times)
    print(f"[bench] B={batch} S={steps} packed={packed}: "
          f"{sps/1e6:.1f}M steps/s", file=sys.stderr, flush=True)
    return sps


def main():
    import jax
    import ngx
    from ngx.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only the CPU")
    ref = REF_FLOOR_STEPS_PER_S
    if os.environ.get("NGX_BENCH_MEASURE_REF"):
        ref = measure_reference() or REF_FLOOR_STEPS_PER_S

    spec = ngx.make_spec(ENV_ID)
    best = {}          # batch -> best env-steps/s over its stages
    for batch, steps, repeats, packed in STAGES:
        sps = run_stage(spec, batch, steps, repeats, packed)
        best[batch] = max(sps, best.get(batch, 0.0))

    if "--profile" in sys.argv:
        from ngx.vector import throughput_fn
        outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "results", "profile")
        os.makedirs(outdir, exist_ok=True)
        batch, steps, _, packed = STAGES[-1]  # the small stage: trace size
        run = throughput_fn(spec, batch, steps, packed=packed)
        key = jax.random.fold_in(jax.random.key(0), 99)
        jax.block_until_ready(run(key))
        with jax.profiler.trace(outdir):
            jax.block_until_ready(run(key))
        print(f"[bench] profiler trace written to {outdir}",
              file=sys.stderr, flush=True)

    value = best[HEADLINE_BATCH]
    secondary = "; ".join(f"{b}: {v/1e6:.0f}M" for b, v in sorted(best.items())
                          if b != HEADLINE_BATCH)
    print(json.dumps({
        "metric": f"env-steps/s/device, {HEADLINE_BATCH} batched {ENV_ID} "
                  f"envs on {dev.platform} ({dev.device_kind}) (random "
                  f"actions, fused scan rollout; baseline = reference "
                  f"single-env Python loop on a host CPU"
                  + (f"; secondary batch curve {secondary}" if secondary
                     else "") + ")",
        "value": round(value),
        "unit": "env-steps/s",
        "vs_baseline": round(value / ref, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
