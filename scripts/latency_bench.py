"""Single-proof latency (BASELINE config 1) and the dispatch floor.

The reference's primary Criterion unit is ONE proof phase at N=512
(ring-zk benches/bench.rs:35-49). This script measures, in one
fresh process,

  1. the dispatch floor: a trivial jitted program (one scalar add on a
     [8] array), timed with the same median-of-windows discipline;
  2. the batch-1 roundtrip as-is;
  3. the batch-1 roundtrip with the fixed message baked into the program
     (no x argument at all);
  4. batch-8 and batch-64 roundtrips, for the amortization curve.

If (2) - (1) is small compared to (1), the latency is the backend's
per-dispatch cost, not the program's compute.

Usage: python scripts/latency_bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_DEFAULT_PRNG_IMPL", "rbg")

import jax
import jax.numpy as jnp

from ringzk_tpu.utils import compile_cache


def _time_fn(fn, args, iters=50, windows=5):
    """Median-of-windows LATENCY timing: block_until_ready after EVERY
    dispatch. bench.py's throughput loops deliberately let dispatches
    pipeline (sync once per window); here that would measure reciprocal
    throughput and understate time-to-result, which is the entire quantity
    this script decomposes -- a latency number must include the full
    dispatch->result round trip of each call."""
    out = fn(*args)
    jax.block_until_ready(out)
    for _ in range(3):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return times[len(times) // 2]


def main():
    compile_cache.enable()
    from ringzk_tpu import Params, keygen
    from ringzk_tpu.protocols import open as open_mod

    params = Params()
    n_deg = 512
    kk, kx, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    ck = keygen(kk, params, n_deg)

    results = {}

    # 1. dispatch floor
    tiny = jnp.zeros((8,), jnp.int32)
    floor_f = jax.jit(lambda v: v + 1)
    results["dispatch_floor_ms"] = _time_fn(floor_f, (tiny,)) * 1e3

    # 2. batch-1 roundtrip (config 1: message [1,2,3,4])
    x1 = jnp.zeros((1, params.l, n_deg), jnp.int32).at[..., :4].set(
        jnp.asarray([1, 2, 3, 4], jnp.int32)
    )
    step = jax.jit(lambda k, x: open_mod.roundtrip(k, ck, x, params))
    results["single_proof_ms"] = _time_fn(step, (kp, x1)) * 1e3

    # 3. batch-1 with the message baked into the program (config 1's
    # message IS a fixed constant): removes the x argument transfer/check,
    # the only program-side latency lever left at batch 1
    results["single_proof_baked_msg_ms"] = _time_fn(
        jax.jit(lambda k: open_mod.roundtrip(k, ck, x1, params)),
        (kp,),
    ) * 1e3

    # 4. amortization curve
    for b in (8, 64):
        xb = jax.random.randint(
            kx, (b, params.l, n_deg), -params.q, params.q + 1, dtype=jnp.int32
        )
        dt = _time_fn(step, (kp, xb))
        results[f"batch{b}_ms_per_proof"] = dt / b * 1e3
        results[f"batch{b}_total_ms"] = dt * 1e3

    results["compute_above_floor_ms"] = (
        results["single_proof_ms"] - results["dispatch_floor_ms"]
    )
    print(json.dumps({k: round(v, 4) for k, v in results.items()}))


if __name__ == "__main__":
    main()
