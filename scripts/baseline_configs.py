#!/usr/bin/env python
"""Measure the five BASELINE.json measurement configs (see BASELINE.md).

  1. single opening proof, Params::default, N=512, message [1,2,3,4]
     (the reference README example, /root/reference/README.md:32-55)
  2. 1024 batched opening proofs, N=512
  3. linear relation, N=512, batch 256, scalar length 2
  4. sum proof, 8 commitments (VL=8), N=1024
  5. 64K opening proofs with psum batch-verify (host-sharded runner;
     degenerate single-host form when only one process exists)

Emits one JSON line per config, each with the window min/median/max
spread (utils/benchtime.py) and the engine fingerprint on the first line.
"""

import argparse
import json
import sys

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ringzk_tpu.utils import compile_cache
from ringzk_tpu.utils.benchtime import (
    engine_fingerprint,
    timed_row,
    windows_record,
)


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--skip-config5", action="store_true")
    args = ap.parse_args()

    import ringzk_tpu as rz
    from ringzk_tpu.protocols import linear, open as open_mod, sum as sum_mod

    params = rz.Params()
    kk, kp = jax.random.split(jax.random.PRNGKey(0))
    ck512 = rz.keygen(kk, params, 512)

    configs = []

    def measure(name, fn, fargs, batch):
        dt, dts = timed_row(fn, fargs, args.iters)
        rec = {
            "config": name,
            "seconds_per_batch": round(dt, 6),
            "proofs_per_s": round(batch / dt, 1),
            "batch": batch,
            "windows": windows_record(batch, dt, dts),
        }
        configs.append(rec)

    # config 1: single proof, message [1,2,3,4]
    x1 = rz.prepare_value(params, [[[1, 2, 3, 4]]], 512)  # [1, l, N]
    f1 = jax.jit(lambda k: open_mod.roundtrip(k, ck512, x1, params))
    measure("1_single_open_N512", f1, (kp,), 1)

    # config 2: 1024 batched opening proofs
    x2 = jax.random.randint(
        jax.random.PRNGKey(1), (1024, params.l, 512), -params.q, params.q + 1,
        dtype=jnp.int32,
    )
    f2 = jax.jit(lambda k: open_mod.roundtrip(k, ck512, x2, params))
    measure("2_batched_open_1024_N512", f2, (kp,), 1024)

    # config 3: linear, batch 256, scalar length 2
    g3 = rz.prepare_scalar(params, [[3, 5]] * 256, 512)  # [256, N], 2 coeffs
    x3 = jax.random.randint(
        jax.random.PRNGKey(2), (256, params.l, 512), -params.q, params.q + 1,
        dtype=jnp.int32,
    )
    f3 = jax.jit(lambda k: linear.roundtrip(k, ck512, g3, x3, params))
    measure("3_linear_256_N512_slen2", f3, (kp,), 256)

    # config 4: sum with 8 commitments at N=1024
    ck1024 = rz.keygen(jax.random.PRNGKey(3), params, 1024)
    gs4 = jax.random.randint(
        jax.random.PRNGKey(4), (32, 8, 1024), -params.q, params.q + 1,
        dtype=jnp.int32,
    )
    xs4 = jax.random.randint(
        jax.random.PRNGKey(5), (32, 8, params.l, 1024), -params.q, params.q + 1,
        dtype=jnp.int32,
    )
    f4 = jax.jit(lambda k: sum_mod.roundtrip(k, ck1024, gs4, xs4, params))
    measure("4_sum_VL8_N1024_batch32", f4, (kp,), 32)

    # config 5: 64K proofs, host-sharded psum batch-verify
    cfg5 = None
    if not args.skip_config5:
        from ringzk_tpu.parallel import multihost

        out = multihost.batch_verify_run(
            total_batch=65536, n_deg=512, iters=max(1, args.iters // 2)
        )
        cfg5 = {"config": "5_multihost_64k_N512", **out}

    fp = engine_fingerprint()
    for i, rec in enumerate(configs):
        if i == 0:
            rec["engine"] = fp
        print(json.dumps(rec), flush=True)
    if cfg5 is not None:
        print(json.dumps(cfg5), flush=True)


if __name__ == "__main__":
    main()
