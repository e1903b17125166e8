#!/usr/bin/env python
"""Scaling-efficiency benchmark (BASELINE.json config 5 / north-star #3).

Measures verified open proofs/s for the full dp-sharded round trip at 1, 2,
4, ... devices (largest power of two available) with a fixed per-device
batch (weak scaling), and reports efficiency vs linear scaling from the
1-device rate. On the cards of one host this is the scaling measurement
of config 5; on the 8-device virtual CPU mesh (scripts/pytest-cpu
environment) it validates the sharded program and collective layout, not
real bandwidth.

Usage:
  python scripts/scaling_bench.py [--n 512] [--per-device 1024] [--iters 5]

Emits one JSON line per device count plus a summary line:
  {"metric": "dp scaling efficiency", "devices": [...], "proofs_per_s":
   [...], "efficiency": [...]}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ringzk_tpu.utils import compile_cache


def time_step(step, key, xs, iters):
    ok, all_ok = step(key, xs)
    jax.block_until_ready((ok, all_ok))
    t0 = time.perf_counter()
    for _ in range(iters):
        ok, all_ok = step(key, xs)
    jax.block_until_ready((ok, all_ok))
    return (time.perf_counter() - t0) / iters, bool(all_ok)


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--per-device", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--sp", type=int, default=0,
        help="also run the sp (ring-axis) strong-scaling sweep at this N",
    )
    args = ap.parse_args()

    import ringzk_tpu as rz
    from ringzk_tpu.parallel import mesh as pmesh

    params = rz.Params()
    n_deg = args.n
    navail = len(jax.devices())
    counts = []
    c = 1
    while c <= navail:
        counts.append(c)
        c *= 2

    kk, kx, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    ck = rz.keygen(kk, params, n_deg)

    rates = []
    for nd in counts:
        b = args.per_device * nd
        mesh = pmesh.make_mesh(nd)
        x = jax.random.randint(
            kx, (b, params.l, n_deg), -params.q, params.q + 1, dtype=jnp.int32
        )
        xs = pmesh.shard_batch(mesh, x)
        step = pmesh.open_step_fn(mesh, ck, params)
        dt, all_ok = time_step(step, kp, xs, args.iters)
        if not all_ok:
            print(json.dumps({"error": f"verification failed at {nd} devices"}))
            sys.exit(1)
        rate = b / dt
        rates.append(rate)
        print(
            json.dumps(
                {
                    "metric": f"open proofs/s, {nd} device(s), weak scaling",
                    "devices": nd,
                    "batch": b,
                    "value": round(rate, 1),
                    "unit": "proofs/s",
                }
            ),
            flush=True,
        )

    eff = [r / (rates[0] * nd) for r, nd in zip(rates, counts)]
    print(
        json.dumps(
            {
                "metric": "dp scaling efficiency (vs linear from 1 device)",
                "devices": counts,
                "proofs_per_s": [round(r, 1) for r in rates],
                "efficiency": [round(e, 3) for e in eff],
            }
        ),
        flush=True,
    )

    if args.sp:
        # ring-axis (sp) strong scaling: fixed batch, N sharded over 1..D
        # devices through the protocol layer (parallel/protocol_sp.py)
        from ringzk_tpu.parallel import protocol_sp

        n_big = args.sp
        ck2 = rz.keygen(kk, params, n_big)
        b = max(8, args.per_device // 8)
        x2 = jax.random.randint(
            kx, (b, params.l, n_big), -params.q, params.q + 1, dtype=jnp.int32
        )
        sp_rates = []
        sp_counts = [c for c in counts if n_big // c >= 2]
        for nd in sp_counts:
            mesh2 = protocol_sp.make_sp_mesh(1, nd)
            t0 = None
            ok, all_ok = protocol_sp.open_roundtrip_sp(mesh2, kp, ck2, x2, params)
            jax.block_until_ready(ok)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                ok, all_ok = protocol_sp.open_roundtrip_sp(
                    mesh2, kp, ck2, x2, params
                )
            jax.block_until_ready(ok)
            dt = (time.perf_counter() - t0) / args.iters
            if not bool(all_ok):
                print(json.dumps({"error": f"sp verification failed at {nd}"}))
                sys.exit(1)
            sp_rates.append(b / dt)
            print(
                json.dumps(
                    {
                        "metric": f"open proofs/s, N={n_big} sharded over "
                        f"{nd} sp device(s)",
                        "devices": nd,
                        "value": round(b / dt, 1),
                        "unit": "proofs/s",
                    }
                ),
                flush=True,
            )
        print(
            json.dumps(
                {
                    "metric": "sp strong-scaling speedup (vs 1 device)",
                    "devices": sp_counts,
                    "speedup": [round(r / sp_rates[0], 3) for r in sp_rates],
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
