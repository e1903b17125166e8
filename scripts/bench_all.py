#!/usr/bin/env python
"""Full benchmark suite: per-phase and per-protocol timings + JSON emitter.

Reproduces the reference's Criterion bench surface
(/root/reference/benches/bench.rs: 4 phases x 3 protocols at N=512, VL=4 for
sum) as batched programs, plus the BASELINE.json measurement configs:

  1. single open proof roundtrip (README example config)
  2. 1024 batched open proofs
  3. linear relation, batch 256, scalar len 2
  4. sum proof, 8 summands, N=1024
  5. (multi-host config runs via parallel.mesh; single-device here)

Emits a github-action-benchmark-style JSON list (the reference CI publishes
Criterion means the same way -- .github/scripts/extract-benchmarks.sh) to
--out, and a human table to stderr. Every row carries the window
min/median/max spread (utils/benchtime.py), and the file-level record
carries the engine fingerprint.
"""

import argparse
import json
import os
import sys

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
    ap.add_argument("--out", default="bench_results.json")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--quick", action="store_true", help="small shapes (CI smoke)")
    args = ap.parse_args()

    import ringzk_tpu as rz
    from ringzk_tpu.protocols import linear, open as open_mod, sum as sum_mod

    params = rz.Params()
    n_deg = 64 if args.quick else 512
    b = 8 if args.quick else args.batch
    results = []

    def record(name, fn, fargs, batch, unit_scale=1e9):
        dt, dts = timed_row(fn, fargs, args.iters)
        per_op_ns = dt / batch * unit_scale
        rec = {
            "name": name,
            "unit": "ns/op",
            "value": round(per_op_ns, 1),
            "extra": f"batch={batch}, N={n_deg}",
            "windows": windows_record(batch, dt, dts),
        }
        results.append(rec)
        print(f"{name:36s} {per_op_ns:14.1f} ns/op  "
              f"({batch / dt:12.1f} op/s)", file=sys.stderr)
        return dt

    kk, kx, kg, kp, kc = jax.random.split(jax.random.PRNGKey(0), 5)
    ck = rz.keygen(kk, params, n_deg)
    x = jax.random.randint(kx, (b, params.l, n_deg), -params.q, params.q + 1,
                           dtype=jnp.int32)
    g = jax.random.randint(kg, (b, n_deg), -params.q, params.q + 1, dtype=jnp.int32)

    # ---- open proof phases (bench.rs:35-109) ----
    commit_f = jax.jit(lambda k, x: open_mod.prover_commit(k, ck, x, params))
    rctx, pcom = commit_f(kp, x)
    record("open_proof_commit", commit_f, (kp, x), b)

    chal_f = jax.jit(lambda k, pc: open_mod.generate_challenge(k, pc, params))
    vctx, chal = chal_f(kc, pcom)
    record("open_proof_generate_challenge", chal_f, (kc, pcom), b)

    resp_f = jax.jit(lambda rc, ch: open_mod.create_response(rc, ch, params))
    resp = resp_f(rctx, chal)
    record("open_proof_create_response", resp_f, (rctx, chal), b)

    verify_f = jax.jit(lambda r, v: open_mod.verify(ck, r, v, params))
    record("open_proof_verify", verify_f, (resp, vctx), b)

    # ---- linear proof phases (bench.rs:113-196) ----
    lb = max(1, b // 4)
    xl, gl = x[:lb], g[:lb]
    lcommit_f = jax.jit(lambda k: linear.prover_commit(k, ck, gl, xl, params))
    lrctx, lpcom = lcommit_f(kp)
    record("linear_proof_commit", lcommit_f, (kp,), lb)

    lchal_f = jax.jit(lambda k, pc: linear.generate_challenge(k, pc, params))
    lvctx, lchal = lchal_f(kc, lpcom)
    record("linear_proof_generate_challenge", lchal_f, (kc, lpcom), lb)

    lresp_f = jax.jit(lambda rc, ch: linear.create_response(rc, ch, params))
    lresp = lresp_f(lrctx, lchal)
    record("linear_proof_create_response", lresp_f, (lrctx, lchal), lb)

    lverify_f = jax.jit(lambda r, v: linear.verify(ck, r, v, params))
    record("linear_proof_verify", lverify_f, (lresp, lvctx), lb)

    # ---- sum proof phases, VL=4 (bench.rs:202-305) ----
    sb = max(1, b // 8)
    vl = 4
    xs = jax.random.randint(kx, (sb, vl, params.l, n_deg), -params.q, params.q + 1,
                            dtype=jnp.int32)
    gs = jax.random.randint(kg, (sb, vl, n_deg), -params.q, params.q + 1,
                            dtype=jnp.int32)
    scommit_f = jax.jit(lambda k: sum_mod.prover_commit(k, ck, gs, xs, params))
    srctx, spcom = scommit_f(kp)
    record("sum_proof_commit", scommit_f, (kp,), sb)

    schal_f = jax.jit(lambda k, pc: sum_mod.generate_challenge(k, pc, params))
    svctx, schal = schal_f(kc, spcom)
    record("sum_proof_generate_challenge", schal_f, (kc, spcom), sb)

    sresp_f = jax.jit(lambda rc, ch: sum_mod.create_response(rc, ch, params))
    sresp = sresp_f(srctx, schal)
    record("sum_proof_create_response", sresp_f, (srctx, schal), sb)

    sverify_f = jax.jit(lambda r, v: sum_mod.verify(ck, r, v, params))
    record("sum_proof_verify", sverify_f, (sresp, svctx), sb)

    # ---- end-to-end throughput (the headline) ----
    rt = jax.jit(lambda k, x: open_mod.roundtrip(k, ck, x, params))
    dt = record("open_proof_full_roundtrip", rt, (kp, x), b)
    # Human throughput line only (stderr): the JSON stays uniformly
    # smaller-is-better ns/op so github-action-benchmark's customSmallerIsBetter
    # regression alerting is meaningful for every entry.
    print(f"{'open_proofs_per_second':36s} {b / dt:14.1f} proofs/s", file=sys.stderr)

    payload = {"engine": engine_fingerprint(), "rows": results}
    with open(args.out, "w") as f:
        # github-action-benchmark consumes the bare list; the sibling
        # .meta.json carries the engine fingerprint and window spreads
        json.dump(results, f, indent=1)
    with open(args.out + ".meta.json", "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out} (+.meta.json)", file=sys.stderr)


if __name__ == "__main__":
    main()
