"""Headline benchmark: verified proofs per second, N=512, one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "proofs/s", "vs_baseline": N,
   "windows": {"min": ..., "median": ..., "max": ...}, "engine": {...}}

vs_baseline is measured against the original brief's target of 1e5
verified opening proofs/s per host at N=512 (BASELINE.json).

The extra fields come from utils/benchtime.py, the shared timing module of
every timing entry point:
  windows       per-window proofs/s spread of the median-of-5 timing;
  engine        the active RINGZK_* flag fingerprint, PRNG impl, device,
                device count and the card's name and power limit, so a
                flag-default regression is visible in the record.

Each open "proof" is the complete 3-move sigma protocol plus the standalone
opening verification: commit (incl. key-less message prep), t = a1.y,
challenge, z = y + d*r, norm check and a1.z == t + c1.d, plus
Commitment::verify -- i.e. strictly more work than any single Criterion
phase bench in the reference (/root/reference/benches/bench.rs).
--protocol linear|sum benches the other two protocols' full roundtrips the
same way (VL=4 summands for sum, the reference bench's config).

Usage: python bench.py [--protocol open|linear|sum] [--batch B] [--n N]
                       [--iters I] [--full] [--modulus Q]
  --full additionally prints the per-phase table for the selected protocol
         (reference Criterion-group parity) to stderr.
  --modulus selects a non-default ring modulus (an odd q' < 2^63; >= 2^32
         engages the wide int64 ring and requires JAX_ENABLE_X64=1).
"""

import argparse
import json
import os
import sys

# Throughput mode: the RngBitGenerator PRNG (rbg). The library default
# stays threefry (JAX's standard, key-stable across versions; fresh_key
# pins it for key material -- rng.py policy). Whether rbg is faster on the
# GPU has not been measured.
os.environ.setdefault("JAX_DEFAULT_PRNG_IMPL", "rbg")

import jax
import jax.numpy as jnp

from ringzk_tpu.utils import compile_cache
from ringzk_tpu.utils.benchtime import (
    engine_fingerprint,
    timed_row,
    windows_record,
)

SUM_VL = 4  # reference bench's summand count (/root/reference/benches/bench.rs:200)


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", choices=("open", "linear", "sum"), default="open")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--full", action="store_true")
    ap.add_argument(
        "--modulus",
        type=int,
        default=None,
        help="ring modulus q' (default: the reference's 3515337053). Any "
        "odd value < 2^63; >= 2^32 runs the wide int64 ring (ops/mont64) "
        "and needs JAX_ENABLE_X64=1 in the environment.",
    )
    ap.add_argument(
        "--chains",
        type=int,
        default=None,
        help="split the batch into C independent roundtrip chains inside "
        "one jit (any protocol): the chains share no data, so XLA can "
        "overlap one chain's matvec phases with another's transform phases "
        "across the protocol's sequential dependency walls. Same total "
        "work and per-proof semantics; each chain draws its own key. "
        "Default 32 (open) / 12 (linear) / 24 (sum), ~4096 proofs per "
        "chain, chosen on the previous accelerator and not yet re-scanned "
        "on the GPU. --chains 1 restores the single chain.",
    )
    args = ap.parse_args()
    if args.chains is None:
        # per-protocol chain defaults (see --chains help)
        args.chains = {"open": 32, "linear": 12, "sum": 24}[args.protocol]
        if args.batch is not None:
            args.chains = max(
                c for c in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
                if args.batch % c == 0 and c <= args.chains
            )

    from ringzk_tpu import Params, keygen
    from ringzk_tpu.protocols import linear as linear_mod
    from ringzk_tpu.protocols import open as open_mod
    from ringzk_tpu.protocols import sum as sum_mod

    if args.modulus is None:
        params = Params()
    else:
        params = Params(q=args.modulus // 2, modulus=args.modulus)
        if params.modulus >= 2**32 and not jax.config.jax_enable_x64:
            print(
                json.dumps({"error": "wide modulus needs JAX_ENABLE_X64=1"})
            )
            sys.exit(1)
    dtype = jnp.int64 if params.modulus >= 2**32 else jnp.int32
    n_deg = args.n
    # per-protocol default batches: ~4096 proofs per chain at each
    # protocol's default chain count (see --chains help)
    b = args.batch or {"open": 131072, "linear": 49152, "sum": 24576}[args.protocol]
    kk, kx, kg, kp = jax.random.split(jax.random.PRNGKey(0), 4)
    ck = keygen(kk, params, n_deg)

    def rand_poly(key, shape):
        return jax.random.randint(
            key, shape, -params.q, params.q + 1, dtype=dtype
        )

    mod_sfx = f", q'={params.modulus}" if args.modulus is not None else ""
    if args.protocol == "open":
        c = args.chains
        x = rand_poly(kx, (b, params.l, n_deg))
        step = jax.jit(
            lambda k, x: open_mod.roundtrip(k, ck, x, params, chains=c)
        )
        fargs = (kp, x)
        suffix = (f", chains={c}" if c > 1 else "") + mod_sfx
        label = f"verified open proofs/s per device (N={n_deg}, batch={b}{suffix})"
    elif args.protocol == "linear":
        c = args.chains
        x = rand_poly(kx, (b, params.l, n_deg))
        g = rand_poly(kg, (b, n_deg))
        step = jax.jit(
            lambda k, g, x: linear_mod.roundtrip(k, ck, g, x, params, chains=c)
        )
        fargs = (kp, g, x)
        suffix = (f", chains={c}" if c > 1 else "") + mod_sfx
        label = f"verified linear proofs/s per device (N={n_deg}, batch={b}{suffix})"
    else:
        c = args.chains
        xs = rand_poly(kx, (b, SUM_VL, params.l, n_deg))
        gs = rand_poly(kg, (b, SUM_VL, n_deg))
        step = jax.jit(
            lambda k, gs, xs: sum_mod.roundtrip(k, ck, gs, xs, params, chains=c)
        )
        fargs = (kp, gs, xs)
        suffix = (f", chains={c}" if c > 1 else "") + mod_sfx
        label = (
            f"verified sum proofs/s per device (N={n_deg}, VL={SUM_VL}, "
            f"batch={b}{suffix})"
        )

    dt, window_dts = timed_row(step, fargs, args.iters)
    ok, op_ok = step(*fargs)
    if not (bool(ok.all()) and bool(op_ok.all())):
        print(json.dumps({"error": "verification failed"}))
        sys.exit(1)

    proofs_per_s = b / dt
    target = 1e5  # north-star: >= 1e5 verified open proofs/s per host, N=512

    # per-phase Criterion-parity table + the NTT throughput row
    phase_rows = []
    if args.full:
        phase_rows = _phase_rows(
            args.protocol, params, ck, fargs, kp, n_deg, b, args.iters
        )
        if args.protocol == "open":
            _ntt_roofline(params, n_deg, b, args.iters)

    for rec in phase_rows:
        print(
            f"{rec['name']:34s} {rec['ns_per_op']:12.1f} ns/proof "
            f"({rec['windows']['median']:12.1f} proofs/s, "
            f"spread {rec['windows']['min']:.0f}-{rec['windows']['max']:.0f})",
            file=sys.stderr,
        )

    print(
        json.dumps(
            {
                "metric": label,
                "value": round(proofs_per_s, 1),
                "unit": "proofs/s",
                "vs_baseline": round(proofs_per_s / target, 3),
                "windows": windows_record(b, dt, window_dts),
                "engine": engine_fingerprint(),
            }
        )
    )


def _phase_rows(protocol, params, ck, fargs, key, n_deg, b, iters):
    """Per-phase timings mirroring the reference's Criterion groups
    (/root/reference/benches/bench.rs:35-305): commit / generate_challenge /
    create_response / verify for the selected protocol. The four phases
    share one signature shape across protocols (prover_commit takes the
    protocol's public inputs, the other three take the prior phase's
    pytrees), so one generic helper covers all three. Returns the
    per-phase records."""
    from ringzk_tpu.protocols import linear as linear_mod
    from ringzk_tpu.protocols import open as open_mod
    from ringzk_tpu.protocols import sum as sum_mod

    mod = {"open": open_mod, "linear": linear_mod, "sum": sum_mod}[protocol]
    inputs = fargs[1:]  # the protocol's public inputs (x / g,x / gs,xs)
    k1, k2 = jax.random.split(key)

    commit_f = jax.jit(lambda k, *a: mod.prover_commit(k, ck, *a, params))
    rctx, pcom = commit_f(k1, *inputs)
    chal_f = jax.jit(lambda k, pc: mod.generate_challenge(k, pc, params))
    vctx, chal = chal_f(k2, pcom)
    resp_f = jax.jit(lambda rc, ch: mod.create_response(rc, ch, params))
    resp = resp_f(rctx, chal)
    verify_f = jax.jit(lambda r, v: mod.verify(ck, r, v, params))
    rows = [
        (f"{protocol}_proof_commit", commit_f, (k1,) + inputs),
        (f"{protocol}_proof_generate_challenge", chal_f, (k2, pcom)),
        (f"{protocol}_proof_create_response", resp_f, (rctx, chal)),
        (f"{protocol}_proof_verify", verify_f, (resp, vctx)),
    ]

    out = []
    for name, fn, a in rows:
        dt, dts = timed_row(fn, a, iters)
        rec = {
            "name": name,
            "ns_per_op": dt / b * 1e9,
            "windows": windows_record(b, dt, dts),
        }
        out.append(rec)
    return out


def _ntt_roofline(params, n_deg, b, iters):
    """NTT throughput report: butterflies/s, ns/transform and the
    effective device-memory bandwidth of the forward transform (one int32
    read + NUM_PRIMES uint32 writes per transform, the fused kernel's
    traffic)."""
    from ringzk_tpu.ops.ntt import get_ring

    ring = get_ring(n_deg, params.modulus)
    num_primes = ring.num_primes
    polys = b * params.k
    x = jax.random.randint(
        jax.random.PRNGKey(2), (polys, n_deg), -params.q, params.q + 1,
        ring.dtype,
    )
    fwd_f = jax.jit(lambda v: ring.fwd(v))
    dt, _ = timed_row(fwd_f, (x,), iters)
    logn = n_deg.bit_length() - 1
    bflies = polys * num_primes * (n_deg // 2) * logn
    rate = bflies / dt
    gbps = x.size * 4 * (1 + num_primes) / dt / 1e9
    print(
        f"{'ntt_fwd_butterflies/s':34s} {rate:12.3e} "
        f"({dt / polys * 1e9:8.1f} ns/transform, {gbps:7.1f} GB/s effective)",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
