#!/usr/bin/env python
"""Analytic roofline for the open-proof round trip (no device needed).

The per-proof work of the open round trip is STATICALLY countable, so
dividing a measured end-to-end proofs/s through it yields the implied
device throughput for each unit class -- a lower bound on each unit's true
utilization, since the catalog undercounts (layout ops, launch gaps and
XLA bookkeeping are uncounted).

Work classes:
  * int8 matmul MACs -- EXACT: the digit matvecs' matmul shapes
    (ops/conv_mxu.py; [dv*B, kN] @ [kN, KEY_DIGITS*rows*N]).
  * NTT butterflies -- EXACT: transforms x primes x (N/2)log2(N)
    (ops/ntt.py; scalar_mul_add call sites in protocols/open.py).
  * int32 lane-ops -- ESTIMATED: per-pass uint32 op counts for every
    elementwise stage (sampling, digit split/fold, butterfly arithmetic,
    Garner, norms), with the per-element multipliers stated inline.
  * device-memory bytes -- ESTIMATED floor: major arrays in/out per fused
    program, operators amortized over the batch.

Peaks come from PEAKS, keyed by ``jax.devices()[0].device_kind``; a device
that is not in the table is an error.

Usage: python scripts/roofline_model.py --proofs-per-s R
           [--device-kind "NVIDIA H100 80GB HBM3"]
R must be a rate measured on that device.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")

from ringzk_tpu.ops import conv_mxu  # noqa: E402
from ringzk_tpu.params import Params  # noqa: E402

# -- published peaks, by device_kind ------------------------------------------
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        # NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W
        # power limit: 1,979 int8 TOPS on the tensor cores, 3.35 TB/s HBM3.
        "int8_ops": 1979e12,
        "hbm_gbs": 3350.0,
        # Not published as such: half the FP32 lanes (64 of 128 per SM)
        # take int32 ops, at the clock of the 67 TFLOP/s FP32 rate
        # (132 SMs x 128 lanes x 2 ops per FMA) -- approximate.
        "int32_lane_ops": 67e12 / 2 / 2,
        "source": "NVIDIA H100 SXM data sheet (SXM5, 700 W)",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The PEAKS entry for ``device_kind``; unknown devices are an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def primes_needed(bound: int) -> int:
    from ringzk_tpu.ops.ntt import get_ring
    from ringzk_tpu.params import DEFAULT_MODULUS

    return get_ring(512, DEFAULT_MODULUS).primes_needed(bound)


def open_proof_work(params: Params, n_deg: int) -> dict:
    """Static per-proof work of open_proof.roundtrip (B==1)."""
    n, k, l, b = params.n, params.k, params.l, params.b
    rows_a = n + l
    kn = k * n_deg
    sigma = params.standard_deviation(n_deg)
    gbound = 16 * sigma                       # protocols/open.py gaussian_bound
    cb = params.commit_bound(n_deg)
    vb = params.verify_bound(n_deg)
    D = conv_mxu.KEY_DIGITS
    dig = conv_mxu.digits_for_bound

    # ---- int8 matmul MACs (exact): [dv, kN] @ [kN, D*rows*N] per matvec ----
    def matvec_macs(vdig: int, rows: int) -> int:
        return vdig * kn * D * rows * n_deg

    int8 = {
        "commit A.r": matvec_macs(dig(b), rows_a),
        "prover t=a1.y": matvec_macs(dig(gbound), n),
        # the standalone opening-verify A.r is CSE'd with the commit's own
        # since round 5 (honest_r_bound dedupe, protocols/commit.py) --
        # it contributes ZERO extra MACs in the roundtrip program
        "verify a1.z": matvec_macs(dig(vb), n),
    }

    # ---- NTT butterflies (exact) ----
    logn = n_deg.bit_length() - 1
    bfly_per_transform = (n_deg // 2) * logn
    num_resp = primes_needed(min(params.kappa, n_deg) * b)
    num_ver = primes_needed(min(params.kappa, n_deg) * 2**31)
    # scalar_mul_add(d, m, t): fwd_const(d)=1 poly, fwd(m)=rows polys,
    # inv=rows polys, each x num primes
    resp_transforms = (1 + 2 * k) * num_resp       # z = y + d*r  (m rows = k)
    ver_transforms = (1 + 2 * n) * num_ver         # rhs = t + c1*d (m rows = n)
    ntt = {
        "response (num=%d)" % num_resp: resp_transforms * bfly_per_transform,
        "verify rhs (num=%d)" % num_ver: ver_transforms * bfly_per_transform,
    }

    # ---- int32 lane-ops (estimates; multiplier rationale inline) ----
    MONT = 10        # mont_mul, p < 2^31 (ops/montgomery.py: 2 mul_wide + ...)
    MONT_Q = 14      # mont_mul with carry tracking, p >= 2^31 (the q fold)
    RED_I32 = MONT_Q + 4   # reduce_i32_centered: REDC + sign correction
    ADD_C = 10       # zq.add_centered: 2x to_unsigned + add + to_centered
    BFLY_ELT = 15    # per element per stage: partner rolls/selects + shoup(7)
    lanes = {}
    # sampling (PRNG bits + arithmetic)
    lanes["sample r (randint)"] = k * n_deg * 8
    lanes["sample y (normal+round+clip)"] = k * n_deg * 25
    lanes["challenge d (uniform+select+signs)"] = n_deg * 40
    # digit decompositions: ~4 ops per digit per element
    # dig(cb) dropped in round 5: the opening-verify matvec is CSE'd away
    lanes["digit splits"] = kn * 4 * (dig(b) + dig(gbound) + dig(vb))
    # digit folds (round-4 single-REDC form, ops/conv_mxu.py): per
    # shift-group element: int32 plane add (~1) + one mont_mul(q) on the
    # raw two's-complement bits + sign-correction select/sub (~3) +
    # running add (~3)
    def fold_ops(vdig: int, rows: int) -> int:
        groups = vdig + D - 1
        return groups * rows * n_deg * (1 + MONT_Q + 3 + 3)

    lanes["digit folds"] = (
        fold_ops(dig(b), rows_a)
        + fold_ops(dig(gbound), n)
        + fold_ops(dig(vb), n)
    )
    # butterfly arithmetic: N lanes active per stage
    total_transform_elts = (resp_transforms + ver_transforms) * n_deg * logn
    lanes["ntt butterflies"] = total_transform_elts * BFLY_ELT
    # pointwise products + to_mont of d + Garner/centered reduction
    lanes["ntt pointwise+garner"] = (
        num_resp * (n_deg * MONT + kn * MONT + kn * (RED_I32 + 6))
        + num_ver * (n_deg * MONT + n * n_deg * MONT)
        + n * n_deg * (2 * MONT + MONT_Q + 20)   # 2-prime Garner fold
    )
    # centered adds: z=y+dr [k,N]; rhs=t+c1d [n,N]; commit c [n+l,N]; opv rhs
    lanes["centered adds"] = ADD_C * n_deg * (k + n + 2 * rows_a)
    # norms: square (mul_wide 2) + 96-bit limb accumulation (~6) x two passes
    lanes["norm checks (r, z)"] = 2 * kn * 8
    # equality reduces: lhs==rhs over [n,N] + opening [n+l,N]
    lanes["poly_equal"] = (n + rows_a) * n_deg * 2

    # ---- device-memory bytes (floor): fused-program in/out arrays ----
    hbm = 4 * n_deg * (
        l            # x in
        + k          # r (kept for opening verify)
        + k          # y
        + rows_a     # c
        + n          # t
        + k          # z
    ) + kn * (dig(b) + dig(gbound) + dig(vb))  # int8 digit planes

    return {
        "int8_macs": int8,
        "ntt_butterflies": ntt,
        "int32_lane_ops": lanes,
        "hbm_bytes": hbm,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proofs-per-s", type=float, required=True,
                    help="end-to-end open proofs/s measured on the device")
    ap.add_argument("--device-kind", default="NVIDIA H100 80GB HBM3",
                    help="jax device_kind of the device the rate is from")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    peak = peaks_for(args.device_kind)
    params = Params()
    w = open_proof_work(params, args.n)
    macs = sum(w["int8_macs"].values())
    bflies = sum(w["ntt_butterflies"].values())
    lane_ops = sum(w["int32_lane_ops"].values())
    r = args.proofs_per_s

    implied = {
        "int8_ops_per_s": 2 * macs * r,
        "butterflies_per_s": bflies * r,
        "int32_lane_ops_per_s": lane_ops * r,
        "hbm_gbs": w["hbm_bytes"] * r / 1e9,
    }
    fractions = {
        "int8_fraction_of_peak": implied["int8_ops_per_s"] / peak["int8_ops"],
        "int32_fraction_of_peak(approx)":
            implied["int32_lane_ops_per_s"] / peak["int32_lane_ops"],
        "hbm_fraction_of_peak": implied["hbm_gbs"] / peak["hbm_gbs"],
    }

    if args.json:
        print(json.dumps({"device_kind": args.device_kind, "peaks": peak,
                          "work": w, "implied": implied,
                          "fractions": fractions}))
        return

    print(f"Open-proof roundtrip, N={args.n}, defaults {params}")
    print(f"rate: {r:,.0f} proofs/s on {args.device_kind} "
          f"(peaks: {peak['source']})\n")
    print("per-proof work (EXACT):")
    for name, v in w["int8_macs"].items():
        print(f"  int8 {name:24s} {v/1e6:8.2f} M MACs")
    print(f"  int8 {'TOTAL':24s} {macs/1e6:8.2f} M MACs")
    for name, v in w["ntt_butterflies"].items():
        print(f"  NTT  {name:24s} {v:8,d} butterflies")
    print("\nper-proof int32 lane-ops (ESTIMATED, multipliers in source):")
    for name, v in w["int32_lane_ops"].items():
        print(f"  i32  {name:28s} {v/1e3:8.1f} k ops")
    print(f"  i32  {'TOTAL':28s} {lane_ops/1e3:8.1f} k ops")
    print(f"  HBM  array-traffic floor        {w['hbm_bytes']/1e3:8.1f} kB")
    print("\nimplied device throughput at this rate "
          "(= lower bound on each unit's true utilization):")
    print(f"  int8: {implied['int8_ops_per_s']/1e12:6.1f} TOPS = "
          f"{100*fractions['int8_fraction_of_peak']:5.1f}% of peak")
    print(f"  NTT:  {implied['butterflies_per_s']/1e9:6.2f} G butterflies/s")
    print(f"  i32:  {implied['int32_lane_ops_per_s']/1e12:6.2f}e12 ops/s = "
          f"{100*fractions['int32_fraction_of_peak(approx)']:5.1f}% of "
          f"~{peak['int32_lane_ops']/1e12:.1f}e12 (approx peak)")
    print(f"  HBM:  {implied['hbm_gbs']:6.1f} GB/s = "
          f"{100*fractions['hbm_fraction_of_peak']:5.1f}% of "
          f"{peak['hbm_gbs']:.0f} GB/s")
    bound = min(
        peak["int8_ops"] / (2 * macs),
        peak["int32_lane_ops"] / lane_ops,
        peak["hbm_gbs"] * 1e9 / w["hbm_bytes"],
    )
    print(f"\nspeed of light for the counted work alone (binding unit's "
          f"roofline): ~{bound / 1e6:.1f}M proofs/s")


if __name__ == "__main__":
    main()
