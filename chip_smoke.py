#!/usr/bin/env python3
"""End-to-end proof that the library runs on a GPU, at full width.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the dp and sp paths only

One process drives the card(s). Each phase prints its own lines and raises
on any wrong result, so a failed phase ends the run with a non-zero exit
code; the last line of a passing run is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

The script refuses to run anywhere but on a GPU (exit 2, no result line).
Every rate it prints is labelled with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reports
them. The PRNG is the library default (threefry).

One card:
  1. device      platform, device kind and count, JAX version, card, cache;
  2. arithmetic  N=512 default modulus, bit-exact: polymul on 65,536 pairs
                 (a 256-row sample against the numpy schoolbook), the digit
                 matvec against the NTT-pointwise matvec (whole batch) and
                 the schoolbook (sample), the fused NTT kernel against the
                 XLA stage chain (whole batch);
  3. protocols   keygen, then the open (131,072 proofs), linear (49,152)
                 and sum (VL=4, 24,576) round trips, forged and
                 norm-violating responses, the README quick start; proofs/s
                 from the host clock after warm-up, compile seconds, peak
                 device memory;
  4. wide ring   the open round trip at q' = 2^33 + 9 (16,384 proofs, x64);
  5. transcripts the N=16 golden transcript digests (tests/golden);
  6. chip tests  the tests marked ``chip``, in this process.

Four cards:
  dp  the dp-sharded open round trip over 4 x 131,072 proofs and the
      config-5 batch-verify runner; a forged proof in one shard is rejected
      there only; rate per card against one card (same engine: the sharded
      programs trace the XLA chain) in the same process;
  sp  N=8192: polymul_sp on a 1 x 4 (dp, sp) mesh bit-equal to the one-card
      polymul, and the sp-sharded open round trip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# batch sizes of the full-width phases (bench.py's per-protocol batches)
OPEN_BATCH = 131072
LINEAR_BATCH = 49152
SUM_BATCH = 24576
SUM_VL = 4
ARITH_BATCH = 65536
SAMPLE_ROWS = 256
WIDE_BATCH = 16384
WIDE_MODULUS = 2**33 + 9
CHAINS = 1  # the library default of protocols.*.roundtrip
SP_N = 8192

CARD = "unknown card"  # set by main() from nvidia-smi


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(what)


def _timed(fn, args, reps: int = 5) -> float:
    """Median host seconds of ``fn(*args)`` to block_until_ready, after
    one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _compile(fn, args):
    """(compiled, seconds): ahead-of-time compile of a jitted fn."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _rate(phase: str, what: str, n: int, dt: float) -> None:
    log(phase, f"{what}: {n / dt:.1f} proofs/s ({dt * 1e3:.3f} ms per batch "
               f"of {n}) on {CARD}")


def schoolbook_matvec(a, v, q):
    """(A . v) mod q, centered, with the numpy schoolbook golden model:
    a [rows, k, N], v [B, k, N] -> [B, rows, N] int64."""
    import numpy as np

    from ringzk_tpu.ops.ntt import negacyclic_schoolbook

    a = np.asarray(a, np.int64)
    v = np.asarray(v, np.int64)
    out = np.zeros((v.shape[0], a.shape[0], a.shape[-1]), dtype=object)
    for row in range(a.shape[0]):
        for t in range(a.shape[1]):
            out[:, row] += negacyclic_schoolbook(a[row, t][None], v[:, t], q)
    out %= q
    return np.where(out > q // 2, out - q, out).astype(np.int64)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from ringzk_tpu.utils import compile_cache

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    log("device", f"platform={info['platform']} kind={info['kind']} "
                  f"count={info['count']} jax={jax.__version__}")
    log("device", f"card: {CARD}")
    log("device", f"compile cache: {compile_cache.enable()}")
    return info


def phase_arith(n: int = 512, batch: int = ARITH_BATCH,
                sample: int = SAMPLE_ROWS, kernel_interpret: bool = False):
    """Bit-exact arithmetic against the plain references (tolerance 0)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ringzk_tpu import Params, keygen
    from ringzk_tpu.ops import conv_mxu, mat, ntt, ntt_kernel

    params = Params()
    q = params.modulus
    ring = ntt.get_ring(n, q)
    ka, kb, kv = jax.random.split(jax.random.PRNGKey(11), 3)
    a = jax.random.randint(ka, (batch, n), -(q // 2), q // 2 + 1, jnp.int32)
    b = jax.random.randint(kb, (batch, n), -(q // 2), q // 2 + 1, jnp.int32)

    prod = jax.jit(ring.polymul)(a, b)
    got = np.asarray(prod[:sample])
    want = ntt.negacyclic_schoolbook(np.asarray(a[:sample]),
                                     np.asarray(b[:sample]), q)
    check(np.array_equal(got, want), "polymul != schoolbook")
    log("arith", f"polymul N={n} on {batch} pairs: {sample}-row sample "
                 "equals the numpy schoolbook")

    ck = keygen(jax.random.PRNGKey(12), params, n)
    bound = params.verify_bound(n)
    ndig = conv_mxu.digits_for_bound(bound)
    v = jax.random.randint(kv, (batch, params.k, n), -bound, bound + 1,
                           jnp.int32)
    rows = params.n + params.l
    a_full = jnp.concatenate([ck.a1, ck.a2], axis=0)

    def digit(v):
        return jnp.concatenate([
            conv_mxu.matvec_digits(ring, ck.a1_dig, params.n, v, ndig),
            conv_mxu.matvec_digits(ring, ck.a2_dig, params.l, v, ndig),
        ], axis=-2)

    def pointwise(v):
        return mat.matvec(ring, ck.a_hat(), ring.fwd(v))

    got_d = jax.jit(digit)(v)
    got_p = jax.jit(pointwise)(v)
    check(got_d.shape == (batch, rows, n), f"matvec shape {got_d.shape}")
    check(jnp.array_equal(got_d, got_p), "digit matvec != NTT matvec")
    want_s = schoolbook_matvec(a_full, v[:sample], q)
    check(np.array_equal(np.asarray(got_d[:sample]), want_s),
          "digit matvec != schoolbook")
    log("arith", f"digit matvec ({ndig} digits) == NTT-pointwise matvec on "
                 f"{batch} vectors, == schoolbook on {sample}")

    def chain(x):
        with ntt.xla_transforms():
            xh = ring.fwd(x)
            return xh, ring.inv(ring.dot_hat(ring.fwd_const(x), xh))

    want_h, want_sq = jax.jit(chain)(a)
    fk = jax.jit(lambda x: ntt_kernel.fwd(ring, x, ring.num_primes,
                                          interpret=kernel_interpret))
    ik = jax.jit(lambda h: ntt_kernel.inv(ring, h,
                                          interpret=kernel_interpret))
    sq_hat = jax.jit(lambda x, h: ring.dot_hat(ring.fwd_const(x), h))(a, want_h)
    if not kernel_interpret:
        for name, fn, arg in (("fwd", fk, a), ("inv", ik, sq_hat)):
            compiled, secs = _compile(fn, (arg,))
            log("arith", f"ntt_kernel.{name} compiled in {secs:.1f} s: "
                         f"{compiled.memory_analysis()}")
    check(jnp.array_equal(fk(a), want_h), "kernel fwd != XLA chain")
    check(jnp.array_equal(ik(sq_hat), want_sq), "kernel inv != XLA chain")
    log("arith", f"fused NTT kernel fwd/inv == XLA stage chain on {batch} "
                 "polynomials x 3 primes")


def phase_protocols(n: int = 512, open_batch: int = OPEN_BATCH,
                    linear_batch: int = LINEAR_BATCH,
                    sum_batch: int = SUM_BATCH, vl: int = SUM_VL,
                    probe_batch: int = 1024, reps: int = 5,
                    quick_n: int = 512):
    """keygen + the three round trips at full width, negative probes, the
    README quick start."""
    import jax
    import jax.numpy as jnp

    import ringzk_tpu as rz
    from ringzk_tpu.protocols import linear, open as open_mod, sum as sum_mod

    params = rz.Params()
    q = params.q
    t0 = time.perf_counter()
    ck = jax.block_until_ready(rz.keygen(jax.random.PRNGKey(0), params, n))
    log("protocols", f"keygen N={n} default Params: "
                     f"{time.perf_counter() - t0:.1f} s (incl. compile)")
    kx, kg, kp = jax.random.split(jax.random.PRNGKey(1), 3)

    def rand(key, shape):
        return jax.random.randint(key, shape, -q, q + 1, jnp.int32)

    cases = [
        ("open", open_batch,
         lambda k, x: open_mod.roundtrip(k, ck, x, params, chains=CHAINS),
         (rand(kx, (open_batch, params.l, n)),)),
        ("linear", linear_batch,
         lambda k, g, x: linear.roundtrip(k, ck, g, x, params, chains=CHAINS),
         (rand(kg, (linear_batch, n)),
          rand(kx, (linear_batch, params.l, n)))),
        (f"sum VL={vl}", sum_batch,
         lambda k, gs, xs: sum_mod.roundtrip(k, ck, gs, xs, params,
                                             chains=CHAINS),
         (rand(kg, (sum_batch, vl, n)),
          rand(kx, (sum_batch, vl, params.l, n)))),
    ]
    for name, batch, fn, data in cases:
        args = (kp,) + data
        compiled, secs = _compile(jax.jit(fn), args)
        ok, op_ok = compiled(*args)
        check(jnp.all(ok) & jnp.all(op_ok), f"{name}: a verdict is false")
        dt = _timed(compiled, args, reps)
        log("protocols", f"{name} round trip N={n} batch={batch} "
                         f"chains={CHAINS}: compile {secs:.1f} s (set-up), "
                         f"every verdict true, peak device memory "
                         f"{_peak_bytes()} bytes")
        _rate("protocols", f"{name} round trip", batch, dt)
        del compiled, data, args

    # negative probes: an honest, a forged and a norm-violating response
    x = rand(kx, (probe_batch, params.l, n))

    def probes(k, x):
        k1, k2 = jax.random.split(k)
        rctx, pcom = open_mod.prover_commit(k1, ck, x, params)
        vctx, chal = open_mod.generate_challenge(k2, pcom, params)
        resp = open_mod.create_response(rctx, chal, params)
        forged = resp._replace(z=resp.z.at[..., 0, 0].add(1))
        big = resp._replace(
            z=resp.z.at[..., 0, 0].set(params.verify_bound(n) + 1))
        return tuple(open_mod.verify(ck, r, vctx, params)
                     for r in (resp, forged, big))

    honest, forged, big = jax.jit(probes)(kp, x)
    check(jnp.all(honest), "honest responses rejected")
    check(~jnp.any(forged), "a forged z was accepted")
    check(~jnp.any(big), "a norm-violating z was accepted")
    log("protocols", f"{probe_batch} honest responses accepted; forged z and "
                     "norm-violating z rejected in every proof")

    # README quick start, through the object API
    kk, kp1, kc = jax.random.split(jax.random.PRNGKey(0), 3)
    ck1 = rz.generate_commitment_key(kk, params, quick_n)
    xv = rz.prepare_value(params, [[1, 2, 3, 4]], quick_n)
    opening, com = rz.commit(kp1, ck1, xv, params)
    check(rz.verify(ck1, com, opening, params), "quick start: commit verify")
    prover = rz.OpenProofProver(ck1, params)
    verifier = rz.OpenProofVerifier(ck1, params)
    response_ctx, commitment = prover.commit(kp1, xv)
    verification_ctx, challenge = verifier.generate_challenge(kc, commitment)
    response = prover.create_response(response_ctx, challenge)
    check(verifier.verify(response, verification_ctx), "quick start: proof")
    log("protocols", f"README quick start (object API, N={quick_n}) verifies")


def phase_wide(n: int = 512, batch: int = WIDE_BATCH, reps: int = 3):
    """The open round trip on the wide ring q' = 2^33 + 9 under x64."""
    import jax
    import jax.numpy as jnp

    from ringzk_tpu import Params, keygen
    from ringzk_tpu.protocols import open as open_mod

    params = Params(q=WIDE_MODULUS // 2, modulus=WIDE_MODULUS)
    with jax.enable_x64(True):
        ck = keygen(jax.random.PRNGKey(80), params, n)
        kx, kp = jax.random.split(jax.random.PRNGKey(81))
        x = jax.random.randint(kx, (batch, params.l, n), -params.q,
                               params.q + 1, jnp.int64)
        fn = jax.jit(lambda k, x: open_mod.roundtrip(k, ck, x, params))
        compiled, secs = _compile(fn, (kp, x))
        ok, op_ok = compiled(kp, x)
        check(jnp.all(ok) & jnp.all(op_ok), "wide ring: a verdict is false")
        dt = _timed(compiled, (kp, x), reps)
    log("wide", f"open round trip q'={WIDE_MODULUS} N={n} batch={batch}: "
                f"compile {secs:.1f} s (set-up), every verdict true, peak "
                f"device memory {_peak_bytes()} bytes")
    _rate("wide", "wide-ring open round trip", batch, dt)


# Digests that differ from the CPU-made goldens on this card, by set; the
# README's platform claim names them.
PLATFORM_DEPENDENT: dict = {}


def phase_transcripts() -> dict:
    """Rebuild the golden transcript digests and compare them; returns
    {set: [differing digest names]}."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_golden

    with open(test_golden.GOLDEN_PATH) as f:
        golden = json.load(f)
    diffs = {}
    for name, params in sorted(test_golden.GOLDEN_SETS.items()):
        got = test_golden.build_transcript(params)
        bad = sorted(k for k in golden[name] if got[k] != golden[name][k])
        diffs[name] = bad
        log("transcripts", f"{name}: " + (
            "all 4 digests equal the goldens" if not bad
            else f"differ from the goldens: {bad}"))
        check(set(bad) <= set(PLATFORM_DEPENDENT.get(name, ())),
              f"transcript {name}: unexpected digest drift {bad}")
    return diffs


def phase_chip_tests() -> None:
    """The chip-marked tests, in this process (one process per card)."""
    import pytest

    os.environ["RINGZK_CHIP_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    check(rc == 0, f"chip-marked tests failed (pytest exit {int(rc)})")
    log("chip tests", "every chip-marked test passed")


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def phase_dp(cards: int, per_card: int = OPEN_BATCH, reps: int = 3,
             forge_per_card: int = 1024, cfg5_batch: int = 65536):
    """dp mesh: sharded open round trip, a forgery in one shard, the
    config-5 runner, and the per-card rate against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import ringzk_tpu as rz
    from ringzk_tpu.ops import ntt
    from ringzk_tpu.parallel import mesh as pmesh
    from ringzk_tpu.parallel import multihost
    from ringzk_tpu.protocols import open as open_mod

    params = rz.Params()
    n = 512
    mesh = pmesh.make_mesh(cards)
    ck = rz.keygen(jax.random.PRNGKey(0), params, n)
    kx, kp = jax.random.split(jax.random.PRNGKey(1))
    total = cards * per_card
    x = jax.random.randint(kx, (total, params.l, n), -params.q, params.q + 1,
                           jnp.int32)

    ok, all_ok = pmesh.batched_open_prove_verify(mesh, kp, ck, x, params)
    check(ok.shape == (total,) and jnp.all(ok) and all_ok,
          "dp: a verdict is false")
    check(len(ok.sharding.device_set) == cards, "dp: verdicts not sharded")
    step = pmesh.open_step_fn(mesh, ck, params)
    xs = pmesh.shard_batch(mesh, x)
    dt_dp = _timed(step, (kp, xs), reps)
    log("dp", f"sharded open round trip, {cards} cards x {per_card} proofs: "
              "every verdict true")
    _rate("dp", f"dp open round trip on {cards} cards", total, dt_dp)
    del xs, x

    # a forged proof in one shard is rejected there only
    xf = jax.random.randint(kx, (cards * forge_per_card, params.l, n),
                            -params.q, params.q + 1, jnp.int32)
    xf = pmesh.shard_batch(mesh, xf)
    shard = NamedSharding(mesh, P("dp"))
    bad = 2 * forge_per_card + 5  # inside shard 2

    def forge_and_verify(k, x):
        with ntt.xla_transforms():
            k1, k2 = jax.random.split(k)
            rctx, pcom = open_mod.prover_commit(k1, ck, x, params)
            vctx, chal = open_mod.generate_challenge(k2, pcom, params)
            resp = open_mod.create_response(rctx, chal, params)
            resp = resp._replace(z=resp.z.at[bad, 0, 0].add(1))
            return open_mod.verify(ck, resp, vctx, params)

    okf = jax.jit(forge_and_verify, out_shardings=shard)(kp, xf)
    okf = np.asarray(okf)
    check(not okf[bad] and okf.sum() == okf.size - 1,
          "dp: the forgery was not rejected in its shard only")
    log("dp", f"forged proof {bad} (shard {bad // forge_per_card}) rejected; "
              f"the other {okf.size - 1} accepted")

    out = multihost.batch_verify_run(total_batch=cfg5_batch, n_deg=n,
                                     iters=reps, mesh=mesh, chains=1)
    check(out["all_ok"], "config-5 batch verify failed")
    log("dp", f"multihost.batch_verify_run: {cfg5_batch} proofs on "
              f"{out['n_devices']} cards, chains=1, all_ok")
    _rate("dp", "config-5 batch verify", cfg5_batch,
          out["seconds_per_batch"])

    # one card, same process, device 0, the engine the sharded program
    # runs (the XLA chain): the like-for-like scaling baseline
    x1 = jax.random.randint(kx, (per_card, params.l, n), -params.q,
                            params.q + 1, jnp.int32)

    def one_card(k, x):
        with ntt.xla_transforms():
            return open_mod.roundtrip(k, ck, x, params)

    one = jax.jit(one_card)
    ok1, op1 = one(kp, x1)
    check(jnp.all(ok1) & jnp.all(op1), "one card: a verdict is false")
    dt1 = _timed(one, (kp, x1), reps)
    _rate("dp", "one card (device 0, XLA chain)", per_card, dt1)
    per_card_rate = total / dt_dp / cards
    log("dp", f"scaling efficiency: {per_card_rate * dt1 / per_card:.4f} "
              f"({per_card_rate:.1f} proofs/s per card against "
              f"{per_card / dt1:.1f} on one card) on {CARD}")


def phase_sp(cards: int, n: int = SP_N, polys: int = 64, batch: int = 8):
    """sp mesh at N=8192: polymul_sp bit-equal to one-card polymul, and the
    sp-sharded open round trip."""
    import jax
    import jax.numpy as jnp

    import ringzk_tpu as rz
    from ringzk_tpu.ops import ntt
    from ringzk_tpu.parallel import ntt_sp, protocol_sp

    params = rz.Params()
    q = params.modulus
    mesh = protocol_sp.make_sp_mesh(1, cards)
    ka, kb = jax.random.split(jax.random.PRNGKey(2))
    a = jax.random.randint(ka, (polys, n), -(q // 2), q // 2 + 1, jnp.int32)
    b = jax.random.randint(kb, (polys, n), -(q // 2), q // 2 + 1, jnp.int32)
    got = ntt_sp.polymul_sp(mesh, a, b, n, q)
    want = jax.jit(ntt.get_ring(n, q).polymul)(a, b)
    check(jnp.array_equal(got, want), "sp: polymul_sp != one-card polymul")
    log("sp", f"polymul_sp N={n} on a 1x{cards} (dp, sp) mesh == one-card "
              f"polymul on {polys} pairs")

    ck = rz.keygen(jax.random.PRNGKey(3), params, n)
    kx, kp = jax.random.split(jax.random.PRNGKey(4))
    x = jax.random.randint(kx, (batch, params.l, n), -params.q, params.q + 1,
                           jnp.int32)
    ok, all_ok = protocol_sp.open_roundtrip_sp(mesh, kp, ck, x, params)
    check(jnp.all(ok) & all_ok, "sp: a verdict is false")
    log("sp", f"sp-sharded open round trip N={n} batch={batch}: every "
              "verdict true")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the dp and sp paths on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{devs[0].platform}", file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but {len(devs)} GPU(s)",
              file=sys.stderr)
        return 2

    from ringzk_tpu.utils.benchtime import gpu_name_and_power_limit

    CARD = gpu_name_and_power_limit() or CARD
    t0 = time.perf_counter()
    info = phase_device()
    if args.cards == 1:
        phases = (phase_arith, phase_protocols, phase_wide,
                  phase_transcripts, phase_chip_tests)
    else:
        phases = (lambda: phase_dp(args.cards), lambda: phase_sp(args.cards))
    for phase in phases:
        t1 = time.perf_counter()
        phase()
        log("time", f"phase done in {time.perf_counter() - t1:.1f} s")
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
