"""Proof of Sum x' = sum_i g_i * x_i -- generalization of the linear proof.

Batched re-design of ring-zk src/prove/sum.rs (itself not in the
paper; see its module doc). The VL summands are a *leading structure axis*
``V`` here -- xs: [..., V, l, N], gs: [..., V, N] -- so the whole vector of
commitments/responses is one batched program instead of the reference's
Vec-of-Mats loops.

Protocol:
  P->V:  cp, {c_i}, {g_i},  tp = a1.yp,  {t_i = a1.y_i},
         u = sum_i g_i*(a2.y_i) - a2.yp
  V->P:  d ~ C
  P->V:  {z_i = y_i + d*r_i},  zp = yp + d*rp
  V:     norms; per-i a1.z_i == t_i + c1_i*d; a1.zp == tp + c1p*d;
         sum_i g_i*(a2.z_i) - a2.zp == (sum_i g_i*c2_i - c2p)*d + u

Divergence (SURVEY.md section 2.1): the reference's length check uses `&&`
where `||` is intended (/root/reference/src/prove/sum.rs:272-275), letting a
response with exactly one mismatched length slip to a later panic. Here the
structure axes make lengths part of the array shapes: any mismatch fails
shape checking up front (we also verify it explicitly in `verify`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import mat, sampling, zq
from ..ops.ntt import get_ring
from ..params import Params
from ..utils.profiling import annotate
from .commit import (
    Commitment,
    CommitmentKey,
    Opening,
    stack_siblings_ok,
    commit,
    matvec_key,
    shared_d_num,
    verify_ok,
)
from .open import gaussian_bound, sample_y


class SumProofResponseContext(NamedTuple):
    """(/root/reference/src/prove/sum.rs:327-339)"""

    openings: Opening     # batched over V: x [..., V, l, N], r [..., V, k, N]
    opening_p: Opening
    yp: jax.Array         # [..., k, N]
    ys: jax.Array         # [..., V, k, N]


class SumProofCommitment(NamedTuple):
    """(/root/reference/src/prove/sum.rs:342-356)"""

    cp: Commitment        # [..., n+l, N]
    cs: Commitment        # [..., V, n+l, N]
    gs: jax.Array         # [..., V, N]
    tp: jax.Array         # [..., n, N]
    ts: jax.Array         # [..., V, n, N]
    u: jax.Array          # [..., l, N]


class SumProofVerificationContext(NamedTuple):
    """(/root/reference/src/prove/sum.rs:359-372)"""

    c1p: jax.Array        # [..., n, N]
    c2p: jax.Array        # [..., l, N]
    c1s: jax.Array        # [..., V, n, N]
    c2s: jax.Array        # [..., V, l, N]
    gs: jax.Array
    ts: jax.Array
    tp: jax.Array
    u: jax.Array
    d: jax.Array


class SumProofChallenge(NamedTuple):
    d: jax.Array


class SumProofResponse(NamedTuple):
    zp: jax.Array         # [..., k, N]
    zs: jax.Array         # [..., V, k, N]


def _sum_v(ring, hat, v_axis):
    """Exact mod-q reduce of an NTT-domain product stack over the summand
    axis -> centered int32. Chunked past ACC_MAX terms (ring.sum_to_centered),
    so ANY summand count VL is exact -- parity with the reference's
    unbounded loop (/root/reference/src/prove/sum.rs:106-120)."""
    return ring.sum_to_centered(hat, v_axis)


def _matvec_key_v1(ring, ck: CommitmentKey, vs, vp, bound: int):
    """Full-key matvec for the summand stack vs [..., V, k, N] plus the
    singleton vp [..., k, N]: one concatenated [..., V+1, ...] dispatch
    when stacking applies (commit.stack_siblings_ok level 1, the DEFAULT --
    a measured win on the chip, see commit._stacked_level; requires the
    digit engine: the NTT fallback's key-batch broadcast would misalign
    against the stack axis), two otherwise. Bit-identical either way
    (independent matmul rows)."""
    if stack_siblings_ok(ck, bound):
        out = matvec_key(
            ring, ck, "a", jnp.concatenate([vs, vp[..., None, :, :]], axis=-3), bound
        )
        return out[..., :-1, :, :], out[..., -1, :, :]
    return matvec_key(ring, ck, "a", vs, bound), matvec_key(ring, ck, "a", vp, bound)


@annotate("sum_proof/commit")
def prover_commit(key, ck: CommitmentKey, gs, xs, params: Params):
    """Move 1 (/root/reference/src/prove/sum.rs:99-178).

    gs: [..., V, N], xs: [..., V, l, N]. The xs/ys/commit calls for all V
    summands run as one batched commit (the reference loops V times).
    """
    if gs.shape[-2] != xs.shape[-3] or gs.shape[-2] < 1:
        raise ValueError(f"gs/xs summand axes disagree: {gs.shape} vs {xs.shape}")
    vl = gs.shape[-2]
    n_deg = xs.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    k_cp, k_cs, k_ys, k_yp = jax.random.split(key, 4)
    batch = xs.shape[:-3]

    gs_hat = ring.fwd_const(gs)

    # xp = sum_i g_i * x_i  (single-depth products, chunked V-term reduce)
    gx_hat = mat.scalar_mul_hat(ring, gs_hat, ring.fwd(xs))  # [P, ..., V, l, N]
    xp = _sum_v(ring, gx_hat, v_axis=-3)                     # [..., l, N]

    opening_p, cp = commit(k_cp, ck, xp, params)
    openings, cs = commit(k_cs, ck, xs, params)  # batched over V

    gbound = gaussian_bound(params, n_deg)
    ys = sample_y(k_ys, params, n_deg, batch + (vl,))
    yp = sample_y(k_yp, params, n_deg, batch)

    # a1.y_i and a2.y_i ride one fused full-key matvec per input vector;
    # ys and yp concatenate into a single dispatch under RINGZK_STACKED
    ays, ayp = _matvec_key_v1(ring, ck, ys, yp, gbound)
    ts, a2ys = mat.split_rows(ays, params.n)  # [..., V, n, N], [..., V, l, N]
    tp, a2yp = mat.split_rows(ayp, params.n)

    # u = sum_i g_i*(a2.y_i) - a2.yp  (depth-one: a2.y_i reduced mod q)
    gay = mat.scalar_mul_hat(ring, gs_hat, ring.fwd(a2ys))    # [P, ..., V, l, N]
    u = zq.sub_centered(ring.qctx, _sum_v(ring, gay, v_axis=-3), a2yp)

    return (
        SumProofResponseContext(openings=openings, opening_p=opening_p, yp=yp, ys=ys),
        SumProofCommitment(cp=cp, cs=cs, gs=gs, tp=tp, ts=ts, u=u),
    )


@annotate("sum_proof/generate_challenge")
def generate_challenge(key, commitment: SumProofCommitment, params: Params):
    """Move 2 (/root/reference/src/prove/sum.rs:228-253)."""
    n_deg = commitment.tp.shape[-1]
    batch = commitment.tp.shape[:-2]
    d = sampling.challenge(key, batch, n_deg, params.kappa)
    c1s, c2s = commitment.cs.c1_c2(params)
    c1p, c2p = commitment.cp.c1_c2(params)
    return (
        SumProofVerificationContext(
            c1p=c1p, c2p=c2p, c1s=c1s, c2s=c2s, gs=commitment.gs,
            ts=commitment.ts, tp=commitment.tp, u=commitment.u, d=d,
        ),
        SumProofChallenge(d=d),
    )


@annotate("sum_proof/create_response")
def create_response(
    ctx: SumProofResponseContext, challenge: SumProofChallenge, params: Params
):
    """Move 3 (/root/reference/src/prove/sum.rs:182-200)."""
    n_deg = ctx.yp.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    d_num = shared_d_num(ring, params, n_deg, num)
    # d broadcasts over the V and k axes of rs: [..., V, k, N]
    return SumProofResponse(
        zs=ring.scalar_mul_add(challenge.d, ctx.openings.r, ctx.ys, num, d_num),
        zp=ring.scalar_mul_add(challenge.d, ctx.opening_p.r, ctx.yp, num, d_num),
    )


@annotate("sum_proof/verify")
def verify(
    ck: CommitmentKey,
    response: SumProofResponse,
    vctx: SumProofVerificationContext,
    params: Params,
):
    """Move 4 (/root/reference/src/prove/sum.rs:257-320). bool [...]."""
    zs, zp = response.zs, response.zp
    n_deg = zs.shape[-1]
    ring = get_ring(n_deg, params.modulus)

    # length checks (the reference's intent at sum.rs:272-275, with the
    # `&&`->`||` fix): any summand-count mismatch rejects outright
    if zs.shape[-3] != vctx.ts.shape[-3] or zs.shape[-3] != vctx.c1s.shape[-3]:
        raise ValueError(
            f"summand count mismatch: zs {zs.shape[-3]} vs ts {vctx.ts.shape[-3]}"
            f" vs cs {vctx.c1s.shape[-3]}"
        )

    ok = jnp.all(verify_ok(params, n_deg, zs), axis=-1) & verify_ok(params, n_deg, zp)
    vbound = params.verify_bound(n_deg)

    gs_hat = ring.fwd_const(vctx.gs)
    # c1*d products only ride the NTT; t terms are added in the integer
    # domain afterwards (skips their forward transforms)
    num_d = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))

    # each of zs, zp needs both a1.* and a2.*: one fused full-key matvec each
    azs, azp = _matvec_key_v1(ring, ck, zs, zp, vbound)
    a1zs, a2zs = mat.split_rows(azs, params.n)
    a1zp, a2zp = mat.split_rows(azp, params.n)

    # per-i: a1.z_i == t_i + c1_i*d  (d broadcasts over V)
    rhs1 = ring.scalar_mul_add(vctx.d, vctx.c1s, vctx.ts, num_d)
    eq1 = jnp.all(mat.poly_equal(a1zs, rhs1, struct_axes=1), axis=-1)
    # a1.zp == tp + c1p*d
    rhs2 = ring.scalar_mul_add(vctx.d, vctx.c1p, vctx.tp, num_d)
    eq2 = mat.poly_equal(a1zp, rhs2, struct_axes=1)

    # sum_i g_i*(a2.z_i) - a2.zp == (sum_i g_i*c2_i - c2p)*d + u
    lhs = zq.sub_centered(
        ring.qctx,
        _sum_v(ring, mat.scalar_mul_hat(ring, gs_hat, ring.fwd(a2zs)), v_axis=-3),
        a2zp,
    )
    # c2p is subtracted in the integer domain (skips its forward transform;
    # identical mod-q value to the old in-NTT sub_hat formulation)
    gc2 = zq.sub_centered(
        ring.qctx,
        _sum_v(ring, mat.scalar_mul_hat(ring, gs_hat, ring.fwd(vctx.c2s)), v_axis=-3),
        vctx.c2p,
    )
    rhs = ring.scalar_mul_add(vctx.d, gc2, vctx.u, num_d)
    eq3 = mat.poly_equal(lhs, rhs, struct_axes=1)

    return ok & eq1 & eq2 & eq3


def roundtrip(key, ck: CommitmentKey, gs, xs, params: Params, chains: int = 1):
    """Full 3-phase sum proof (the reference's integration loop body,
    /root/reference/tests/test.rs:59-93) as one batched program.

    ``chains`` splits the leading batch axis into independent sub-chains
    for cross-chain overlap (see commit.chained_roundtrip)."""
    from . import commit as commit_mod

    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda k, g, x: roundtrip(k, ck, g, x, params),
            key, (gs, xs), chains, (3, 4),
        )
    k1, k2 = jax.random.split(key)
    rctx, pcom = prover_commit(k1, ck, gs, xs, params)
    op_ok = commit_mod.verify(
        ck, pcom.cp, rctx.opening_p, params, honest_r_bound=params.b
    )
    op_ok &= jnp.all(
        commit_mod.verify(
            ck, pcom.cs, rctx.openings, params, honest_r_bound=params.b
        ),
        axis=-1,
    )
    vctx, chal = generate_challenge(k2, pcom, params)
    resp = create_response(rctx, chal, params)
    return verify(ck, resp, vctx, params), op_ok
