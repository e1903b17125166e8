"""Proof of Linear Relation x' = g * x (paper section 4.4), batched-first.

Batched re-design of ring-zk src/prove/linear.rs. The prover
holds openings of two commitments c (to x) and cp (to x' = g*x) and proves
the relation for a public scalar polynomial g.

Protocol:
  P->V:  c, cp, g,  t = a1.y,  tp = a1.yp,  u = g*(a2.y) - a2.yp
  V->P:  d ~ C
  P->V:  z = y + d*r,  zp = yp + d*rp
  V:     norms of z, zp;  a1.z == t + c1*d;  a1.zp == tp + c1p*d;
         g*(a2.z) - a2.zp == (g*c2 - c2p)*d + u
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from ..ops import mat, sampling, zq
from ..ops.ntt import get_ring
from ..params import Params
from ..utils.profiling import annotate
from .commit import (
    Commitment,
    CommitmentKey,
    Opening,
    commit,
    matvec_key_siblings,
    shared_d_num,
    verify_ok,
)
from .open import gaussian_bound, sample_y


class LinearProofResponseContext(NamedTuple):
    """(/root/reference/src/prove/linear.rs:257-268)"""

    opening: Opening      # of c (to x)
    opening_p: Opening    # of cp (to g*x)
    y: jax.Array          # [..., k, N]
    yp: jax.Array         # [..., k, N]


class LinearProofCommitment(NamedTuple):
    """(/root/reference/src/prove/linear.rs:271-285)"""

    c: Commitment
    cp: Commitment
    g: jax.Array   # [..., N]
    t: jax.Array   # [..., n, N]
    tp: jax.Array  # [..., n, N]
    u: jax.Array   # [..., l, N]


class LinearProofVerificationContext(NamedTuple):
    """(/root/reference/src/prove/linear.rs:289-306)"""

    c1: jax.Array
    c2: jax.Array
    c1p: jax.Array
    c2p: jax.Array
    g: jax.Array
    t: jax.Array
    tp: jax.Array
    u: jax.Array
    d: jax.Array


class LinearProofChallenge(NamedTuple):
    d: jax.Array


class LinearProofResponse(NamedTuple):
    z: jax.Array   # [..., k, N]
    zp: jax.Array  # [..., k, N]


@annotate("linear_proof/commit")
def prover_commit(key, ck: CommitmentKey, g, x, params: Params):
    """Move 1 (/root/reference/src/prove/linear.rs:82-140). g: [..., N],
    x: [..., l, N]."""
    n_deg = x.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    k_cp, k_c, k_y, k_yp = jax.random.split(key, 4)

    g_hat = ring.fwd_const(g)
    gx = ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(x)))
    opening_p, cp = commit(k_cp, ck, gx, params)
    opening, c = commit(k_c, ck, x, params)

    batch = x.shape[:-2]
    gbound = gaussian_bound(params, n_deg)
    y = sample_y(k_y, params, n_deg, batch)
    yp = sample_y(k_yp, params, n_deg, batch)

    # a1.y and a2.y ride one fused full-key matvec each (split afterwards);
    # y and yp stack into a single dispatch at RINGZK_STACKED>=2 (opt-in)
    ay, ayp = matvec_key_siblings(ring, ck, (y, yp), gbound)
    t, a2y = mat.split_rows(ay, params.n)
    tp, a2yp = mat.split_rows(ayp, params.n)
    # u = g*(a2.y) - a2.yp. Depth-one rule (see RingContext.inv): a2.y is a
    # reduced mod-q value before the second multiplication by g.
    u = zq.sub_centered(
        ring.qctx,
        ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(a2y))),
        a2yp,
    )

    return (
        LinearProofResponseContext(opening=opening, opening_p=opening_p, y=y, yp=yp),
        LinearProofCommitment(c=c, cp=cp, g=g, t=t, tp=tp, u=u),
    )


@annotate("linear_proof/generate_challenge")
def generate_challenge(key, commitment: LinearProofCommitment, params: Params):
    """Move 2 (/root/reference/src/prove/linear.rs:184-209)."""
    n_deg = commitment.t.shape[-1]
    batch = commitment.t.shape[:-2]
    d = sampling.challenge(key, batch, n_deg, params.kappa)
    c1, c2 = commitment.c.c1_c2(params)
    c1p, c2p = commitment.cp.c1_c2(params)
    return (
        LinearProofVerificationContext(
            c1=c1, c2=c2, c1p=c1p, c2p=c2p, g=commitment.g,
            t=commitment.t, tp=commitment.tp, u=commitment.u, d=d,
        ),
        LinearProofChallenge(d=d),
    )


@annotate("linear_proof/create_response")
def create_response(
    ctx: LinearProofResponseContext, challenge: LinearProofChallenge, params: Params
):
    """Move 3 (/root/reference/src/prove/linear.rs:144-158):
    z = y + d*r, zp = yp + d*rp."""
    n_deg = ctx.y.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    d_num = shared_d_num(ring, params, n_deg, num)
    return LinearProofResponse(
        z=ring.scalar_mul_add(challenge.d, ctx.opening.r, ctx.y, num, d_num),
        zp=ring.scalar_mul_add(challenge.d, ctx.opening_p.r, ctx.yp, num, d_num),
    )


@annotate("linear_proof/verify")
def verify(
    ck: CommitmentKey,
    response: LinearProofResponse,
    vctx: LinearProofVerificationContext,
    params: Params,
):
    """Move 4 (/root/reference/src/prove/linear.rs:213-250). bool [...]."""
    z, zp = response.z, response.zp
    n_deg = z.shape[-1]
    ring = get_ring(n_deg, params.modulus)

    ok = verify_ok(params, n_deg, z) & verify_ok(params, n_deg, zp)
    vbound = params.verify_bound(n_deg)

    g_hat = ring.fwd_const(vctx.g)
    # c1*d terms: wire values are int32, d is kappa-sparse ternary; t is
    # added in the integer domain afterwards (skips its forward transform)
    num_d = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))

    def t_plus_c1d(t, c1):
        return ring.scalar_mul_add(vctx.d, c1, t, num_d)

    # each of z, zp needs both a1.* and a2.*: one fused full-key matvec
    # each; z and zp stack into a single dispatch at RINGZK_STACKED>=2 (opt-in)
    az, azp = matvec_key_siblings(ring, ck, (z, zp), vbound)
    a1z, a2z = mat.split_rows(az, params.n)
    a1zp, a2zp = mat.split_rows(azp, params.n)

    # a1.z == t + c1*d ; a1.zp == tp + c1p*d
    eq1 = mat.poly_equal(a1z, t_plus_c1d(vctx.t, vctx.c1), struct_axes=1)
    eq2 = mat.poly_equal(a1zp, t_plus_c1d(vctx.tp, vctx.c1p), struct_axes=1)
    # g*(a2.z) - a2.zp == (g*c2 - c2p)*d + u
    # Depth-one rule: reduce a2.z mod q before multiplying by g, and reduce
    # (g*c2 - c2p) mod q before multiplying by d.
    lhs = zq.sub_centered(
        ring.qctx,
        ring.inv(mat.scalar_mul_hat(ring, g_hat, ring.fwd(a2z))),
        a2zp,
    )
    gc2_c2p = ring.inv(
        ring.sub_hat(
            mat.scalar_mul_hat(ring, g_hat, ring.fwd(vctx.c2)), ring.fwd(vctx.c2p)
        )
    )
    rhs = ring.scalar_mul_add(vctx.d, gc2_c2p, vctx.u, num_d)
    eq3 = mat.poly_equal(lhs, rhs, struct_axes=1)

    return ok & eq1 & eq2 & eq3


def roundtrip(key, ck: CommitmentKey, g, x, params: Params, chains: int = 1):
    """Full 3-phase linear proof (the reference's integration loop body,
    /root/reference/tests/test.rs:34-56) as one batched program.

    ``chains`` splits the leading batch axis into independent sub-chains
    for cross-chain overlap (see commit.chained_roundtrip)."""
    from . import commit as commit_mod

    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda k, gc, xc: roundtrip(k, ck, gc, xc, params),
            key, (g, x), chains, (2, 3),
        )
    k1, k2 = jax.random.split(key)
    rctx, pcom = prover_commit(k1, ck, g, x, params)
    op_ok = commit_mod.verify(
        ck, pcom.c, rctx.opening, params, honest_r_bound=params.b
    )
    op_ok &= commit_mod.verify(
        ck, pcom.cp, rctx.opening_p, params, honest_r_bound=params.b
    )
    vctx, chal = generate_challenge(k2, pcom, params)
    resp = create_response(rctx, chal, params)
    return verify(ck, resp, vctx, params), op_ok
