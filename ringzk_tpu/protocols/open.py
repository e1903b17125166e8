"""Proof of Opening a commitment (paper section 4.4), batched-first.

Batched re-design of ring-zk src/prove/open.rs: the 3-move sigma
protocol is four pure functions (prover commit -> verifier challenge ->
prover response -> verifier verify) over pytrees of arrays, each jit-able
and batched over arbitrary leading axes. The message pytrees mirror the
reference's seven-type family (ResponseContext/Commitment/
VerificationContext/Challenge/Response) so a user of ring-zk finds the same
protocol surface.

Protocol (prover knows opening (x, r) of c):
  P->V:  c,  t = a1 . y            with y ~ N(0, sigma)^k
  V->P:  d  ~ challenge space C
  P->V:  z = y + d * r
  V:     ||z_i|| <= 2 sigma sqrt(N)  and  a1 . z == t + c1 * d
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import mat, sampling
from ..ops.ntt import get_ring
from ..params import Params
from ..utils.profiling import annotate
from .commit import (
    Commitment,
    CommitmentKey,
    Opening,
    commit,
    matvec_key,
    shared_d_num,
    verify_ok,
)


def gaussian_bound(params: Params, n_deg: int) -> int:
    """Static clamp bound for prover Gaussians: 16 sigma. A float32 N(0,1)
    draw exceeding 16 sigma has probability < 1e-56 -- the clamp never fires
    in practice (it exists to give the digit decomposition a static
    bound) and leaves the sampler's distribution indistinguishable from the
    reference's unclamped one."""
    return 16 * params.standard_deviation(n_deg)


def sample_y(key, params: Params, n_deg: int, batch_shape):
    sigma = params.standard_deviation(n_deg)
    y = sampling.gaussian_rounded(key, batch_shape + (params.k,), n_deg, sigma)
    b = gaussian_bound(params, n_deg)
    return jnp.clip(y, -b, b)


class OpenProofResponseContext(NamedTuple):
    """Prover-private state between moves 1 and 3
    (/root/reference/src/prove/open.rs:181-187)."""

    opening: Opening
    y: jax.Array  # [..., k, N]


class OpenProofCommitment(NamedTuple):
    """First prover->verifier message (/root/reference/src/prove/open.rs:190-198)."""

    c: Commitment
    t: jax.Array  # [..., n, N]


class OpenProofVerificationContext(NamedTuple):
    """Verifier-private state (/root/reference/src/prove/open.rs:202-210)."""

    c1: jax.Array  # [..., n, N]
    t: jax.Array   # [..., n, N]
    d: jax.Array   # [..., N]


class OpenProofChallenge(NamedTuple):
    d: jax.Array  # [..., N]


class OpenProofResponse(NamedTuple):
    z: jax.Array  # [..., k, N]


@annotate("open_proof/commit")
def prover_commit(key, ck: CommitmentKey, x, params: Params):
    """Move 1. x: [..., l, N] -> (response context, proof commitment).

    Mirrors /root/reference/src/prove/open.rs:80-103: commit to x, draw
    y ~ N(0, sigma)^k (rounded discrete Gaussian), send t = a1 . y.
    """
    n_deg = x.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    k_com, k_y = jax.random.split(key)

    opening, c = commit(k_com, ck, x, params)
    y = sample_y(k_y, params, n_deg, x.shape[:-2])
    t = matvec_key(ring, ck, "a1", y, gaussian_bound(params, n_deg))
    return (
        OpenProofResponseContext(opening=opening, y=y),
        OpenProofCommitment(c=c, t=t),
    )


@annotate("open_proof/generate_challenge")
def generate_challenge(key, commitment: OpenProofCommitment, params: Params):
    """Move 2 (/root/reference/src/prove/open.rs:143-158): draw d from the
    challenge space; retain (c1, t, d) for verification."""
    n_deg = commitment.t.shape[-1]
    batch = commitment.t.shape[:-2]
    d = sampling.challenge(key, batch, n_deg, params.kappa)
    c1, _ = commitment.c.c1_c2(params)
    return (
        OpenProofVerificationContext(c1=c1, t=commitment.t, d=d),
        OpenProofChallenge(d=d),
    )


@annotate("open_proof/create_response")
def create_response(
    ctx: OpenProofResponseContext, challenge: OpenProofChallenge, params: Params
):
    """Move 3 (/root/reference/src/prove/open.rs:107-117): z = y + d * r.

    Note: like the reference, no rejection-sampling abort (SURVEY.md
    section 2.1) -- the relaxed 2 sigma sqrt(N) verify bound absorbs it.
    """
    n_deg = ctx.y.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    # d*r has |integer coeffs| <= min(kappa, N) * b: a small-bound product,
    # so a CRT prime subset (usually a single prime) suffices exactly
    num = ring.primes_needed(min(params.kappa, n_deg) * params.b)
    d_num = shared_d_num(ring, params, n_deg, num)
    z = ring.scalar_mul_add(challenge.d, ctx.opening.r, ctx.y, num, d_num)
    return OpenProofResponse(z=z)


@annotate("open_proof/verify")
def verify(
    ck: CommitmentKey,
    response: OpenProofResponse,
    vctx: OpenProofVerificationContext,
    params: Params,
):
    """Move 4 (/root/reference/src/prove/open.rs:162-174). Returns bool [...]:
    norm bound on every z_i AND a1 . z == t + c1 * d."""
    z = response.z
    n_deg = z.shape[-1]
    ring = get_ring(n_deg, params.modulus)

    ok_norm = verify_ok(params, n_deg, z)

    # a1.z with z clamped to the verify bound (any passing z has every
    # |coeff| <= norm_2 <= 2 sigma sqrt(N); a failing z rejects regardless)
    lhs = matvec_key(ring, ck, "a1", z, params.verify_bound(n_deg))
    # c1*d: c1 is arbitrary int32 from the wire, d is kappa-sparse ternary
    # -> |integer coeffs| <= min(kappa,N)*2^31, inside a 2-prime subset.
    # t is then added in the integer domain (one centered mod-q add),
    # skipping its forward transform entirely -- fused with the product.
    num = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))
    rhs = ring.scalar_mul_add(vctx.d, vctx.c1, vctx.t, num)
    return ok_norm & mat.poly_equal(lhs, rhs, struct_axes=1)


def roundtrip(key, ck: CommitmentKey, x, params: Params, chains: int = 1):
    """Full 3-phase protocol in one jit-able call (prover + verifier).

    Returns (ok, opening_ok): the sigma-protocol acceptance and the direct
    commitment-opening check, both bool [...]. This is the reference's
    integration-test loop body (/root/reference/tests/test.rs:11-31) as a
    single batched program -- and the unit of the headline benchmark.

    ``chains`` splits the leading batch axis into that many INDEPENDENT
    sub-chains inside the same program (each drawing its own derived key).
    The 3-move protocol's data dependencies serialize its matvec phases
    against its transform/sampling phases; independent chains give XLA's
    scheduler cross-chain overlap across those walls. Identical per-proof
    semantics and work; the random draws differ from the unchained call
    (each chain consumes its own key split).
    """
    import os

    from . import commit as commit_mod

    if chains > 1 and os.environ.get("RINGZK_STAGGER", "0") == "1":
        return _roundtrip_staggered(key, ck, x, params, chains)
    if chains > 1:
        return commit_mod.chained_roundtrip(
            lambda k, xc: roundtrip(k, ck, xc, params), key, (x,), chains, (3,)
        )

    k1, k2 = jax.random.split(key)
    rctx, pcom = prover_commit(k1, ck, x, params)
    opening_ok = commit_mod.verify(
        ck, pcom.c, rctx.opening, params, honest_r_bound=params.b
    )
    vctx, chal = generate_challenge(k2, pcom, params)
    resp = create_response(rctx, chal, params)
    ok = verify(ck, resp, vctx, params)
    return ok, opening_ok


def _roundtrip_staggered(key, ck: CommitmentKey, x, params: Params,
                         chains: int = 2):
    """``chains`` sub-chains as an EXPLICIT software pipeline.

    The plain chained form hands XLA independent subgraphs and trusts its
    latency-hiding scheduler to overlap one chain's elementwise phases
    with another's matmul phases. This variant pins the offset with
    `lax.optimization_barrier` walls: in stage t, chain c executes phase
    t - c (commit+opening-verify, challenge, response, verify), so every
    wall pairs matmul-heavy phases (commit / verify matvecs) of one chain
    against elementwise phases (challenge sampling / response NTTs) of its
    neighbors. The opening verify lives in the SAME stage as its commit:
    its A.r matvec is CSE'd with the commit's own (the honest_r_bound
    dedupe), and a barrier between them would resurrect the deleted
    matvec.

    Everything live crosses each barrier, so XLA cannot collapse the
    stagger by hoisting. Same per-proof semantics and key derivation as
    chained_roundtrip (bit-identical, tested). Trace-time opt-in
    (RINGZK_STAGGER=1); measured as a loss against free scheduling on the
    previous accelerator, so the default stays un-pinned."""
    from . import commit as commit_mod

    x = jnp.asarray(x)  # same normalization as chained_roundtrip
    if x.ndim < 3 or x.shape[0] % chains:
        raise ValueError(
            f"staggered roundtrip needs a batched [B, l, N] input with B "
            f"divisible by chains={chains} (an unbatched call cannot be "
            "chained)"
        )
    step = x.shape[0] // chains
    xs = [x[c * step : (c + 1) * step] for c in range(chains)]
    keys = [jax.random.split(ki) for ki in jax.random.split(key, chains)]
    barrier = jax.lax.optimization_barrier

    rctx, pcom, op_ok, vctx, chal, resp, ok = (
        [None] * chains for _ in range(7)
    )
    for t in range(chains + 3):
        for c in range(chains):
            p = t - c
            if p == 0:
                rctx[c], pcom[c] = prover_commit(keys[c][0], ck, xs[c], params)
                op_ok[c] = commit_mod.verify(
                    ck, pcom[c].c, rctx[c].opening, params,
                    honest_r_bound=params.b,
                )
            elif p == 1:
                vctx[c], chal[c] = generate_challenge(
                    keys[c][1], pcom[c], params
                )
            elif p == 2:
                resp[c] = create_response(rctx[c], chal[c], params)
            elif p == 3:
                ok[c] = verify(ck, resp[c], vctx[c], params)
        if t < chains + 2:
            # the wall: every live value crosses it (None leaves are empty
            # pytree nodes and pass through untouched)
            (rctx, pcom, op_ok, vctx, chal, resp, ok, xs, keys) = barrier(
                (rctx, pcom, op_ok, vctx, chal, resp, ok, xs, keys)
            )
    return jnp.concatenate(ok), jnp.concatenate(op_ok)
