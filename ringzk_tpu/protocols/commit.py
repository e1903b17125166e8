"""BDLOP commitment scheme (paper section 4.1), batched-first.

Batched re-design of ring-zk src/commit.rs: the commitment key,
commitment, and opening are pytrees of int32 arrays (centered residues) with
leading batch axes; `commit` and `verify` are pure jit/vmap/pjit-able
functions. The key matrices are additionally cached in NTT domain (uint32,
leading prime axis) so every commit/verify touches only pointwise
multiply-accumulates -- the reference's `Mat::dot` hot loop
(/root/reference/src/mat.rs:95-115) disappears into the CRT-NTT engine.

Key structure (paper eqs. 5-6, /root/reference/src/commit.rs:33-60):
    a1 = [I_n | A1'],            A1' uniform n x (k-n)
    a2 = [0_{l x n} | I_l | A2'], A2' uniform l x (k-n-l)
Commit (eq. 7, /root/reference/src/commit.rs:123-125):
    c = [a1; a2] . r + [0_n; x],  r uniform with coeffs in [-b, b],
re-sampled until ||r_i||_2 <= 4 sigma sqrt(N) (never triggers for honest
parameter sets; see the masked-resample note in `commit`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import conv_mxu, mat, norms, sampling
from ..ops.ntt import RingContext, get_ring
from ..params import Params
from ..utils.profiling import annotate

# Largest ring degree for which the digitized key operator is built.
# Operator memory is KEY_DIGITS * kN * (n+l)N int8 (~126 MB at N=2048,
# ~400 MB at N=4096) and grows as N^2, as does the matmul work (vs the NTT
# path's N log N). At N >= 4096 pass the key to jit as an ARGUMENT rather
# than closing over it, so the operator ships as a device buffer instead of
# inline program constants. Deriving the cap from the device's memory is
# an open item.
MXU_MAX_N = 4096


def _use_mxu() -> bool:
    """Switch for the int8 digit matvec (RINGZK_MXU=0 to disable; default
    on). The NTT-pointwise key matvec is the alternative; both paths are
    bit-identical (tests/test_conv_mxu.py)."""
    return os.environ.get("RINGZK_MXU", "1") == "1"


def shared_d_num(ring: RingContext, params: Params, n_deg: int,
                 num: int) -> Optional[int]:
    """Prime-subset size for the challenge transform in create_response
    (opt-in probe flag RINGZK_SHARED_DHAT=1; default off).

    The idea: the response's d*r product needs only ``num`` CRT primes
    (ternary d x [-b,b] r), but verify's ``t + c1*d`` transforms the SAME
    d at the larger wire-bound subset. Transforming d at the verifier's
    size here (and slicing -- bit-identical, see
    RingContext.scalar_mul_add) makes the two fwd_const(d) subgraphs
    syntactically equal, CSE-able in a fused roundtrip program -- the
    honest-bound-dedupe trick applied to the challenge transform.

    Measured as a loss on the previous accelerator and kept opt-in
    (bit-identity tested,
    tests/test_protocols.py::test_shared_dhat_bit_identity)."""
    if os.environ.get("RINGZK_SHARED_DHAT", "0") == "0":
        return None
    num_d = ring.primes_needed(min(params.kappa, n_deg) * (ring.q // 2 + 1))
    return num_d if num_d > num else None


class CommitmentKey(NamedTuple):
    """a1: [..., n, k, N], a2: [..., l, k, N] int32; *_hat: NTT-domain
    uint32 caches with leading prime axis [P, ..., rows, k, N]; *_dig:
    optional digit operators [kN, D*rowsN] int8 (None for batched keys
    or large N -- the NTT path is used then; see ops/conv_mxu.py)."""

    a1: jax.Array
    a2: jax.Array
    a1_hat: jax.Array
    a2_hat: jax.Array
    a1_dig: Optional[jax.Array] = None
    a2_dig: Optional[jax.Array] = None

    @property
    def n_deg(self) -> int:
        return self.a1.shape[-1]

    def a_hat(self):
        """[a1; a2] stacked rows, NTT domain: [P, ..., n+l, k, N]."""
        return jnp.concatenate([self.a1_hat, self.a2_hat], axis=-3)


class Commitment(NamedTuple):
    """c = [c1; c2]: [..., n+l, N] int32 centered."""

    c: jax.Array

    def c1_c2(self, params: Params):
        """Split into (c1: first n rows, c2: last l rows).

        NOTE divergence from the reference: its `c1_c2`
        (/root/reference/src/commit.rs:213-218) mislabels the split via
        `split_rows` (last-rows-second, /root/reference/src/mat.rs:203-213)
        and is only correct when n == l. We split correctly for all n, l.
        """
        return mat.split_rows(self.c, params.n)


class Opening(NamedTuple):
    """x: [..., l, N], r: [..., k, N] int32; f: optional relaxation factor
    polynomial [..., N] (None == identity, as everywhere in the reference --
    /root/reference/src/commit.rs:222-235)."""

    x: jax.Array
    r: jax.Array
    f: Optional[jax.Array] = None


@annotate("commit_scheme/keygen")
def keygen(key, params: Params, n_deg: int, batch_shape=()) -> CommitmentKey:
    """Generate commitment key(s). batch_shape prefixes independent keys."""
    params.validate()
    ring = get_ring(n_deg, params.modulus)
    if ring.wide and params.commit_bound(n_deg) >= 2**31:
        raise ValueError(
            f"commit bound {params.commit_bound(n_deg)} >= 2^31 at N={n_deg}: "
            "wide-ring norm checks need int32-range bounds (ops/norms.py)"
        )
    n, k, l, q = params.n, params.k, params.l, params.q
    k1, k2 = jax.random.split(key)

    def eye_poly(rows):
        e = jnp.zeros((rows, rows, n_deg), ring.dtype)
        return e.at[jnp.arange(rows), jnp.arange(rows), 0].set(1)

    a1p = sampling.uniform_centered(k1, batch_shape + (n, k - n), n_deg, q)
    i_n = jnp.broadcast_to(eye_poly(n), batch_shape + (n, n, n_deg))
    a1 = jnp.concatenate([i_n, a1p], axis=-2)

    a2p = sampling.uniform_centered(k2, batch_shape + (l, k - n - l), n_deg, q)
    z_ln = jnp.zeros(batch_shape + (l, n, n_deg), ring.dtype)
    i_l = jnp.broadcast_to(eye_poly(l), batch_shape + (l, l, n_deg))
    a2 = jnp.concatenate([z_ln, i_l, a2p], axis=-2)

    # digit operators (RINGZK_MXU=0 to disable): single concrete key of
    # moderate N only (batched keys use the NTT path).
    a1_dig = a2_dig = None
    if (
        _use_mxu()
        and batch_shape == ()
        and n_deg <= MXU_MAX_N
        # wide rings (modulus >= 2^32) are excluded outright: the digit
        # fold's qctx is a Mont64Ctx (no uint32 mont_mul) and the int32
        # matvec output cannot carry wide residues -- even a small sampling
        # bound q that fits the digit capacity must take the NTT path
        and not ring.wide
        # int32 accumulation capacity: per-plane sums are bounded by
        # kN*(128)^2 and up to KEY_DIGITS planes share one shift group
        # (conv_mxu.matvec_digits) -- the group total must stay < 2^31
        and conv_mxu.KEY_DIGITS * k * n_deg * (conv_mxu.RADIX // 2) ** 2 < 2**31
        # KEY_DIGITS balanced digits must cover the key residues (bounded
        # by the sampling bound q). Moduli above 2*2,139,062,143+1 -- i.e.
        # within ~16.8M of 2^32 -- exceed the 4-digit capacity
        # 2,139,062,143 -> those keys take the NTT path
        # (a corrupt digit operator would be a *silent* wrong-answer bug).
        and params.q <= conv_mxu.digit_capacity(conv_mxu.KEY_DIGITS)
    ):
        a1_dig = conv_mxu.build_operator_digits_device(a1, ring)
        a2_dig = conv_mxu.build_operator_digits_device(a2, ring)

    # keys are multiplicative constants -> cached in const (Montgomery) form
    return CommitmentKey(
        a1=a1, a2=a2, a1_hat=ring.fwd_const(a1), a2_hat=ring.fwd_const(a2),
        a1_dig=a1_dig, a2_dig=a2_dig,
    )


def _use_fused_a() -> bool:
    """Switch for the fused full-key digit matvec (RINGZK_FUSED_A=1 to
    enable). When on, matvec_key('a', ...) against a digitized key runs as
    ONE [B, kN] @ [kN, D*(n+l)N] matmul instead of two row-block matmuls --
    same MACs, one wider matmul (the combined operator is a pure
    reshape/concat of the cached a1/a2 operators). Bit-identical either way
    (tests/test_conv_mxu.py); measured as a loss on the previous
    accelerator. Default OFF, opt-in."""
    return os.environ.get("RINGZK_FUSED_A", "0") == "1"


def _fused_a_dig(ck: CommitmentKey):
    """[kN, D*(n+l)N] int8 operator for [a1; a2], derived from the cached
    per-matrix operators. Layout proof: KeyOperator stores
    transpose(wd, (1,0,2)).reshape(kN, D*rowsN) with wd [D, kN, rowsN], and
    the row blocks of wd for the stacked key are exactly the concatenation
    of the two keys' wd along the rowsN axis -- so reshape-concat-reshape
    reconstructs KeyOperator([a1; a2]) without touching the host."""
    n_deg = ck.n_deg
    kn = ck.a1_dig.shape[0]
    d = conv_mxu.KEY_DIGITS
    rows1 = ck.a1.shape[-3]
    rows2 = ck.a2.shape[-3]
    return jnp.concatenate(
        [
            ck.a1_dig.reshape(kn, d, rows1 * n_deg),
            ck.a2_dig.reshape(kn, d, rows2 * n_deg),
        ],
        axis=-1,
    ).reshape(kn, d * (rows1 + rows2) * n_deg)


def matvec_key(ring: RingContext, ck: CommitmentKey, which: str, v, bound: int):
    """(key-matrix . v) mod q -> centered int32 [..., rows, N].

    which: 'a1', 'a2', or 'a' ([a1; a2] row-stacked). ``bound`` is a static
    exact bound on |v| coefficients, used to size the digit
    decomposition; v is clamped to it first. Clamping is sound at every call
    site: honest inputs respect the bound by construction (b-bounded r,
    clamped Gaussian y), and adversarial inputs exceeding it already fail
    the norm checks, making the algebra result irrelevant to the verdict.
    Falls back to the exact NTT path (no clamp needed there) when the key
    has no digit operator (batched keys / large N).
    """
    if which == "a":
        ndig = conv_mxu.digits_for_bound(bound)
        if (
            _use_fused_a()
            and ck.a1_dig is not None
            and ck.a2_dig is not None
            and ndig <= conv_mxu.KEY_DIGITS
        ):
            rows = ck.a1.shape[-3] + ck.a2.shape[-3]
            vc = jnp.clip(v, -bound, bound)
            return conv_mxu.matvec_digits(ring, _fused_a_dig(ck), rows, vc, ndig)
        lhs1 = matvec_key(ring, ck, "a1", v, bound)
        lhs2 = matvec_key(ring, ck, "a2", v, bound)
        return jnp.concatenate([lhs1, lhs2], axis=-2)
    dig = ck.a1_dig if which == "a1" else ck.a2_dig
    rows = (ck.a1 if which == "a1" else ck.a2).shape[-3]
    ndig = conv_mxu.digits_for_bound(bound)
    if dig is not None and ndig <= conv_mxu.KEY_DIGITS:
        vc = jnp.clip(v, -bound, bound)
        return conv_mxu.matvec_digits(ring, dig, rows, vc, ndig)
    a_hat = ck.a1_hat if which == "a1" else ck.a2_hat
    return mat.matvec(ring, a_hat, ring.fwd(v))


def _stacked_level() -> int:
    """Level for the stacked sibling full-key matvec (RINGZK_STACKED):
    sibling vectors that hit the key with the same bound in one phase ride
    ONE matvec_key dispatch with an extra leading stack axis instead of one
    dispatch each. Bit-identical by construction (matmul rows are
    independent; the digit fold is elementwise) and tested
    (tests/test_protocols.py). Levels:

      0 -- never stack.
      1 (default) -- stack sum's V+1-sibling concat only.
      2 -- also stack linear's 2-sibling pairs (measured as a loss on the
        previous accelerator: merging removes the two-matmul overlap XLA
        schedules itself).

    Like every RINGZK_* engine flag, read at *trace* time: a jit-cached
    prover/verifier keeps whichever level was active when it first traced,
    so benchmark A/Bs must use a fresh process per setting.
    """
    raw = os.environ.get("RINGZK_STACKED", "1")
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"RINGZK_STACKED must be an integer level (0/1/2), got {raw!r}"
        ) from None


def stack_siblings_ok(ck: CommitmentKey, bound: int, level: int = 1) -> bool:
    """True when sibling stacking at ``level`` may be applied: the digit
    engine must be the path actually taken (matvec_digits flattens ANY
    leading axes into the matmul row batch). The NTT fallback is excluded --
    with batched keys its broadcast aligns key-batch axes against the stack
    axis (mat.matvec_hat right-aligned prefixes), which is wrong, and for
    unbatched large-N keys stacking buys nothing measurable."""
    return (
        _stacked_level() >= level
        and ck.a1_dig is not None
        and ck.a2_dig is not None
        and conv_mxu.digits_for_bound(bound) <= conv_mxu.KEY_DIGITS
    )


def matvec_key_siblings(ring: RingContext, ck: CommitmentKey, vs, bound: int):
    """Full-key matvec for sibling vectors of one shape [..., k, N]: returns
    [matvec_key(ring, ck, 'a', v, bound) for v in vs], computed as a single
    stacked dispatch at RINGZK_STACKED>=2 (one matmul with len(vs)x the row
    batch; a measured loss at the default batch, see _stacked_level),
    per-vector dispatches otherwise. Bit-identical either way."""
    if len(vs) > 1 and stack_siblings_ok(ck, bound, level=2):
        out = matvec_key(ring, ck, "a", jnp.stack(vs, axis=-3), bound)
        return [out[..., i, :, :] for i in range(len(vs))]
    return [matvec_key(ring, ck, "a", v, bound) for v in vs]


def chained_roundtrip(fn, key, inputs, chains: int, min_ndims):
    """Run ``fn(key_i, *input_slices)`` over ``chains`` independent splits
    of the leading batch axis and concatenate the (ok, op_ok) pairs.

    The 3-move protocols' data dependencies serialize matvec phases
    against transform/sampling phases inside one program; independent
    chains give XLA's scheduler cross-chain overlap across those walls.
    Same per-proof semantics and work; each chain consumes its own derived
    key.

    ``min_ndims`` gives each input's rank WITH a proof-batch axis (e.g. 3
    for open's x [B, l, N]): the leading axis of an unbatched input is a
    protocol STRUCTURE axis (message rows l, summands V), and splitting it
    would silently prove a different statement -- rejected here.
    """
    inputs = tuple(jnp.asarray(a) for a in inputs)  # lists/scalars -> arrays
    if any(a.ndim < 1 for a in inputs):
        raise ValueError("chained roundtrips need batched array inputs")
    b = inputs[0].shape[0]
    if (
        any(a.ndim < m for a, m in zip(inputs, min_ndims))
        or any(a.shape[0] != b for a in inputs)
        or b % chains
    ):
        raise ValueError(
            f"chains={chains} needs a shared leading proof-batch axis "
            f"divisible by it (shapes {[a.shape for a in inputs]}; an "
            "unbatched call cannot be chained)"
        )
    split = [
        a.reshape((chains, b // chains) + a.shape[1:]) for a in inputs
    ]
    outs = [
        fn(ki, *(a[i] for a in split))
        for i, ki in enumerate(jax.random.split(key, chains))
    ]
    return (
        jnp.concatenate([o[0] for o in outs]),
        jnp.concatenate([o[1] for o in outs]),
    )


def commit_ok(params: Params, n_deg: int, r) -> jax.Array:
    """Commit constraint: every polynomial r_i has ||r_i||_2 <= 4 sigma
    sqrt(N) (/root/reference/src/params.rs:102-108). r: [..., k, N] ->
    bool [...] (all-k reduced)."""
    return jnp.all(norms.norm2_leq(r, params.commit_bound(n_deg)), axis=-1)


def verify_ok(params: Params, n_deg: int, z) -> jax.Array:
    """Verification constraint ||z_i||_2 <= 2 sigma sqrt(N)
    (/root/reference/src/params.rs:112-118)."""
    return jnp.all(norms.norm2_leq(z, params.verify_bound(n_deg)), axis=-1)


@annotate("commit_scheme/commit")
def commit(key, ck: CommitmentKey, x, params: Params):
    """Commit to x: [..., l, N] -> (Opening, Commitment), batched.

    The reference loops resampling r until the commit constraint holds
    (/root/reference/src/commit.rs:98-107); for any valid parameter set the
    constraint is implied by |r| <= b (b sqrt(N) << 4 sigma sqrt(N) since
    sigma >= 11 kappa b), so one masked backup resample round is ample.
    """
    n_deg = x.shape[-1]
    ring = get_ring(n_deg, params.modulus)
    batch = x.shape[:-2]
    ka, kb = jax.random.split(key)
    r = sampling.uniform_centered(ka, batch + (params.k,), n_deg, params.b)

    # Static reachability: any |coeff| <= b draw has norm_2 <= b*sqrt(N);
    # when that can never exceed the commit bound, the reference's rejection
    # loop (/root/reference/src/commit.rs:98-107) provably runs exactly one
    # iteration, so the constraint check and backup resample are dead code
    # (true for every valid parameter set: sigma >= 11*kappa*b).
    cb = params.commit_bound(n_deg)
    if n_deg * params.b * params.b > cb * cb + 2 * cb:
        ok = commit_ok(params, n_deg, r)  # [...] bool
        r2 = sampling.uniform_centered(kb, batch + (params.k,), n_deg, params.b)
        r = jnp.where(ok[..., None, None], r, r2)

    c = _commit_value(ring, ck, x, r, params)
    return Opening(x=x, r=r), Commitment(c=c)


def _zero_pad_rows(x, n_rows: int):
    """[0_n; x] along the rows axis: [..., l, N] -> [..., n+l, N]."""
    zeros = jnp.zeros(x.shape[:-2] + (n_rows, x.shape[-1]), x.dtype)
    return jnp.concatenate([zeros, x], axis=-2)


def _commit_value(ring: RingContext, ck: CommitmentKey, x, r, params: Params):
    """c = [a1; a2] . r + [0_n; x]. Honest r has |coeffs| <= b."""
    from ..ops import zq

    ar = matvec_key(ring, ck, "a", r, params.b)
    return zq.add_centered(ring.qctx, ar, _zero_pad_rows(x, params.n))


@annotate("commit_scheme/verify")
def verify(
    ck: CommitmentKey,
    com: Commitment,
    opening: Opening,
    params: Params,
    *,
    honest_r_bound: int | None = None,
):
    """Opening verification incl. the relaxation factor f
    (/root/reference/src/commit.rs:173-210):
        f . c == [a1; a2] . r + f . [0_n; x]   (f None => identity)
    Returns bool [...] with all structure axes reduced.

    ``honest_r_bound``: optional exact static bound on |r| coefficients,
    sound ONLY when the caller constructed the opening itself (the
    roundtrips pass params.b for their own commit's r). The verification
    result is bit-identical for any r within the bound; the point is that
    a matching bound lets XLA CSE this A.r matvec with the commit's own
    (same digit count, same operands) instead of re-running it at the
    adversarial 3-digit width -- one of the four digit matvecs in every
    self-verified roundtrip disappears. Leave None for openings from the
    wire."""
    x, r, f = opening
    n_deg = x.shape[-1]
    ring = get_ring(n_deg, params.modulus)

    from ..ops import zq

    ok = commit_ok(params, n_deg, r)

    # adversarial r: clamp bound = the commit constraint itself (a passing r
    # has every |coeff| <= norm_2 <= 4 sigma sqrt(N); a failing r rejects
    # regardless of the algebra)
    ar = matvec_key(
        ring, ck, "a", r,
        honest_r_bound if honest_r_bound is not None
        else params.commit_bound(n_deg),
    )
    zfull = _zero_pad_rows(x, params.n)
    if f is None:
        rhs = zq.add_centered(ring.qctx, ar, zfull)
        lhs = com.c
    else:
        f_hat = ring.fwd_const(f)
        fz = ring.inv(mat.scalar_mul_hat(ring, f_hat, ring.fwd(zfull)))
        rhs = zq.add_centered(ring.qctx, ar, fz)
        lhs = ring.inv(mat.scalar_mul_hat(ring, f_hat, ring.fwd(com.c)))
    return ok & mat.poly_equal(lhs, rhs, struct_axes=1)
