"""Negacyclic matrix-vector products as int8 digit matrix products.

The hot ops of every protocol phase are matvecs against the *fixed*
commitment key matrices: A.r (commit), a1.y / a1.z (proof phases), a2.y /
a2.z (linear/sum). The CRT-NTT engine runs them as pointwise products in
the NTT domain; this module instead maps them onto one int8 x int8 ->
int32 matrix product, the operation matrix units run fastest:

  * the key matrix A [rows, k, N] becomes a negacyclic block-circulant
    operator W [k*N, rows*N] (column (row, j) is the negacyclic shift of
    a[row, t, :]), decomposed once into balanced base-256 digits
    (d in [-128, 127], 4 digits cover residues up to |v| <= 2.14e9, i.e.
    any q/2 for the parameter sets in scope);
  * a batch of input vectors v [B, k, N] (small-bounded: ternary r needs 1
    digit, Gaussian y / response z need 3) is digit-decomposed on device;
  * out[dv, dw] = v_digits[dv] @ W_digits[dw] is one s8 x s8 -> s32
    ``dot_general`` with exact int32 accumulation (|products| <= 128*128;
    contraction k*N < 2^15 keeps even a KEY_DIGITS-plane shift-group sum
    < 2^31);
  * digit planes are grouped by total shift s = dv + dw (partial sums stay
    int32-exact under the k*N gate) and folded mod q with one Montgomery
    multiply per shift.

The result equals ring.inv(matvec_hat(...)) bit-for-bit (tested in
tests/test_conv_mxu.py). Falls back to the NTT path for batched keys
(operator is per-key) or when operand bounds exceed digit capacity -- see
protocols.commit.

Replaces the reference's `Mat::dot` O(N^2) schoolbook hot loop
(ring-zk src/mat.rs:95-115) -- same semantics, as a matrix product.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from .ntt import RingContext

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS            # 256: balanced digits in [-128, 127]
KEY_DIGITS = 4                     # covers |v| <= 2.14e9 >= q/2 for q < 2^32-12M


def digits_for_bound(bound: int) -> int:
    """Number of balanced base-256 digits covering |v| <= bound.

    Uses the symmetric-safe capacity 127*(1 + 256 + ...) (the negative side
    reaches -128*(...) but the positive side caps at 127*(...))."""
    d = 1
    cap = RADIX // 2 - 1           # 127
    while cap < bound:
        cap = cap * RADIX + RADIX // 2 - 1
        d += 1
    return d


def _balanced_digits_host(a: np.ndarray, ndig: int) -> np.ndarray:
    """Host-side balanced digit decomposition -> [ndig, ...] int8."""
    v = a.astype(object).copy()
    out = np.empty((ndig,) + a.shape, np.int8)
    for i in range(ndig):
        d = ((v + RADIX // 2) % RADIX) - RADIX // 2
        out[i] = d.astype(np.int8)
        v = (v - d) // RADIX
    assert (v == 0).all(), "digit capacity exceeded"
    return out


def balanced_digits(v, ndig: int):
    """On-device balanced digit decomposition of int32 [...] -> [ndig, ...]
    int8. Caller guarantees |v| fits ndig digits (clamp first if adversarial;
    see protocols for the clamp-is-sound argument).

    Closed form: v = sum_i d_i 256^i with d_i in [-128, 127] iff
    v + B = sum_i (d_i + 128) 256^i with B = sum_i 128*256^i -- i.e. the
    balanced digits are the *unsigned* base-256 digits of the biased value,
    minus 128. Each digit is therefore an independent shift/mask of one
    uint32 (v + B fits: capacity(ndig) + B = 256^ndig - 1 <= 2^32 - 1),
    with no sequential borrow chain -- XLA fuses all digits into a single
    pass with int8 outputs instead of materializing int32 intermediates.
    """
    v = jnp.asarray(v, jnp.int32)
    bias = sum((RADIX // 2) << (RADIX_BITS * i) for i in range(ndig))
    u = jax.lax.bitcast_convert_type(v, jnp.uint32) + np.uint32(bias)
    half = np.int32(RADIX // 2)
    outs = [
        (
            ((u >> np.uint32(RADIX_BITS * i)) & np.uint32(RADIX - 1)).astype(
                jnp.int32
            )
            - half
        ).astype(jnp.int8)
        for i in range(ndig)
    ]
    return jnp.stack(outs, 0)


class KeyOperator:
    """Digitized negacyclic block-circulant operator for a fixed key matrix.

    a: [rows, k, N] int32 centered -> W_digits: [KEY_DIGITS, k*N, rows*N]
    int8 (host-precomputed, device-resident).
    """

    def __init__(self, a: np.ndarray, ring: RingContext):
        a = np.asarray(a)
        if a.ndim != 3:
            raise ValueError(f"key operator needs [rows, k, N], got {a.shape}")
        rows, k, n = a.shape
        if KEY_DIGITS * k * n * (RADIX // 2) ** 2 >= 2**31:
            # per-plane sums are bounded by kN*128^2 and up to KEY_DIGITS
            # planes share one shift group in matvec_digits
            raise ValueError("contraction too long for exact int32 accumulation")
        self.rows, self.k, self.n = rows, k, n
        self.ring = ring

        # W[t*N + i, row*N + j] = sign * a[row, t, (j - i) mod N],
        # sign = -1 where i > j (negacyclic wraparound x^N = -1)
        i_idx = np.arange(n)[:, None]            # input coeff index
        j_idx = np.arange(n)[None, :]            # output coeff index
        shift = (j_idx - i_idx) % n              # [N, N]
        sign = np.where(i_idx <= j_idx, 1, -1)   # [N, N]
        # build [k*N, rows*N]
        w = np.empty((k * n, rows * n), np.int64)
        for t in range(k):
            for row in range(rows):
                blk = a[row, t][shift] * sign    # [N, N]
                w[t * n : (t + 1) * n, row * n : (row + 1) * n] = blk
        wd = _balanced_digits_host(w, KEY_DIGITS)          # [D, kN, rowsN]
        # one [kN, D*rowsN] rhs so every digit of the key is covered by a
        # single (B x kN) @ (kN x D*rowsN) matmul
        self.w_digits = jnp.asarray(
            np.transpose(wd, (1, 0, 2)).reshape(k * n, KEY_DIGITS * rows * n)
        )

    def matvec(self, v, v_digits: int):
        """v: [..., k, N] int32 with |v| within v_digits capacity.
        Returns centered int32 [..., rows, N] == (A . v) mod q."""
        return matvec_digits(
            self.ring, self.w_digits, self.rows, v, v_digits
        )


def matvec_digits(ring: RingContext, w_digits, rows: int, v, v_digits: int):
    """Digit-matmul negacyclic matvec against a prebuilt [kN, D*rowsN] int8
    operator. Exact mod q, centered int32 result, bit-identical to the NTT
    path."""
    qc = ring.qctx
    kn = w_digits.shape[0]
    n = v.shape[-1]
    batch = v.shape[:-2]
    bflat = 1
    for d in batch:
        bflat *= d

    vd = balanced_digits(v.reshape((bflat, kn)), v_digits)   # [dv, B, kN]
    # single batched int8 matmul: [dv*B, kN] @ [kN, D*rowsN] -> int32
    prod = jax.lax.dot_general(
        vd.reshape(v_digits * bflat, kn),
        w_digits,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(v_digits, bflat, KEY_DIGITS, rows * n)

    # group planes by total shift s = dv + dw: partial sums stay int32-exact
    n_shift = v_digits + KEY_DIGITS - 1
    groups = [None] * n_shift
    for dv in range(v_digits):
        for dw in range(KEY_DIGITS):
            s = dv + dw
            p = prod[dv, :, dw]
            groups[s] = p if groups[s] is None else groups[s] + p

    # fold digit groups mod q: out = sum_s G_s * RADIX^s. Default: one REDC
    # per group element -- mont_mul is exact for ANY uint32 left operand,
    # so the two's-complement bits of the int32 group sum feed it directly
    # (u = g + 2^32*[g<0]) and the negative-lane excess is removed with a
    # precomputed (2^32 * RADIX^s mod q) conditional subtract, replacing
    # the old reduce_i32_centered + mont_mul chain (two REDCs). Bit-
    # identical either way (same value mod q; tests/test_conv_mxu.py).
    # RINGZK_FOLD_LEGACY=1 restores the two-REDC form (trace-time flag,
    # like every RINGZK_* switch).
    legacy = os.environ.get("RINGZK_FOLD_LEGACY", "0") == "1"
    acc = None
    for s, g in enumerate(groups):
        if legacy:
            gu = qc.reduce_i32_centered(g)
            term = qc.mont_mul(gu, jnp.uint32(_shift_mont(ring, s)))
        else:
            u = jax.lax.bitcast_convert_type(g, jnp.uint32)
            term = qc.mont_mul(u, jnp.uint32(_shift_mont(ring, s)))
            corr = jnp.where(
                g < 0, jnp.uint32(_shift_neg_corr(ring, s)), jnp.uint32(0)
            )
            term = qc.sub(term, corr)
        acc = term if acc is None else qc.add(acc, term)
    out = ring.to_centered(acc)
    return out.reshape(batch + (rows, n))


def _shift_mont(ring: RingContext, s: int) -> int:
    """RADIX^s * R mod q (host constant, cached on the ring)."""
    cache = ring.__dict__.setdefault("_shift_mont_cache", {})
    if s not in cache:
        cache[s] = ring.qctx.h_to_mont(pow(RADIX, s, ring.q))
    return cache[s]


def _shift_neg_corr(ring: RingContext, s: int) -> int:
    """(2^32 * RADIX^s) mod q: the excess a negative int32 group sum's
    two's-complement bits contribute through the single-REDC fold."""
    cache = ring.__dict__.setdefault("_shift_neg_corr_cache", {})
    if s not in cache:
        cache[s] = (pow(2, 32, ring.q) * pow(RADIX, s, ring.q)) % ring.q
    return cache[s]


def digit_capacity(ndig: int) -> int:
    """Max |v| exactly representable in ndig balanced base-256 digits
    (symmetric-safe bound; see digits_for_bound)."""
    cap = RADIX // 2 - 1
    for _ in range(ndig - 1):
        cap = cap * RADIX + RADIX // 2 - 1
    return cap


def build_operator_digits(a: np.ndarray, ring: RingContext):
    """[rows, k, N] int32 -> ([kN, D*rowsN] int8 jnp array, rows)."""
    op = KeyOperator(np.asarray(a), ring)
    return op.w_digits


def build_operator_digits_device(a, ring: RingContext):
    """Device-side KeyOperator construction: same [kN, KEY_DIGITS*rowsN]
    int8 operator as KeyOperator/_balanced_digits_host, but computed with
    jnp ops on a device-resident key (bit-identical, tested).

    keygen builds the operator here, next to the key it was sampled into:
    no device-to-host copy of the key and no host-side N^2 loop.
    """
    a = jnp.asarray(a, jnp.int32)
    if a.ndim != 3:
        raise ValueError(f"key operator needs [rows, k, N], got {a.shape}")
    rows, k, n = a.shape
    if KEY_DIGITS * k * n * (RADIX // 2) ** 2 >= 2**31:
        # same group-sum capacity bound as KeyOperator
        raise ValueError("contraction too long for exact int32 accumulation")

    # W[t*N + i, row*N + j] = sign * a[row, t, (j - i) mod N]  (static gather)
    i_idx = np.arange(n)[:, None]
    j_idx = np.arange(n)[None, :]
    shift = jnp.asarray((j_idx - i_idx) % n)            # [N, N] indices
    sign = jnp.asarray(np.where(i_idx <= j_idx, 1, -1), jnp.int32)
    blk = a[:, :, shift] * sign                          # [rows, k, N, N]
    w = jnp.transpose(blk, (1, 2, 0, 3)).reshape(k * n, rows * n)
    wd = balanced_digits(w, KEY_DIGITS)                  # [D, kN, rowsN]
    return jnp.transpose(wd, (1, 0, 2)).reshape(k * n, KEY_DIGITS * rows * n)
