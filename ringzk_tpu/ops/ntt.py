"""Negacyclic NTT polynomial multiplication over Z_q[x]/(x^N + 1) via CRT.

This replaces the reference's O(N^2) schoolbook negacyclic multiply (the hot
loop inside `Mat::dot`, /root/reference/src/mat.rs:95-115, delegating to
`poly_ring_xnp1::Polynomial` operator impls) with an O(N log N) pipeline that
is exact for the reference modulus q = 3515337053.

Why CRT: q - 1 = 2^2 * m with odd m (q == 5 mod 8), so Z_q has no 2N-th root
of unity for N >= 4 and no psi-twisted NTT exists in the native modulus.
Instead we compute the exact *integer* negacyclic convolution by CRT over
three NTT-friendly 30-bit primes (product M ~ 2^89 far exceeds the coefficient
bound N * (q/2)^2 * k), then reduce the reconstructed integer mod q.

Everything is uint32 Montgomery arithmetic (see ops.montgomery) -- no 64-bit
integers, no divisions -- and jit/vmap/shard_map friendly. On a GPU the
transforms run as one fused kernel each (ops/ntt_kernel.py); elsewhere, and
inside sharded programs, as the XLA stage chain below. The per-prime axis
P=3 is the leading axis of every NTT-domain array and is itself shardable
across devices (a tensor-parallel axis; see ringzk_tpu.parallel).

Shapes: a polynomial batch is ``[..., N]`` int32 (centered residues); its
NTT-domain image is ``[P, ..., N]`` uint32. Wide rings (modulus >= 2^32,
the reference's full ZqI64 domain) carry int64 residues externally and
extend the prime axis -- see :class:`RingContext.wide` and ops/mont64.py;
the NTT domain itself is identical.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .montgomery import MontCtx

# Three classic NTT primes: p = c * 2^s + 1 with large 2-adicity s >= 23,
# supporting psi-twisted negacyclic NTTs for any power-of-two N <= 2^22.
PRIMES = (998244353, 754974721, 167772161)   # 119*2^23+1, 45*2^24+1, 5*2^25+1
GENERATORS = (3, 11, 3)
NUM_PRIMES = len(PRIMES)
M_PROD = PRIMES[0] * PRIMES[1] * PRIMES[2]

# Extension primes for WIDE rings (modulus >= 2^32, the reference's full
# ZqI64 domain -- /root/reference/src/params.rs:18,121-127). All are
# p = c * 2^s + 1 with s >= 23 and p < 2^31 (Shoup butterflies), appended
# to PRIMES until the CRT range covers 2 * ACC_MAX * N * (q/2)^2; the
# 8-prime product ~2^240 covers any odd q < 2^63 at any N <= 2^22.
# Narrow rings (q < 2^32) always use exactly PRIMES -- bit-compat with the
# committed transcript goldens.
EXT_PRIMES = (469762049, 2013265921, 2130706433, 1811939329, 2113929217)
EXT_GENERATORS = (3, 31, 3, 13, 5)


# Traced transforms use the XLA stage chain while this stack is non-empty
# (see xla_transforms).
_XLA_ONLY: list = []


@contextlib.contextmanager
def xla_transforms():
    """Trace the transforms inside this block with the XLA stage chain
    instead of the fused GPU kernel (ops/ntt_kernel.py).

    The sharded programs (parallel/) trace under it: GSPMD partitions the
    chain's elementwise ops along the batch axis, while a kernel call is an
    opaque custom call it would gather onto every device. Like the kernel
    gate itself, it acts at trace time: a jit-compiled caller keeps the
    engine it was traced with."""
    _XLA_ONLY.append(True)
    try:
        yield
    finally:
        _XLA_ONLY.pop()


def _use_kernel() -> bool:
    """The fused NTT kernel runs wherever JAX's default backend is a GPU
    (any number of cards), outside :func:`xla_transforms`; everywhere else
    the XLA stage chain runs. Read at trace time."""
    return not _XLA_ONLY and jax.default_backend() == "gpu"


def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _prime_tables(p: int, g: int, n: int):
    """Twiddle tables for modulus p, ring degree n (returns numpy uint32).

    psi_rev[i]     = psi^{bitrev(i)} mod p,   psi a primitive 2n-th root
    psi_inv_rev[i] = psi^{-bitrev(i)} mod p   (both plain form)
    n_inv_scale    = (N^{-1} mod p, shoup companion) -- final INTT scaling

    Also returns per-stage *lane-resident* twiddle planes for the roll-based
    butterflies (see _fwd_one): w_fwd[0, s, i] = psi_rev[m + (i >> (logn-s))]
    for forward stage s (m = 2^s groups) and w_fwd[1] its Shoup companion
    floor(w << 32 / p) (twiddles are static constants, so butterflies use
    Shoup's trick -- ~40% fewer lane ops than Montgomery REDC); analogous
    inverse planes.
    """
    ctx = MontCtx.make(p)
    logn = n.bit_length() - 1
    assert 1 << logn == n, "N must be a power of two"
    assert (p - 1) % (2 * n) == 0, f"prime {p} lacks 2N-th roots for N={n}"
    assert p < 2**31, "Shoup butterflies require p < 2^31"
    psi = pow(g, (p - 1) // (2 * n), p)
    # order check: psi must be a primitive 2N-th root (psi^N == -1), which
    # requires g to generate the full 2-Sylow subgroup -- guards the
    # EXT_PRIMES generator table against a non-primitive entry (a wrong g
    # would corrupt every transform silently)
    assert pow(psi, n, p) == p - 1, f"generator {g} not primitive for {p}"
    psi_inv = pow(psi, -1, p)
    psi_rev = np.empty(n, dtype=np.uint32)
    psi_inv_rev = np.empty(n, dtype=np.uint32)
    for i in range(n):
        br = _bit_reverse(i, logn)
        psi_rev[i] = pow(psi, br, p)
        psi_inv_rev[i] = pow(psi_inv, br, p)
    n_inv = pow(n, -1, p)
    n_inv_scale = (n_inv, ctx.h_shoup(n_inv))

    def shoup_plane(w):
        return ((w.astype(object) << 32) // p).astype(np.uint32)

    lanes = np.arange(n)
    w_fwd = np.empty((2, logn, n), dtype=np.uint32)
    for s in range(logn):           # stage s: m = 2^s groups, t = n >> (s+1)
        m = 1 << s
        t = n >> (s + 1)
        w_fwd[0, s] = psi_rev[m + (lanes >> (logn - s))]
        assert (lanes >> (logn - s) == lanes // (2 * t)).all()
    w_fwd[1] = shoup_plane(w_fwd[0])
    w_inv = np.empty((2, logn, n), dtype=np.uint32)
    for s in range(logn):           # stage s: t = 2^s, h = n >> (s+1) groups
        t = 1 << s
        h = n >> (s + 1)
        w_inv[0, s] = psi_inv_rev[h + (lanes >> (s + 1))]
    w_inv[1] = shoup_plane(w_inv[0])
    return psi_rev, psi_inv_rev, n_inv_scale, w_fwd, w_inv


def _partner_swap(x, t: int):
    """x[i ^ t] along the lane axis via two static rolls + a select.

    Static rolls and elementwise selects keep the butterfly network fully
    vectorized along the coefficient axis -- no small-trailing-dim
    reshapes, no gathers -- and partitionable by GSPMD on any axis.
    """
    n = x.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    is_lo = (lane & jnp.uint32(t)) == 0
    return jnp.where(is_lo, jnp.roll(x, -t, axis=-1), jnp.roll(x, t, axis=-1)), is_lo


def _fwd_one(ctx: MontCtx, w_fwd, x):
    """Forward negacyclic NTT (Cooley-Tukey, natural in / bit-reversed out).

    x: uint32 [..., N] in [0, p). Roll-based butterflies: at stage s the
    pair partner of lane i is i ^ t (t = N >> (s+1)); for lo lanes
    new = x + w*x[partner], for hi lanes new = x[partner] - w*x.
    w_fwd: [2, log2(N), N] per-lane twiddle planes (plain, shoup).
    """
    n = x.shape[-1]
    logn = n.bit_length() - 1
    for s in range(logn):
        t = n >> (s + 1)
        xs, is_lo = _partner_swap(x, t)
        prod = ctx.shoup_mul(w_fwd[0, s], w_fwd[1, s], jnp.where(is_lo, xs, x))
        x = jnp.where(is_lo, ctx.add(x, prod), ctx.sub(xs, prod))
    return x


def _inv_one(ctx: MontCtx, w_inv, n_inv_scale, x):
    """Inverse negacyclic NTT (Gentleman-Sande, bit-reversed in / natural
    out), fused N^{-1} scaling. At stage s (t = 2^s): lo lanes
    new = x + x[partner]; hi lanes new = (x[partner] - x) * w.
    n_inv_scale: (plain, shoup) pair."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    for s in range(logn):
        t = 1 << s
        xs, is_lo = _partner_swap(x, t)
        x = jnp.where(
            is_lo,
            ctx.add(x, xs),
            ctx.shoup_mul(w_inv[0, s], w_inv[1, s], ctx.sub(xs, x)),
        )
    return ctx.shoup_mul(
        jnp.uint32(n_inv_scale[0]), jnp.uint32(n_inv_scale[1]), x
    )


@dataclasses.dataclass(frozen=True)
class RingContext:
    """All static state for exact arithmetic in Z_q[x]/(x^N + 1).

    q is the ring modulus (the reference's ZqI64 const, 3515337053 for the
    default parameter set -- /root/reference/src/params.rs:121-127); residues
    are presented externally as *centered* int32 in [-(q-1)/2, (q-1)/2].
    """

    n: int
    q: int

    # Max NTT-domain accumulation terms guaranteed exact (k-dim matvecs etc.)
    ACC_MAX = 16

    def __post_init__(self):
        if self.n & (self.n - 1) or self.n < 2:
            raise ValueError(f"N must be a power of two >= 2, got {self.n}")
        if self.q % 2 == 0 or self.q >= 2**63:
            raise ValueError("q must be odd and < 2^63 (the ZqI64 domain)")
        # Exactness bound: worst-case |integer conv coeff| <= N*(q/2)^2 per
        # product term; callers may accumulate up to ACC_MAX terms. The
        # prime-set property below sizes the CRT range to cover it (narrow
        # rings use exactly PRIMES for golden-transcript compatibility).
        bound = self.n * (self.q // 2 + 1) ** 2 * self.ACC_MAX * 2
        if not self.wide:
            if bound > M_PROD:
                raise ValueError("CRT bound exceeded; add primes or shrink N*q^2")
        else:
            prod = 1
            for p, _ in self._wide_prime_list():
                prod *= p
            if bound > prod:
                raise ValueError(
                    f"q={self.q} at N={self.n} exceeds the full CRT range"
                )
            import jax

            if not jax.config.jax_enable_x64:
                raise ValueError(
                    "modulus >= 2^32 needs int64 arrays: enable jax x64 "
                    "(jax.config.update('jax_enable_x64', True) or "
                    "JAX_ENABLE_X64=1)"
                )

    @property
    def wide(self) -> bool:
        """True for moduli >= 2^32: centered residues are int64, the mod-q
        fold runs on ops.mont64 uint32 limb pairs, and the prime set extends
        past PRIMES as needed. The NTT domain itself is identical."""
        return self.q >= 2**32

    @property
    def dtype(self):
        return jnp.int64 if self.wide else jnp.int32

    def _wide_prime_list(self):
        bound = self.n * (self.q // 2 + 1) ** 2 * self.ACC_MAX * 2
        out = []
        prod = 1
        for p, g in zip(PRIMES + EXT_PRIMES, GENERATORS + EXT_GENERATORS):
            out.append((p, g))
            prod *= p
            if prod > bound:
                break
        return tuple(out)

    @functools.cached_property
    def primes(self):
        """The ring's CRT prime set (== PRIMES for narrow rings)."""
        if not self.wide:
            return PRIMES
        return tuple(p for p, _ in self._wide_prime_list())

    @functools.cached_property
    def generators(self):
        if not self.wide:
            return GENERATORS
        return tuple(g for _, g in self._wide_prime_list())

    @property
    def num_primes(self) -> int:
        return len(self.primes)

    @functools.cached_property
    def mont(self):
        return tuple(MontCtx.make(p) for p in self.primes)

    @functools.cached_property
    def qctx(self):
        """Mod-q scalar context: MontCtx (uint32) for narrow rings,
        Mont64Ctx (uint32 limb pairs) for wide ones. ops.zq dispatches."""
        if self.wide:
            from .mont64 import Mont64Ctx

            return Mont64Ctx.make(self.q)
        return MontCtx.make(self.q)

    @functools.cached_property
    def _tables(self):
        return tuple(
            _prime_tables(p, g, self.n)
            for p, g in zip(self.primes, self.generators)
        )

    def _garner(self, num: int):
        """Constants for Garner mixed-radix CRT over the first ``num`` primes
        + final mod-q fold. Cached per subset size.

        Narrow rings: k_mont/m_mod_q are uint32 Montgomery constants.
        Wide rings: k_mont entries are (lo, hi) Mont64 pairs (K_i * 2^64
        mod q) and m_mod_q is a plain (lo, hi) pair -- ops.mont64 folds.
        """
        cache = self.__dict__.setdefault("_garner_cache", {})
        if num in cache:
            return cache[num]
        ps = self.primes[:num]
        prod = 1
        for p in ps:
            prod *= p
        half = prod // 2
        q = self.q
        c_mont = []      # ((prod of earlier primes)^{-1} mod p_i) in mont form
        k_mont = []      # (prod of earlier primes mod q) in mont form
        half_digits = []
        acc = 1
        rem = half
        for i, p in enumerate(ps):
            if i > 0:
                c_mont.append(MontCtx.make(p).h_to_mont(pow(acc, -1, p)))
                k_mont.append(self.qctx.h_to_mont(acc % q))
            half_digits.append(rem % p)
            rem //= p
            acc *= p
        if self.wide:
            m_mod_q = (
                np.uint32((prod % q) & 0xFFFFFFFF),
                np.uint32((prod % q) >> 32),
            )
        else:
            m_mod_q = prod % q
        out = dict(
            c_mont=c_mont,
            k_mont=k_mont,
            m_mod_q=m_mod_q,
            half_digits=tuple(half_digits),
        )
        cache[num] = out
        return out

    # ------------------------------------------------------------------
    # Forward / inverse transforms
    # ------------------------------------------------------------------

    def fwd(self, x, num: int | None = None):
        """Centered int32/int64 [..., N] -> plain NTT domain uint32
        [num, ..., N].

        Form discipline: *data* arrays stay in plain residue form; anything
        that multiplies data (keys, challenges d, scalars g, factors f) must
        be transformed with :meth:`fwd_const` instead, so every
        ``dot_hat(const, data)`` Montgomery product lands back in plain form
        and :meth:`inv` needs no correction factor.

        ``num`` selects a CRT prime subset for cheap products with small
        exact bounds (e.g. d*r with ternary operands fits one prime). The
        caller must guarantee |integer coeff| < prod(primes[:num]) / 2; use
        :meth:`primes_needed` to pick num from a bound.
        """
        if num is None:
            num = self.num_primes
        if self.wide:
            return self._fwd_wide(x, num)
        if _use_kernel():
            from . import ntt_kernel

            return ntt_kernel.fwd(self, x, num)
        outs = []
        for i in range(num):
            ctx = self.mont[i]
            w_fwd = self._tables[i][3]
            xi = ctx.reduce_i32_centered(x)
            outs.append(_fwd_one(ctx, jnp.asarray(w_fwd), xi))
        return jnp.stack(outs, axis=0)

    def _fwd_wide(self, x, num: int):
        """Wide-ring forward: centered int64 in, per-prime butterflies as
        usual. The int64 -> mod-p reduction is limb-wise uint32 arithmetic
        (x = lo + hi_signed * 2^32), never a 64-bit multiply."""
        from .mont64 import Mont64Ctx

        lo, hi = Mont64Ctx.split_i64(jnp.asarray(x, jnp.int64))
        outs = []
        for i in range(num):
            ctx = self.mont[i]
            w_fwd = self._tables[i][3]
            shift = jnp.uint32(ctx.h_to_mont((1 << 32) % ctx.p))
            xi = ctx.add(
                ctx.reduce_u32(lo),
                ctx.mont_mul(ctx.reduce_i32_centered(hi), shift),
            )
            outs.append(_fwd_one(ctx, jnp.asarray(w_fwd), xi))
        return jnp.stack(outs, axis=0)

    def fwd_const(self, x, num: int | None = None):
        """fwd() then per-prime to-Montgomery: the required form for the
        multiplicative operand of dot_hat/scalar muls."""
        if num is None:
            num = self.num_primes
        h = self.fwd(x, num)
        return jnp.stack([self.mont[i].to_mont(h[i]) for i in range(num)], axis=0)

    def primes_needed(self, bound: int) -> int:
        """Smallest prime-subset size whose CRT range covers |coeff| <= bound."""
        prod = 1
        for i, p in enumerate(self.primes):
            prod *= p
            if prod > 2 * bound:
                return i + 1
        raise ValueError(f"bound 2^{bound.bit_length()} exceeds full CRT range")

    def inv(self, xhat):
        """Plain NTT domain uint32 [P, ..., N] -> centered int32 [..., N].

        Input must be in plain residue form: either a fwd() output, or any
        sum of dot_hat(const-form, plain-form) products. Performs per-prime
        inverse NTTs, Garner mixed-radix CRT reconstruction of the exact
        signed integer coefficient, and centered reduction mod q -- all
        division-free uint32 ops.

        DEPTH-ONE RULE: between fwd() and inv(), apply at most ONE ring
        multiplication per term (plus <= ACC_MAX accumulated terms). The CRT
        range M only covers |coeff| <= ACC_MAX * N * (q/2)^2; a chained
        product like g*(A.y) must reduce the inner product mod q (inv + fwd)
        before the outer multiply, or reconstruction silently wraps mod M.
        """
        num = xhat.shape[0]
        if _use_kernel() and not self.wide:
            from . import ntt_kernel

            return ntt_kernel.inv(self, xhat)
        ys = []
        for i in range(num):
            ctx = self.mont[i]
            n_inv_scale, w_inv = self._tables[i][2], self._tables[i][4]
            ys.append(_inv_one(ctx, jnp.asarray(w_inv), n_inv_scale, xhat[i]))
        return self._crt_to_centered(ys)

    def _crt_to_centered(self, ys):
        """Garner reconstruction of [y mod p_i] -> centered int32 (int64 for
        wide rings) mod q, for any prime-subset size len(ys)."""
        if self.wide:
            lo, hi = self._crt_to_pair(ys)
            return self.qctx.to_centered_i64(lo, hi)
        num = len(ys)
        g = self._garner(num)
        vs, gt = self._crt_digits(ys, g)
        # x mod q = sum_i v_i * (prod_{j<i} p_j mod q)  -  [x>M/2]*(M mod q)
        qc = self.qctx
        acc = qc.reduce_u32(vs[0])
        for i in range(1, num):
            acc = qc.add(acc, qc.mont_mul(vs[i], jnp.uint32(g["k_mont"][i - 1])))
        acc = qc.sub(acc, jnp.where(gt, jnp.uint32(g["m_mod_q"]), jnp.uint32(0)))
        return self.to_centered(acc)

    def _crt_digits(self, ys, g):
        """Garner mixed-radix digits of [y mod p_i] plus the signed-
        centering flag: x = v0 + v1*p0 + v2*p0*p1 + ... with 0 <= v_i < p_i,
        gt = (x > floor(M/2)) via lexicographic digit compare (most
        significant digit last). Pure uint32 -- shared by the XLA paths and
        the fused inverse kernel (ops/ntt_kernel.py)."""
        num = len(ys)
        vs = [ys[0]]
        for i in range(1, num):
            mi = self.mont[i]
            # t = (y_i - (v0 + v1*p0 + ...)) * (p0*...*p_{i-1})^{-1} mod p_i
            t = mi.sub(ys[i], mi.reduce_u32(vs[0]))
            acc_prod = 1
            for j in range(1, i):
                acc_prod *= self.primes[j - 1]
                pj_mont = jnp.uint32(mi.h_to_mont(acc_prod % mi.p))
                t = mi.sub(t, mi.mont_mul(mi.reduce_u32(vs[j]), pj_mont))
            vs.append(mi.mont_mul(t, jnp.uint32(g["c_mont"][i - 1])))

        hs = [jnp.uint32(h) for h in g["half_digits"]]
        gt = vs[-1] > hs[-1]
        eq = vs[-1] == hs[-1]
        for i in range(num - 2, -1, -1):
            gt = gt | (eq & (vs[i] > hs[i]))
            eq = eq & (vs[i] == hs[i])
        return vs, gt

    def _crt_to_pair(self, ys):
        """Wide-ring Garner reconstruction to a [0, q) (lo, hi) uint32 limb
        pair (ops/mont64.py folds on limb pairs, the only mod-q products
        outside the NTT domain); the caller bitcasts it to int64."""
        num = len(ys)
        g = self._garner(num)
        vs, gt = self._crt_digits(ys, g)
        qc = self.qctx
        acc_lo, acc_hi = vs[0], jnp.zeros_like(vs[0])  # v0 < p0 < q
        for i in range(1, num):
            k_lo, k_hi = g["k_mont"][i - 1]
            t_lo, t_hi = qc.redc_small(vs[i], k_lo, k_hi)
            acc_lo, acc_hi = qc.add(acc_lo, acc_hi, t_lo, t_hi)
        m_lo, m_hi = g["m_mod_q"]
        z = jnp.uint32(0)
        return qc.sub(
            acc_lo,
            acc_hi,
            jnp.where(gt, jnp.uint32(m_lo), z),
            jnp.where(gt, jnp.uint32(m_hi), z),
        )

    def to_centered(self, u):
        """[0, q) uint32 -> centered int32 in [-(q-1)/2, q/2]."""
        qh = jnp.uint32(self.q // 2)
        wrap = u > qh
        return jax.lax.bitcast_convert_type(
            u - jnp.where(wrap, jnp.uint32(self.q), jnp.uint32(0)), jnp.int32
        )

    # ------------------------------------------------------------------
    # NTT-domain (pointwise) algebra: all inputs/outputs [P, ..., N] uint32
    # ------------------------------------------------------------------

    def dot_hat(self, a, b):
        """Pointwise product; exactly one operand must be in const
        (Montgomery) form, the result is in plain form. Operands must share
        the same prime-subset size (leading axis)."""
        assert a.shape[0] == b.shape[0], (a.shape, b.shape)
        return jnp.stack(
            [self.mont[i].mont_mul(a[i], b[i]) for i in range(a.shape[0])], 0
        )

    def add_hat(self, a, b):
        assert a.shape[0] == b.shape[0], (a.shape, b.shape)
        return jnp.stack([self.mont[i].add(a[i], b[i]) for i in range(a.shape[0])], 0)

    def sub_hat(self, a, b):
        assert a.shape[0] == b.shape[0], (a.shape, b.shape)
        return jnp.stack([self.mont[i].sub(a[i], b[i]) for i in range(a.shape[0])], 0)

    def sum_hat(self, a, axis):
        """addmod-reduce along a (small, static) axis of an NTT-domain array.

        axis is counted over the trailing (non-P) dims of each per-prime slice,
        i.e. ``axis`` refers to the full [P, ...] array's axis index.

        The axis length must be <= ACC_MAX: a longer accumulation of
        depth-one products can exceed the CRT range and :meth:`inv` would
        silently wrap mod M. Use :meth:`sum_to_centered` for arbitrary
        lengths (chunked exact reduction).
        """
        axis = axis % a.ndim
        assert axis != 0, "cannot reduce the prime axis"
        size = a.shape[axis]
        if size > self.ACC_MAX:
            raise ValueError(
                f"sum_hat over {size} terms exceeds ACC_MAX={self.ACC_MAX} "
                "(CRT exactness); use sum_to_centered for chunked reduction"
            )
        num = a.shape[0]
        out = jax.lax.index_in_dim(a, 0, axis, keepdims=False)
        for j in range(1, size):
            nxt = jax.lax.index_in_dim(a, j, axis, keepdims=False)
            out = jnp.stack(
                [self.mont[i].add(out[i], nxt[i]) for i in range(num)], 0
            )
        return out

    def sum_to_centered(self, a, axis):
        """Exact ``inv(sum(a, axis))`` for ANY axis length, centered int32.

        Chunks the accumulation at ACC_MAX terms: each chunk's sum is
        reconstructed exactly out of the NTT domain (Garner + mod q) and the
        centered partials are added mod q -- removing the accumulation
        ceiling the reference's `Mat::dot` / sum proof never had
        (/root/reference/src/mat.rs:95-115, /root/reference/src/prove/sum.rs:106-120):
        any contraction length k and any summand count VL are exact here.
        For axis lengths <= ACC_MAX this is exactly inv(sum_hat(a, axis)).
        """
        from . import zq

        axis = axis % a.ndim
        assert axis != 0, "cannot reduce the prime axis"
        size = a.shape[axis]
        if size <= self.ACC_MAX:
            return self.inv(self.sum_hat(a, axis))
        out = None
        for start in range(0, size, self.ACC_MAX):
            stop = min(start + self.ACC_MAX, size)
            part = self.inv(
                self.sum_hat(jax.lax.slice_in_dim(a, start, stop, axis=axis), axis)
            )
            out = part if out is None else zq.add_centered(self.qctx, out, part)
        return out

    # Convenience: full multiply of centered int32 polynomials
    def polymul(self, a, b):
        """Exact negacyclic product of centered int32 polys [..., N] mod q."""
        return self.inv(self.dot_hat(self.fwd_const(a), self.fwd(b)))

    def scalar_mul_add(self, d, m, t, num: int | None = None,
                       d_num: int | None = None):
        """Fused ``t + d * m`` mod q, centered int32.

        d: [..., N] scalar polynomial broadcast over the rows of
        m, t: [..., rows, N]. The hot pair of every sigma protocol --
        ``z = y + d*r`` in create_response and ``t + c1*d`` in verify
        (ring-zk src/prove/open.rs:107-117,162-174).
        ``num`` is the caller's exact CRT bound for d*m, as in polymul.
        ``d_num`` (>= num) transforms d at a LARGER prime-subset size and
        slices the first ``num`` planes for the product: per-prime
        transforms are independent, so the result is bit-identical, but a
        fused program whose other phase transforms the same d at d_num
        primes now contains two syntactically equal ``fwd_const(d, d_num)``
        subgraphs and XLA CSEs one away (the honest-bound-dedupe trick
        applied to the challenge transform; see protocols.commit.shared_d_num)."""
        from . import zq

        if num is None:
            num = self.num_primes
        d = jnp.asarray(d, self.dtype)
        m = jnp.asarray(m, self.dtype)
        t = jnp.asarray(t, self.dtype)
        # d broadcasts over any number of trailing structure axes of m
        # (rows; V summands x rows in the sum proof): flatten them to one
        nbatch = d.ndim - 1
        if m.shape[:nbatch] != d.shape[:-1]:
            raise ValueError(
                f"scalar_mul_add: d batch {d.shape[:-1]} does not prefix "
                f"m shape {m.shape}"
            )
        if t.shape != m.shape:
            raise ValueError(
                f"scalar_mul_add: t shape {t.shape} != m shape {m.shape}"
            )
        struct = m.shape[nbatch:-1]
        mf = m.reshape(d.shape[:-1] + (-1, m.shape[-1]))
        tf = t.reshape(mf.shape)
        dn = num if d_num is None else max(d_num, num)
        d_hat = self.fwd_const(d, dn)[:num]
        dm = self.inv(self.dot_hat(d_hat[..., None, :], self.fwd(mf, num)))
        out = zq.add_centered(self.qctx, tf, dm)
        return out.reshape(d.shape[:-1] + struct + (m.shape[-1],))


@functools.lru_cache(maxsize=None)
def _get_ring_cached(n: int, q: int) -> RingContext:
    return RingContext(n=n, q=q)


# Trace-time ring override (see parallel/ring_sp.py): while active, protocol
# code asking for a ring of the SAME (n, q) receives the override instead --
# e.g. an SpRing whose transforms shard the coefficient axis over a mesh.
# This is how the sp axis reaches the protocol layer without threading a
# ring argument through every call site. Other (n, q) pairs fall through.
_RING_OVERRIDE: list = []


class ring_override:
    """Context manager installing ``ring`` as the get_ring result for its
    (n, q) during tracing. Nestable; trace protocol programs inside it."""

    def __init__(self, ring: "RingContext"):
        self.ring = ring

    def __enter__(self):
        _RING_OVERRIDE.append(self.ring)
        return self.ring

    def __exit__(self, *exc):
        _RING_OVERRIDE.pop()


def get_ring(n: int, q: int) -> RingContext:
    for ov in reversed(_RING_OVERRIDE):
        if ov.n == n and ov.q == q:
            return ov
    return _get_ring_cached(n, q)


# Pairwise-coprime 26-bit moduli for the exact golden-model convolution:
# per-modulus int64 np.convolve cannot overflow (N * (2^26)^2 <= 2^62 for
# N <= 1024... actually any N <= 2^10; larger N uses object fallback).
# _sb_moduli extends the set until the product covers twice the true
# coefficient bound N*(q/2)^2 -- 3 moduli (~2^78) for the narrow q domain,
# more for wide rings up to q < 2^63 (~2^135 at N=1024 needs 6).
_SB_MODULI = (1 << 26, (1 << 26) - 1, (1 << 26) - 3)


@functools.lru_cache(maxsize=None)
def _sb_moduli(n: int, q: int):
    import math

    bound = 2 * n * (q // 2 + 1) ** 2
    ms = list(_SB_MODULI)
    prod = ms[0] * ms[1] * ms[2]
    cand = (1 << 26) - 4
    while prod <= bound:
        if all(math.gcd(cand, m) == 1 for m in ms):
            ms.append(cand)
            prod *= cand
        cand -= 1
        assert cand > 1 << 25, "modulus pool exhausted"
    return tuple(ms)


def negacyclic_schoolbook(a, b, q):
    """Exact negacyclic product golden model (tests only): mirrors the
    semantics of poly-ring-xnp1's `*` (x^N == -1), i.e. the reference's
    schoolbook multiply, but computed as CRT over int64 `np.convolve`
    passes so large-N goldens stay fast. Bit-for-bit identical results to
    the naive O(N^2) object-int double loop (validated in tests). Valid
    for any odd q < 2^63 (the modulus set grows with the bound)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    n = a.shape[-1]
    shape = np.broadcast_shapes(a.shape, b.shape)
    af = np.broadcast_to(a, shape).reshape(-1, n)
    bf = np.broadcast_to(b, shape).reshape(-1, n)

    ms = _sb_moduli(n, q)
    prod_m = 1
    for m in ms:
        prod_m *= m
    if n * max(ms) ** 2 >= 2**63:  # pragma: no cover - tests use N <= 1024
        raise ValueError(f"N={n} too large for the int64 CRT golden model")
    # CRT basis: e_i == 1 mod m_i, 0 mod m_j (Python ints, exact)
    basis = []
    for m in ms:
        rest = prod_m // m
        basis.append(rest * pow(rest, -1, m))

    rows = []
    for ai, bi in zip(af, bf):
        x = 0
        for m, e in zip(ms, basis):
            am = np.asarray([int(v) % m for v in ai], dtype=np.int64)
            bm = np.asarray([int(v) % m for v in bi], dtype=np.int64)
            c = np.convolve(am, bm)  # length 2n-1, sums < 2^63
            folded = c[:n].copy()
            folded[: n - 1] -= c[n:]  # x^N == -1
            x = x + e * (folded.astype(object) % m)
        x = x % prod_m
        x = np.where(x > prod_m // 2, x - prod_m, x)  # exact integer coeffs
        rows.append(x)
    out = np.mod(np.stack(rows).reshape(shape), q)
    half = q // 2
    out = np.where(out > half, out - q, out)
    return out.astype(np.int64)
