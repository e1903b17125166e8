"""64-bit Montgomery modular arithmetic on uint32 limb pairs, R = 2^64.

Extends the modulus envelope to the reference's full ``ZqI64<Q>`` domain --
any odd q < 2^63 (/root/reference/src/params.rs:18,121-127) -- without
a 64-bit multiply: every operation below is
built from the 32x32->64 widening primitives in :mod:`ringzk_tpu.ops.u64`.

Where it is used (ops/ntt.py wide rings): the ONLY mod-q multiplications
outside the NTT domain are the Garner CRT fold's ``v_i * K_i mod q``
(v_i < 2^31 mixed-radix digits, K_i = prod-of-earlier-primes constants).
Everything else mod q is addition/subtraction/centering, which stays in
plain 64-bit pairs. So this module only needs:

  * ``redc_small(ctx, v, k_lo, k_hi)`` -- v * K mod q for u32 ``v`` and a
    host constant K in Montgomery form (K * 2^64 mod q), the fold kernel;
  * carry-exact 64-bit add/sub with conditional mod-q wrap;
  * centered int64 <-> [0, q) pair conversion.

A 64-bit value is a ``(lo, hi)`` pair of uint32 arrays (lo first, matching
the little-endian limb order of ``lax.bitcast_convert_type(int64 ->
uint32[..., 2])``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import u64


@dataclasses.dataclass(frozen=True)
class Mont64Ctx:
    """Montgomery constants for an odd modulus q < 2^63, R = 2^64.

    Marked ``is64`` so dtype-polymorphic helpers (ops.zq) can dispatch.
    """

    q: int
    qinv_neg: int    # -q^{-1} mod 2^64
    is64 = True

    @staticmethod
    def make(q: int) -> "Mont64Ctx":
        if q % 2 == 0 or not (1 < q < 2**63):
            raise ValueError(f"modulus must be odd and < 2^63, got {q}")
        return Mont64Ctx(q=q, qinv_neg=(-pow(q, -1, 2**64)) % 2**64)

    # -- host-side helpers -------------------------------------------------

    def h_to_mont(self, x: int):
        """K -> (lo, hi) uint32 numpy pair of K * 2^64 mod q."""
        m = (x * 2**64) % self.q
        return np.uint32(m & 0xFFFFFFFF), np.uint32(m >> 32)

    def _q_pair(self):
        return np.uint32(self.q & 0xFFFFFFFF), np.uint32(self.q >> 32)

    # -- array ops (all uint32 limb arithmetic) ----------------------------

    def redc_small(self, v, k_lo, k_hi):
        """(v * K) mod q for u32 array ``v`` in [0, 2^32) and a constant K
        given in Montgomery form (k_lo, k_hi) = K * 2^64 mod q. Returns a
        normal-form (lo, hi) pair in [0, q).

        t = v * Kmont fits 96 bits (v < 2^32, Kmont < q < 2^63); REDC with
        R = 2^64 yields t / 2^64 mod q = v * K mod q, in [0, 2q) before one
        conditional subtract (t + m*q < 2^32*q + 2^64*q < 2^65*q, so the
        >>64 result is < (2^32/2^64 + 1)*q < 2q).
        """
        v = v.astype(jnp.uint32)
        # t = v * (k_hi:k_lo): 96-bit (t2, t1, t0)
        p0_hi, t0 = u64.mul_wide(v, k_lo)
        p1_hi, p1_lo = u64.mul_wide(v, k_hi)
        t1 = p0_hi + p1_lo
        t2 = p1_hi + (t1 < p0_hi).astype(jnp.uint32)

        # m = (t mod 2^64) * qinv_neg mod 2^64  (u64 x u64 low product)
        n_lo = np.uint32(self.qinv_neg & 0xFFFFFFFF)
        n_hi = np.uint32(self.qinv_neg >> 32)
        m_hi0, m_lo = u64.mul_wide(t0, n_lo)
        m_hi = m_hi0 + t0 * n_hi + t1 * n_lo          # wrapping high limb

        # m * q: full 128-bit product (r3, r2, r1, r0)
        q_lo, q_hi = self._q_pair()
        a_hi, r0 = u64.mul_wide(m_lo, q_lo)
        b_hi, b_lo = u64.mul_wide(m_lo, q_hi)
        c_hi, c_lo = u64.mul_wide(m_hi, q_lo)
        d_hi, d_lo = u64.mul_wide(m_hi, q_hi)
        r1 = a_hi + b_lo
        c1 = (r1 < a_hi).astype(jnp.uint32)
        r1n = r1 + c_lo
        c1 = c1 + (r1n < r1).astype(jnp.uint32)
        r2 = b_hi + c_hi
        c2 = (r2 < b_hi).astype(jnp.uint32)
        r2n = r2 + d_lo
        c2 = c2 + (r2n < r2).astype(jnp.uint32)
        r2f = r2n + c1
        c2 = c2 + (r2f < r2n).astype(jnp.uint32)
        r3 = d_hi + c2

        # t + m*q: low 64 bits cancel exactly (property of REDC); the
        # result is the high 64 bits + carry-out of the low half.
        s0 = t0 + r0
        carry0 = (s0 < t0).astype(jnp.uint32)
        s1 = t1 + r1n
        carry1 = (s1 < t1).astype(jnp.uint32)
        s1b = s1 + carry0
        carry1 = carry1 + (s1b < s1).astype(jnp.uint32)
        # high 64 = (t2 + r2f + carry1, r3 + carry-out)
        h_lo = t2 + r2f
        ch = (h_lo < t2).astype(jnp.uint32)
        h_lo2 = h_lo + carry1
        ch = ch + (h_lo2 < h_lo).astype(jnp.uint32)
        h_hi = r3 + ch

        return self._cond_sub_q(h_lo2, h_hi)

    def _cond_sub_q(self, lo, hi):
        """(lo, hi) in [0, 2q) -> [0, q)."""
        q_lo, q_hi = self._q_pair()
        ge = ~u64.lt64(hi, lo, jnp.uint32(q_hi), jnp.uint32(q_lo))
        s_lo = lo - q_lo
        borrow = (lo < q_lo).astype(jnp.uint32)
        s_hi = hi - q_hi - borrow
        return jnp.where(ge, s_lo, lo), jnp.where(ge, s_hi, hi)

    def add(self, a_lo, a_hi, b_lo, b_hi):
        """(a + b) mod q for pairs in [0, q); a+b < 2q < 2^64."""
        hi, lo = u64.add64(a_hi, a_lo, b_hi, b_lo)
        return self._cond_sub_q(lo, hi)

    def sub(self, a_lo, a_hi, b_lo, b_hi):
        """(a - b) mod q for pairs in [0, q)."""
        q_lo, q_hi = self._q_pair()
        lt = u64.lt64(a_hi, a_lo, b_hi, b_lo)
        lo = a_lo - b_lo
        borrow = (a_lo < b_lo).astype(jnp.uint32)
        hi = a_hi - b_hi - borrow
        # wrapped negative: add q back
        a2 = lo + q_lo
        c = (a2 < lo).astype(jnp.uint32)
        h2 = hi + q_hi + c
        return jnp.where(lt, a2, lo), jnp.where(lt, h2, hi)

    # -- centered int64 boundary -------------------------------------------

    def to_centered_i64(self, lo, hi):
        """[0, q) pair -> centered int64 in [-(q-1)/2, q/2]."""
        q_half = self.q // 2
        qh_lo = np.uint32(q_half & 0xFFFFFFFF)
        qh_hi = np.uint32(q_half >> 32)
        wrap = ~u64.le64(hi, lo, jnp.uint32(qh_hi), jnp.uint32(qh_lo))
        q_lo, q_hi = self._q_pair()
        s_lo = lo - q_lo
        borrow = (lo < q_lo).astype(jnp.uint32)
        s_hi = hi - q_hi - borrow       # two's-complement wrap == signed value
        out_lo = jnp.where(wrap, s_lo, lo)
        out_hi = jnp.where(wrap, s_hi, hi)
        return jax.lax.bitcast_convert_type(
            jnp.stack([out_lo, out_hi], axis=-1), jnp.int64
        )

    @staticmethod
    def split_i64(x):
        """Centered int64 -> (lo uint32, hi_signed int32) limb views."""
        limbs = jax.lax.bitcast_convert_type(
            jnp.asarray(x, jnp.int64), jnp.uint32
        )
        lo = limbs[..., 0]
        hi = jax.lax.bitcast_convert_type(limbs[..., 1], jnp.int32)
        return lo, hi

    def add_centered_i64(self, a, b):
        """(a + b) mod q, centered int64 in, centered int64 out.

        |a|, |b| <= (q-1)/2 < 2^62 so the int64 sum cannot overflow; the
        wrap-around is a pair of conditional +-q adds (no multiplies).
        """
        a = jnp.asarray(a, jnp.int64)
        b = jnp.asarray(b, jnp.int64)
        s = a + b
        q = jnp.int64(self.q)
        half = jnp.int64(self.q // 2)
        s = jnp.where(s > half, s - q, s)
        return jnp.where(s < -half, s + q, s)

    def sub_centered_i64(self, a, b):
        a = jnp.asarray(a, jnp.int64)
        b = jnp.asarray(b, jnp.int64)
        s = a - b
        q = jnp.int64(self.q)
        half = jnp.int64(self.q // 2)
        s = jnp.where(s > half, s - q, s)
        return jnp.where(s < -half, s + q, s)
