"""Montgomery modular arithmetic on uint32 lanes, R = 2^32.

Division-free modular multiply/add/sub for odd moduli p < 2^32, built on the
exact widening primitives in :mod:`ringzk_tpu.ops.u64`. This is the scalar
engine under both the CRT-NTT polynomial multiplier (30-bit NTT primes) and
the final mod-q reconstruction (q = 3515337053 ~ 2^31.7).

The reference (Rust `poly-ring-xnp1`'s ZqI64, see call sites in
ring-zk src/params.rs:121-138) uses native i64 `%`; this library keeps
every array 32-bit (no JAX x64), so it uses Montgomery form with 32-bit limbs
instead.

Conventions:
  * Residues live in [0, p) as uint32 ("normal form").
  * Constants that multiply normal-form values are pre-scaled by R
    ("Montgomery form"), so ``mont_mul(x, c_mont) == x * c mod p``.
  * ``mont_mul(a, b)`` computes ``a * b * R^{-1} mod p`` exactly for any
    uint32 ``a`` provided ``b < p`` (the overflow-safe asymmetric bound).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np

from . import u64


@dataclasses.dataclass(frozen=True)
class MontCtx:
    """Precomputed Montgomery constants for an odd modulus p < 2^32.

    All fields are Python ints (static under jit); array ops broadcast them.
    """

    p: int          # modulus
    pinv_neg: int   # -p^{-1} mod 2^32  (for REDC)
    r1: int         # R   mod p  == mont form of 1
    r2: int         # R^2 mod p  (to_mont multiplier)
    r3: int         # R^3 mod p

    @staticmethod
    def make(p: int) -> "MontCtx":
        if p % 2 == 0 or not (1 < p < 2**32):
            raise ValueError(f"modulus must be odd and < 2^32, got {p}")
        pinv = pow(p, -1, 2**32)
        return MontCtx(
            p=p,
            pinv_neg=(-pinv) % 2**32,
            r1=(2**32) % p,
            r2=pow(2, 64, p),
            r3=pow(2, 96, p),
        )

    # -- jit-safe array ops ------------------------------------------------

    def mont_mul(self, a, b):
        """a * b * R^{-1} mod p. Exact for any uint32 a if b < p (or vice versa)."""
        p = np.uint32(self.p)
        t_hi, t_lo = u64.mul_wide(a, b)
        m = t_lo * np.uint32(self.pinv_neg)          # wraps mod 2^32
        mp_hi, _ = u64.mul_wide(m, p)                  # (m*p) lo == -t_lo mod 2^32
        carry = (t_lo != 0).astype(jnp.uint32)
        if self.p < 2**31:
            # u = (t + m*p)/2^32 < 2p < 2^32: no carry-out is possible
            # (t < 2^32 * p, m*p < 2^32 * p), so u fits uint32 and one
            # conditional subtract lands in [0, p).
            u = t_hi + mp_hi + carry
            return u - jnp.where(u >= p, p, np.uint32(0))
        # u = (t + m*p) / 2^32, may reach 2p < 2^33 for p > 2^31: track carry-out
        lo = t_hi + mp_hi
        c2 = (lo < t_hi).astype(jnp.uint32)
        lo2 = lo + carry
        c3 = (lo2 < carry).astype(jnp.uint32)
        over = (c2 + c3) > 0                           # u >= 2^32
        sub = over | (lo2 >= p)
        return lo2 - jnp.where(sub, p, np.uint32(0))  # wrapping subtract is exact

    def mul(self, a, b):
        """Plain modular product a*b mod p for normal-form a, b (two REDCs):
        mont_mul(a, b) = a*b*R^{-1}; a second REDC against R^2 restores it."""
        return self.mont_mul(self.mont_mul(a, b), np.uint32(self.r2))

    def add(self, a, b):
        """(a + b) mod p for a, b in [0, p)."""
        p = np.uint32(self.p)
        s = a + b
        if self.p < 2**31:
            return s - jnp.where(s >= p, p, np.uint32(0))  # s < 2p < 2^32
        ov = s < a
        return s - jnp.where(ov | (s >= p), p, np.uint32(0))

    def sub(self, a, b):
        """(a - b) mod p for a, b in [0, p)."""
        p = np.uint32(self.p)
        d = a - b
        return d + jnp.where(a < b, p, np.uint32(0))

    def neg(self, a):
        p = np.uint32(self.p)
        return jnp.where(a == 0, np.uint32(0), p - a)

    def shoup_mul(self, w, w_shoup, x):
        """w * x mod p via Shoup's trick: w is a static constant with
        precomputed w_shoup = floor(w * 2^32 / p); x in [0, p).

        q = floor(w_shoup * x / 2^32) underestimates floor(w*x/p) by at most
        1, so r = w*x - q*p (wrapping 32-bit arithmetic) lands in [0, 2p);
        one conditional subtract finishes. ~40% fewer lane ops than REDC --
        use for twiddle factors and other host-precomputed constants.
        Requires p < 2^31 (so 2p fits uint32).
        """
        p = np.uint32(self.p)
        q = u64.mul_hi(w_shoup, x)
        r = w * x - q * p                      # wrapping low-32 arithmetic
        return r - jnp.where(r >= p, p, np.uint32(0))

    def h_shoup(self, w: int) -> int:
        """Host-side Shoup companion of a constant w in [0, p)."""
        return (w << 32) // self.p

    def to_mont(self, a):
        return self.mont_mul(a, np.uint32(self.r2))

    def from_mont(self, a):
        return self.mont_mul(a, np.uint32(1))

    def reduce_u32(self, a):
        """a mod p for arbitrary uint32 a (single REDC with R mod p)."""
        return self.mont_mul(a, np.uint32(self.r1))

    def reduce_i32_centered(self, a):
        """x mod p for int32 centered x (any int32), result in [0, p)."""
        import jax

        ai = jnp.asarray(a, jnp.int32)
        xu = jax.lax.bitcast_convert_type(ai, jnp.uint32)  # two's complement bits
        r = self.reduce_u32(xu)
        # x = xu - 2^32*[x<0]; (-2^32) mod p == p - R1 (R1 != 0 since p !| 2^32)
        corr = np.uint32((self.p - self.r1) % self.p)
        return jnp.where(ai < 0, self.add(r, corr), r)

    # Python-side helpers (host constants) --------------------------------

    def h_to_mont(self, x: int) -> int:
        return (x * 2**32) % self.p
