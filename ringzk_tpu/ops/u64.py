"""64-bit unsigned integer emulation on 32-bit lanes.

The library runs without JAX x64 (int32/uint32 arrays throughout), but exact
lattice arithmetic mod q ~ 2^31.7 needs 64-bit intermediates.
This module represents a 64-bit unsigned value as a pair of uint32 arrays
``(hi, lo)`` and provides the handful of exact primitives everything else is
built from:

  * ``mul_wide(a, b)``      -- exact 32x32 -> 64 multiply via 16-bit halves
  * ``add64`` / ``add64_32``-- 64-bit addition with carry propagation
  * ``sum_squares``         -- exact sum of squares of int32 along an axis
                               (tree-folded 64-bit accumulation)
  * ``le64`` / ``lt64``     -- 64-bit comparisons

All functions are shape-polymorphic, jit-safe, and operate on uint32 arrays.
Reference parity: this subsumes the BigInt/BigUint norm arithmetic of the Rust
reference (``/root/reference/src/polynomial.rs:60-73``) with exact fixed-width
math instead of arbitrary precision (values are bounded by construction).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_MASK16 = np.uint32(0xFFFF)


def mul_wide(a, b):
    """Exact widening multiply of two uint32 arrays.

    Returns ``(hi, lo)`` uint32 pair with ``a * b == hi * 2^32 + lo`` exactly.
    """
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16

    ll = a_lo * b_lo                    # < 2^32, exact
    lh = a_lo * b_hi                    # < 2^32, exact
    hl = a_hi * b_lo                    # < 2^32, exact
    hh = a_hi * b_hi                    # < 2^32, exact

    # mid = lh + hl may carry into bit 32.
    mid = lh + hl
    mid_carry = (mid < lh).astype(jnp.uint32)  # carry out of 32 bits

    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(jnp.uint32)

    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


def mul_hi(a, b):
    """High 32 bits of the exact 64-bit product of two uint32 arrays."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16

    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi

    mid = lh + hl
    mid_carry = (mid < lh).astype(jnp.uint32)
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(jnp.uint32)
    return hh + (mid >> 16) + (mid_carry << 16) + lo_carry


def add64(a_hi, a_lo, b_hi, b_lo):
    """(a_hi:a_lo) + (b_hi:b_lo) mod 2^64, as a uint32 pair."""
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(jnp.uint32)
    hi = a_hi + b_hi + carry
    return hi, lo


def add64_32(a_hi, a_lo, b):
    """64-bit + 32-bit addition."""
    lo = a_lo + b
    carry = (lo < a_lo).astype(jnp.uint32)
    return a_hi + carry, lo


def lt64(a_hi, a_lo, b_hi, b_lo):
    """a < b for 64-bit pairs (boolean array)."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def le64(a_hi, a_lo, b_hi, b_lo):
    """a <= b for 64-bit pairs (boolean array)."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def add96(a2, a1, a0, b2, b1, b0):
    """96-bit addition on uint32 limb triples (hi, mid, lo)."""
    lo = a0 + b0
    c0 = (lo < a0).astype(jnp.uint32)
    m1 = a1 + b1
    c1 = (m1 < a1).astype(jnp.uint32)
    mid = m1 + c0
    c1 = c1 + (mid < m1).astype(jnp.uint32)
    hi = a2 + b2 + c1
    return hi, mid, lo


def sum96(hi, mid, lo, axis=-1):
    """Exact 96-bit sum of uint32 triples along ``axis`` (power-of-two len)."""
    hi = jnp.moveaxis(hi, axis, -1)
    mid = jnp.moveaxis(mid, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    if n & (n - 1):
        raise ValueError(f"sum96 axis length {n} must be a power of two")
    while n > 1:
        n //= 2
        hi, mid, lo = add96(
            hi[..., :n], mid[..., :n], lo[..., :n],
            hi[..., n:], mid[..., n:], lo[..., n:],
        )
    return hi[..., 0], mid[..., 0], lo[..., 0]


def le96(a2, a1, a0, b2, b1, b0):
    """a <= b for 96-bit triples."""
    return (
        (a2 < b2)
        | ((a2 == b2) & (a1 < b1))
        | ((a2 == b2) & (a1 == b1) & (a0 <= b0))
    )


def sum64(hi, lo, axis=-1):
    """Exact 64-bit sum of uint32 pairs along ``axis`` via log-tree folding.

    The input axis length must be a power of two (pad with zeros otherwise).
    """
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    if n & (n - 1):
        raise ValueError(f"sum64 axis length {n} must be a power of two")
    while n > 1:
        n //= 2
        hi, lo = add64(hi[..., :n], lo[..., :n], hi[..., n:], lo[..., n:])
    return hi[..., 0], lo[..., 0]


def sum_squares(x, axis=-1):
    """Exact sum of x_i^2 along ``axis`` for int32 ``x``, as a 96-bit
    uint32 limb triple (hi, mid, lo).

    96 bits, not 64: for adversarial full-range coefficients (|x| ~ 2^31,
    the attacker controls opening randomness r) the sum reaches
    N * 2^62 ~ 2^78 for N = 2^16 -- a 64-bit accumulator would wrap and an
    attacker could tune coefficients to slip a huge r past the norm bound.
    Used for the exact L2-norm constraint checks (the reference's ``norm_2``
    at /root/reference/src/polynomial.rs:60-73 compares a BigUint integer
    sqrt; we compare squared sums exactly instead -- see ops.norms).
    """
    x = x.astype(jnp.int32)
    ax = jnp.abs(x).astype(jnp.uint32)  # abs of INT32_MIN wraps correctly
    hi, lo = mul_wide(ax, ax)
    # pad to power of two along the reduction axis
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    pot = 1
    while pot < n:
        pot *= 2
    if pot != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, pot - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    zero = jnp.zeros_like(hi)
    return sum96(zero, hi, lo, axis=-1)
