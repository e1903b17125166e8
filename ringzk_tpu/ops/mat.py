"""Matrices of ring elements as dense arrays: [..., rows, cols, N] int32.

Batched replacement for the reference's clone-heavy `Mat<I, N>`
(/root/reference/src/mat.rs): a "matrix of polynomials" is just an array with
two structure axes before the ring axis, and every operation is a batched
array op. The hot `dot` (triple loop of schoolbook multiplies,
/root/reference/src/mat.rs:95-115) becomes an NTT-domain pointwise
multiply-accumulate; shape ops (extend/split/concat,
/root/reference/src/mat.rs:186-233) become jnp.concatenate / slicing.

Divergence (intentional, documented in SURVEY.md section 2.1): the reference's
`split_rows(r)` returns the *last* r rows as the second element, so its
`c1_c2` only labels c1/c2 correctly when n == l. Here `split_rows(x, r)`
returns (first r rows, remaining rows) -- the correct split for all n, l.

NTT-domain forms carry a leading prime axis: [P, ..., rows, cols, N] uint32.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import zq
from .ntt import RingContext


def matvec_hat(ring: RingContext, a_hat, v_hat):
    """NTT-domain (matrix . vector) over the ring.

    a_hat: [P, *A, rows, k, N] uint32; v_hat: [P, *B, k, N] uint32 with
    broadcast-compatible batch prefixes *A and *B. Returns [P, *, rows, N].
    The contraction length k must be <= RingContext.ACC_MAX for CRT
    exactness (k is 3..8 in practice); use :func:`matvec` for arbitrary k
    (chunked, centered result).
    """
    k = a_hat.shape[-2]
    if v_hat.shape[-2] != k:
        raise ValueError(f"matvec_hat: contraction mismatch {a_hat.shape} . {v_hat.shape}")
    if k > ring.ACC_MAX:
        raise ValueError(
            f"matvec_hat: contraction length {k} exceeds ACC_MAX={ring.ACC_MAX}"
            " (CRT exactness); use mat.matvec for chunked accumulation"
        )
    v_hat = v_hat[..., None, :, :]  # [P, *B, 1, k, N]
    out = ring.dot_hat(a_hat[..., :, 0, :], v_hat[..., :, 0, :])
    for t in range(1, k):
        out = ring.add_hat(out, ring.dot_hat(a_hat[..., :, t, :], v_hat[..., :, t, :]))
    return out  # [P, *, rows, N]


def matvec(ring: RingContext, a_hat, v_hat):
    """Centered (matrix . vector) over the ring, exact for ANY contraction
    length k (reference parity: `Mat::dot` works for any k,
    /root/reference/src/mat.rs:95-115). Chunks the contraction at ACC_MAX
    terms, reducing each partial out of the NTT domain before adding the
    centered partials mod q. Shapes as matvec_hat; returns int32 [*, rows, N].
    """
    k = a_hat.shape[-2]
    if v_hat.shape[-2] != k:
        raise ValueError(f"matvec: contraction mismatch {a_hat.shape} . {v_hat.shape}")
    out = None
    for start in range(0, k, ring.ACC_MAX):
        stop = min(start + ring.ACC_MAX, k)
        part = ring.inv(
            matvec_hat(
                ring,
                a_hat[..., :, start:stop, :],
                v_hat[..., start:stop, :],
            )
        )
        out = part if out is None else zq.add_centered(ring.qctx, out, part)
    return out


def scalar_mul_hat(ring: RingContext, g_hat, m_hat):
    """Componentwise multiply every entry of an NTT-domain stack by the
    polynomial g (the reference's `componentwise_mul`,
    /root/reference/src/mat.rs:168-178).

    g_hat: [P, *, N] const-form; m_hat: [P, *, rows, N] plain-form.
    g broadcasts over the rows axis; result is plain-form.
    """
    return ring.dot_hat(g_hat[..., None, :], m_hat)


def add_centered(ring: RingContext, a, b):
    """Elementwise ring addition on centered int32 arrays."""
    return zq.add_centered(ring.qctx, a, b)


def sub_centered(ring: RingContext, a, b):
    return zq.sub_centered(ring.qctx, a, b)


def split_rows(x, r: int):
    """(first r rows, remaining rows) along axis -2 (the rows axis of a
    column-stack [..., rows, N])."""
    return x[..., :r, :], x[..., r:, :]


# -- constructors / shape ops (reference Mat parity, /root/reference/src/mat.rs)


def from_element(rows: int, cols: int, poly):
    """Matrix with every entry the given polynomial
    (`Mat::from_element`, mat.rs:24-30). poly: [..., N]."""
    poly = jnp.asarray(poly)
    return jnp.broadcast_to(
        poly[..., None, None, :], poly.shape[:-1] + (rows, cols, poly.shape[-1])
    )


def diag(rows: int, cols: int, poly):
    """Diagonal matrix with `poly` on the diagonal, zero elsewhere
    (`Mat::diag`, mat.rs:33-43)."""
    poly = jnp.asarray(poly)
    n = poly.shape[-1]
    eye = jnp.eye(rows, cols, dtype=poly.dtype)[..., None]
    return eye * poly[..., None, None, :]


def from_vec(polys):
    """Column matrix [..., rows, N] -> [..., rows, 1, N]
    (`Mat::from_vec`, mat.rs:46-50)."""
    return jnp.asarray(polys)[..., :, None, :]


def one_d_mat_to_vec(m):
    """[..., rows, 1, N] -> [..., rows, N]
    (`Mat::one_d_mat_to_vec`, mat.rs:56-64)."""
    assert m.shape[-2] == 1, m.shape
    return m[..., :, 0, :]


def new_with(key, rows: int, cols: int, n: int, sampler):
    """Matrix filled by a sampler(key, shape, n) -> [..., N] draw
    (`Mat::new_with`, mat.rs:67-76)."""
    return sampler(key, (rows, cols), n)


def dim(m):
    """(rows, cols) of a [..., rows, cols, N] stack (`Mat::dim`, mat.rs:79-87)."""
    return m.shape[-3], m.shape[-2]


def extend_rows(a, b):
    """Stack below: [r1, c, N] + [r2, c, N] -> [r1+r2, c, N]
    (`Mat::extend_rows`, mat.rs:186-195)."""
    return jnp.concatenate([a, b], axis=-3)


def extend_cols(a, b):
    """Stack right: [r, c1, N] + [r, c2, N] -> [r, c1+c2, N]
    (`Mat::extend_cols`, mat.rs:221-233)."""
    return jnp.concatenate([a, b], axis=-2)


def dot(ring: RingContext, a, b):
    """Full matrix product over the ring: [..., m, n, N] . [..., n, p, N]
    -> [..., m, p, N], centered int32 (the reference's triple-loop
    `Mat::dot`, mat.rs:95-115, via NTT pointwise MACs). Exact for any
    contraction length (chunked accumulation past ACC_MAX terms)."""
    n_c = a.shape[-2]
    if b.shape[-3] != n_c:
        raise ValueError(f"dot: contraction mismatch {a.shape} . {b.shape}")
    a_hat = ring.fwd_const(a)          # [P, ..., m, n, N]
    b_hat = ring.fwd(b)                # [P, ..., n, p, N]
    prod = ring.dot_hat(a_hat[..., :, :, None, :], b_hat[..., None, :, :, :])
    return ring.sum_to_centered(prod, axis=-3)


def add(ring: RingContext, a, b):
    """Elementwise matrix addition (`Mat::add`, mat.rs:122-140)."""
    return zq.add_centered(ring.qctx, a, b)


def sub(ring: RingContext, a, b):
    """Elementwise matrix subtraction (`Mat::sub`, mat.rs:147-165)."""
    return zq.sub_centered(ring.qctx, a, b)


def componentwise_mul(ring: RingContext, m, g):
    """Multiply every entry by the scalar polynomial g
    (`Mat::componentwise_mul`, mat.rs:168-178). m: [..., rows, cols, N] or
    [..., rows, N]; g: [..., N]."""
    g_hat = ring.fwd_const(g)
    extra = m.ndim - g.ndim  # structure axes to broadcast g over
    idx = (...,) + (None,) * extra + (slice(None),)
    return ring.inv(ring.dot_hat(g_hat[idx], ring.fwd(m)))


def equal_mod_q_hat(ring: RingContext, a_hat, b_hat, struct_axes=1):
    """Ring equality of two plain-form NTT-domain stacks, via a single
    inverse transform of their difference: a == b in R_q iff
    inv(a_hat - b_hat) == 0 (inv reduces the exact integer difference mod q).
    Reduces over ``struct_axes`` structure axes plus the ring axis."""
    diff = ring.inv(ring.sub_hat(a_hat, b_hat))
    eq = diff == 0
    for _ in range(struct_axes + 1):
        eq = jnp.all(eq, axis=-1)
    return eq


def poly_equal(a, b, struct_axes=2):
    """Exact equality of centered poly stacks, reduced over the trailing
    ``struct_axes`` structure axes plus the ring axis.

    """
    eq = a == b
    for _ in range(struct_axes + 1):
        eq = jnp.all(eq, axis=-1)
    return eq
