"""Plain numpy negacyclic NTT per prime: the independent reference the
transform tests compare the XLA stage chain and the fused kernel against.

Forward: out[j] = sum_i x[i] * psi^((2 * bitrev(j) + 1) * i) mod p -- the
evaluation of x at the odd powers of a primitive 2N-th root psi, in
bit-reversed order (the order ops/ntt.py's Cooley-Tukey chain leaves).
Inverse: the matching interpolation, then Garner-free CRT with Python
integers and the centered reduction mod q.
"""

import numpy as np

from ringzk_tpu.ops import ntt


def _bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _psi(p: int, g: int, n: int) -> int:
    psi = pow(g, (p - 1) // (2 * n), p)
    assert pow(psi, n, p) == p - 1
    return psi


def _matmul_mod(v: np.ndarray, x: np.ndarray, p: int) -> np.ndarray:
    """(v @ x) mod p for v [N, N] in [0, p) and x [..., N] in [0, p),
    exact in int64: x is split into 15-bit halves so no partial sum
    passes 2^62."""
    x = np.asarray(x, np.int64)
    lo, hi = x & 0x7FFF, x >> 15
    r_lo = (lo @ v.T) % p
    r_hi = (hi @ v.T) % p
    return (r_lo + (r_hi << 15)) % p


def _vandermonde(p: int, g: int, n: int, inverse: bool) -> np.ndarray:
    bits = n.bit_length() - 1
    psi = _psi(p, g, n)
    if inverse:
        psi = pow(psi, -1, p)
    v = np.empty((n, n), np.int64)
    for j in range(n):
        e = 2 * _bitrev(j, bits) + 1
        base = pow(psi, e, p)
        row = [1] * n
        for i in range(1, n):
            row[i] = row[i - 1] * base % p
        v[j] = row
    return v


def fwd(x, n: int, num: int) -> np.ndarray:
    """Centered integers [..., N] -> [num, ..., N] uint32 NTT images."""
    x = np.asarray(x, dtype=object)
    out = []
    for p, g in zip(ntt.PRIMES[:num], ntt.GENERATORS[:num]):
        xp = (x % p).astype(np.int64)
        out.append(_matmul_mod(_vandermonde(p, g, n, False), xp, p))
    return np.stack(out).astype(np.uint32)


def inv(xhat, n: int, q: int) -> np.ndarray:
    """[num, ..., N] NTT images -> centered residues mod q of the integer
    the images represent (|value| < prod(primes[:num]) / 2)."""
    num = xhat.shape[0]
    ys = []
    for i, (p, g) in enumerate(zip(ntt.PRIMES[:num], ntt.GENERATORS[:num])):
        # out[i] = N^-1 sum_j X[j] psi^-(2 bitrev(j) + 1) i: the transpose
        # of the inverse-root Vandermonde, scaled
        vt = _vandermonde(p, g, n, True).T.copy()
        y = _matmul_mod(vt, np.asarray(xhat[i], np.int64), p)
        ys.append((y.astype(object) * pow(n, -1, p)) % p)
    m = 1
    for p in ntt.PRIMES[:num]:
        m *= p
    acc = np.zeros(ys[0].shape, dtype=object)
    for p, y in zip(ntt.PRIMES[:num], ys):
        mi = m // p
        acc = (acc + y * (mi * pow(mi, -1, p))) % m
    acc = np.where(acc > m // 2, acc - m, acc)
    acc = acc % q
    return np.where(acc > q // 2, acc - q, acc).astype(np.int64)


def pointwise(a_hat, b_hat) -> np.ndarray:
    """Pointwise product of two [num, ..., N] image stacks, per prime."""
    out = []
    for i, p in enumerate(ntt.PRIMES[: a_hat.shape[0]]):
        prod = a_hat[i].astype(object) * b_hat[i].astype(object)
        out.append((prod % p).astype(np.uint32))
    return np.stack(out)
