"""The XLA stage chain (ops/ntt.py) against the plain numpy per-prime NTT
(tests/ntt_reference.py): forward images, inverse with the Garner CRT and
mod-q fold, every CRT prime subset, several ring degrees, odd batches, and
the wide ring. These stand whatever engine a device runs: the fused GPU
kernel is checked against this chain (tests/test_ntt_kernel.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ntt_reference
from ringzk_tpu.ops import ntt

Q = 3_515_337_053
NS = [128, 512, 1024]
NUMS = [1, 2, 3]


def _bounded_operands(rng, n, num, rows):
    """(a, b) whose negacyclic product fits the CRT range of ``num`` primes
    (the caller's exactness contract for a prime subset)."""
    prod = 1
    for p in ntt.PRIMES[:num]:
        prod *= p
    b_bound = 1 if num < 3 else Q // 2
    a_bound = min(Q // 2, (prod // 2) // (n * b_bound) - 1)
    a = rng.integers(-a_bound, a_bound + 1, size=(rows, n))
    b = rng.integers(-b_bound, b_bound + 1, size=(rows, n))
    return a, b


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("n", NS)
def test_chain_fwd_matches_numpy(rng, n, num):
    ring = ntt.get_ring(n, Q)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(3, n))
    got = np.asarray(ring.fwd(jnp.asarray(x, jnp.int32), num))
    np.testing.assert_array_equal(got, ntt_reference.fwd(x, n, num))


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("n", NS)
def test_chain_inv_matches_numpy(rng, n, num):
    """inv of a numpy-made product image == the schoolbook product."""
    ring = ntt.get_ring(n, Q)
    a, b = _bounded_operands(rng, n, num, 2)
    prod_hat = ntt_reference.pointwise(
        ntt_reference.fwd(a, n, num), ntt_reference.fwd(b, n, num)
    )
    got = np.asarray(ring.inv(jnp.asarray(prod_hat)))
    np.testing.assert_array_equal(got, ntt_reference.inv(prod_hat, n, Q))
    np.testing.assert_array_equal(got, ntt.negacyclic_schoolbook(a, b, Q))


def test_chain_odd_batch_shapes(rng):
    """Leading axes of any size (7 is no power of two) go through intact."""
    n = 128
    ring = ntt.get_ring(n, Q)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(3, 7, n))
    got = np.asarray(ring.fwd(jnp.asarray(x, jnp.int32)))
    assert got.shape == (3, 3, 7, n)
    want = ntt_reference.fwd(x.reshape(-1, n), n, 3).reshape(3, 3, 7, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(ring.inv(jnp.asarray(got))), x)


@pytest.mark.parametrize(
    "q", [pytest.param(2**33 + 9, id="q2e33"),
          pytest.param(9223372036854775783, id="q2e63")]
)
def test_wide_chain_matches_numpy(q):
    """Wide rings (int64 residues, extended prime set): forward images of
    the base primes equal numpy's, and inv(fwd(x)) == x."""
    n = 64
    rng = np.random.default_rng(120)
    with jax.enable_x64(True):
        ring = ntt.get_ring(n, q)
        x = rng.integers(-(q // 2), q // 2 + 1, size=(4, n), dtype=np.int64)
        got = np.asarray(ring.fwd(jnp.asarray(x)))
        assert got.shape[0] == ring.num_primes
        np.testing.assert_array_equal(got[:3], ntt_reference.fwd(x, n, 3))
        np.testing.assert_array_equal(np.asarray(ring.inv(jnp.asarray(got))), x)
