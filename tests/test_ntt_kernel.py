"""The fused GPU NTT kernels (ops/ntt_kernel.py) against the XLA stage
chain, bit for bit: in interpret mode here (where the high product is
emulated: inline PTX needs the compiled kernel), and compiled on the card
by the chip-marked test. Also the wrapper's block shapes and the
engine gate."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ringzk_tpu.ops import ntt, ntt_kernel

Q = 3_515_337_053
NS = [128, 512, 1024]
NUMS = [1, 2, 3]


def _kernel_fwd(ring, x, num):
    return ntt_kernel.fwd(ring, x, num, interpret=True)


def _kernel_inv(ring, xhat):
    return ntt_kernel.inv(ring, xhat, interpret=True)


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("n", NS)
def test_kernel_fwd_matches_chain(rng, n, num):
    ring = ntt.get_ring(n, Q)
    x = jnp.asarray(rng.integers(-(Q // 2), Q // 2 + 1, size=(5, n)), jnp.int32)
    want = np.asarray(ring.fwd(x, num))
    np.testing.assert_array_equal(np.asarray(_kernel_fwd(ring, x, num)), want)


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("n", NS)
def test_kernel_inv_matches_chain(rng, n, num):
    """Inverse of product images (Garner over ``num`` primes + mod-q fold)."""
    ring = ntt.get_ring(n, Q)
    bound = Q // 2 if num == 3 else 7
    a = jnp.asarray(rng.integers(-(Q // 2), Q // 2 + 1, size=(4, n)), jnp.int32)
    b = jnp.asarray(rng.integers(-bound, bound + 1, size=(4, n)), jnp.int32)
    if num == 3:
        xh = ring.dot_hat(ring.fwd_const(a), ring.fwd(b))
    else:
        xh = ring.fwd(b, num)
    want = np.asarray(ring.inv(xh))
    np.testing.assert_array_equal(np.asarray(_kernel_inv(ring, xh)), want)


def test_kernel_odd_batch_pads(rng):
    """Row counts that are no multiple of the block are padded and cut."""
    n = 128
    ring = ntt.get_ring(n, Q)
    assert (3 * 7) % ntt_kernel.block_rows(n)
    x = jnp.asarray(rng.integers(-(Q // 2), Q // 2 + 1, size=(3, 7, n)), jnp.int32)
    got = _kernel_fwd(ring, x, 3)
    assert got.shape == (3, 3, 7, n)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ring.fwd(x)))
    np.testing.assert_array_equal(np.asarray(_kernel_inv(ring, got)), np.asarray(x))


def test_block_shapes():
    """4096-element blocks: more rows at small N, one row and more warps at
    large N, always a power of two."""
    assert ntt_kernel.block_rows(512) == 8
    assert ntt_kernel.block_rows(16) == 256
    assert ntt_kernel.block_rows(8192) == 1
    assert ntt_kernel.num_warps(512) == 4
    assert ntt_kernel.num_warps(8192) == 8
    assert ntt_kernel.num_warps(1 << 20) == 32


def test_engine_gate(monkeypatch):
    """The kernel runs where the default backend is a GPU, whatever the
    device count, and never inside xla_transforms (sharded programs)."""
    assert not ntt._use_kernel()  # the CPU test backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ntt._use_kernel()
    with ntt.xla_transforms():
        assert not ntt._use_kernel()
        with ntt.xla_transforms():
            assert not ntt._use_kernel()
        assert not ntt._use_kernel()
    assert ntt._use_kernel()


@pytest.mark.chip
def test_compiled_kernel_matches_chain(chip):
    """Compiled on the card, at N=512 and a batch of several blocks."""
    ring = ntt.get_ring(512, Q)
    x = jax.random.randint(jax.random.PRNGKey(0), (4099, 512), -(Q // 2),
                           Q // 2 + 1, jnp.int32)

    def chain(v):
        with ntt.xla_transforms():
            xh = ring.fwd(v)
            return xh, ring.inv(ring.dot_hat(ring.fwd_const(v), xh))

    want_hat, want_sq = jax.jit(chain)(x)
    got_hat = jax.jit(lambda v: ntt_kernel.fwd(ring, v, 3))(x)
    assert bool(jnp.array_equal(got_hat, want_hat))
    sq_hat = ring.dot_hat(ring.fwd_const(x), want_hat)
    got_sq = jax.jit(lambda h: ntt_kernel.inv(ring, h))(sq_hat)
    assert bool(jnp.array_equal(got_sq, want_sq))
