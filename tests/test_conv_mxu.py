"""Digit-matmul matvec must agree bit-for-bit with the NTT path, and
prime-subset NTT products must stay exact within their declared bounds."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ringzk_tpu.ops import conv_mxu, mat, ntt

Q = 3_515_337_053


@pytest.fixture(scope="module")
def ring():
    return ntt.get_ring(64, Q)


def _rand_key_matrix(rng, rows, k, n):
    return rng.integers(-(Q // 2), Q // 2 + 1, size=(rows, k, n)).astype(np.int64)


def _ntt_matvec(ring, a, v):
    a_hat = ring.fwd_const(jnp.asarray(a, jnp.int32))
    v_hat = ring.fwd(jnp.asarray(v, jnp.int32))
    return np.asarray(ring.inv(mat.matvec_hat(ring, a_hat, v_hat)))


def test_balanced_digits_roundtrip(rng):
    v = rng.integers(-(2**20), 2**20, size=(4, 32)).astype(np.int32)
    nd = conv_mxu.digits_for_bound(2**20)
    d = np.asarray(conv_mxu.balanced_digits(jnp.asarray(v), nd)).astype(np.int64)
    recon = sum(d[i] * conv_mxu.RADIX**i for i in range(nd))
    np.testing.assert_array_equal(recon, v)


def test_digit_capacity_consistent():
    for nd in range(1, 6):
        cap = conv_mxu.digit_capacity(nd)
        assert conv_mxu.digits_for_bound(cap) == nd
        assert conv_mxu.digits_for_bound(cap + 1) == nd + 1


@pytest.mark.parametrize("v_bound,rows", [(1, 2), (1_400_000, 1), (2**20, 2)])
def test_mxu_matvec_matches_ntt(ring, rng, v_bound, rows):
    n, k = 64, 3
    a = _rand_key_matrix(rng, rows, k, n)
    op = conv_mxu.KeyOperator(a, ring)
    v = rng.integers(-v_bound, v_bound + 1, size=(5, k, n)).astype(np.int32)
    nd = conv_mxu.digits_for_bound(v_bound)
    got = np.asarray(op.matvec(jnp.asarray(v), nd))
    want = _ntt_matvec(ring, a, v)
    np.testing.assert_array_equal(got, want)


def test_mxu_matvec_full_range_key_small_v(ring, rng):
    """Extreme key values with ternary v (the commit path)."""
    n, k = 64, 3
    a = np.full((2, k, n), Q // 2, dtype=np.int64)
    a[0, 0, 0] = -(Q // 2)
    op = conv_mxu.KeyOperator(a, ring)
    v = rng.integers(-1, 2, size=(3, k, n)).astype(np.int32)
    got = np.asarray(op.matvec(jnp.asarray(v), 1))
    want = _ntt_matvec(ring, a, v)
    np.testing.assert_array_equal(got, want)


# -- prime-subset NTT --------------------------------------------------------


def test_primes_needed(ring):
    assert ring.primes_needed(36) == 1
    assert ring.primes_needed(2**36) == 2
    assert ring.primes_needed(2**70) == 3


@pytest.mark.parametrize("num", [1, 2, 3])
def test_subset_prime_product_exact(ring, rng, num):
    """Products whose integer coefficients fit the subset range must be
    exact with fewer primes."""
    n = 64
    # pick operand bounds so that the conv bound n*b1*b2 fits num primes
    prod = 1
    for p in ntt.PRIMES[:num]:
        prod *= p
    b2 = 1
    b1 = min(Q // 2, (prod // 2) // (n * b2) - 1)
    a = rng.integers(-b1, b1 + 1, size=(3, n)).astype(np.int64)
    b = rng.integers(-b2, b2 + 1, size=(3, n)).astype(np.int64)
    ah = ring.fwd_const(jnp.asarray(a, jnp.int32), num)
    bh = ring.fwd(jnp.asarray(b, jnp.int32), num)
    got = np.asarray(ring.inv(ring.dot_hat(ah, bh)))
    want = ntt.negacyclic_schoolbook(a, b, Q)
    np.testing.assert_array_equal(got, want)


def test_subset_prime_add_mixed_magnitude(ring, rng):
    """t + c1*d with arbitrary-int32 t and kappa-sparse d fits 2 primes."""
    n = 64
    kappa = 36
    t = rng.integers(-(2**31), 2**31, size=(2, n)).astype(np.int64)
    c1 = rng.integers(-(Q // 2), Q // 2 + 1, size=(2, n)).astype(np.int64)
    d = np.zeros((2, n), np.int64)
    d[:, :kappa] = rng.choice([-1, 1], size=(2, kappa))
    d_hat = ring.fwd_const(jnp.asarray(d, jnp.int32), 2)
    rhs = ring.inv(
        ring.add_hat(
            ring.fwd(jnp.asarray(t, jnp.int32), 2),
            ring.dot_hat(d_hat, ring.fwd(jnp.asarray(c1, jnp.int32), 2)),
        )
    )
    want = ntt.negacyclic_schoolbook(d, c1, Q).astype(object)
    want = (want + t.astype(object)) % Q
    want = np.where(want > Q // 2, want - Q, want)
    np.testing.assert_array_equal(np.asarray(rhs).astype(object), want)


def test_mxu_max_n_cap_gates_digit_operator():
    """MXU_MAX_N caps the digit operator both ways and verdicts stay
    engine-independent. Patch the module global rather than reloading
    (reload would re-mint the NamedTuple classes under other modules)."""
    import ringzk_tpu as rz
    from ringzk_tpu.protocols import commit as commit_mod
    from ringzk_tpu.protocols import open as open_mod

    params = rz.Params()
    saved = commit_mod.MXU_MAX_N
    try:
        commit_mod.MXU_MAX_N = 64          # cap below N: no digits
        ck_ntt = commit_mod.keygen(jax.random.PRNGKey(0), params, 128)
        assert ck_ntt.a1_dig is None
        commit_mod.MXU_MAX_N = 128         # cap at N (inclusive): digits
        ck_dig = commit_mod.keygen(jax.random.PRNGKey(0), params, 128)
        assert ck_dig.a1_dig is not None
    finally:
        commit_mod.MXU_MAX_N = saved

    # identical key material, engine-independent verdicts
    np.testing.assert_array_equal(np.asarray(ck_ntt.a1), np.asarray(ck_dig.a1))
    k = jax.random.PRNGKey(1)
    x = jax.random.randint(k, (4, params.l, 128), -params.q, params.q + 1, jnp.int32)
    ok_a, op_a = open_mod.roundtrip(k, ck_ntt, x, params)
    ok_b, op_b = open_mod.roundtrip(k, ck_dig, x, params)
    np.testing.assert_array_equal(np.asarray(ok_a & op_a), np.asarray(ok_b & op_b))
    assert bool((ok_b & op_b).all())


def test_fused_full_key_matvec_bit_identical():
    """matvec_key('a', ...) with the fused [kN, D*(n+l)N] operator
    (RINGZK_FUSED_A=1, opt-in) must equal the two row-block matmuls
    (RINGZK_FUSED_A=0, the measured-faster default) AND the exact NTT path,
    for both digit widths the protocols use (ternary r and verify-bound z)."""
    from conftest import env_override
    from ringzk_tpu import Params
    from ringzk_tpu.protocols import commit as commit_mod

    params = Params()
    n_deg = 64
    ring = ntt.get_ring(n_deg, params.modulus)
    ck = commit_mod.keygen(jax.random.PRNGKey(3), params, n_deg)
    assert ck.a1_dig is not None and ck.a2_dig is not None

    for bound in (params.b, params.commit_bound(n_deg)):
        v = jax.random.randint(
            jax.random.PRNGKey(4), (5, params.k, n_deg), -bound, bound + 1,
            jnp.int32,
        )
        with env_override("RINGZK_FUSED_A", "1"):
            fused = np.asarray(commit_mod.matvec_key(ring, ck, "a", v, bound))
        with env_override("RINGZK_FUSED_A", "0"):
            split = np.asarray(commit_mod.matvec_key(ring, ck, "a", v, bound))
        a = np.concatenate([np.asarray(ck.a1), np.asarray(ck.a2)], axis=0)
        want = _ntt_matvec(ring, a.astype(np.int64), np.asarray(v))
        np.testing.assert_array_equal(fused, split)
        np.testing.assert_array_equal(fused, want)


def test_argkey_jit_bit_identical_n4096():
    """The N=4096 digit engine (on by default: commit.MXU_MAX_N) must be
    bit-identical whether the key is CLOSED OVER by jit (operators baked as
    program constants) or passed as a jit ARGUMENT (the recommended form at
    N>=4096), and must match the NTT key path."""
    import ringzk_tpu as rz
    from conftest import env_override
    from ringzk_tpu.protocols import commit as commit_mod

    params = rz.Params()
    n_deg = 4096
    ring = ntt.get_ring(n_deg, params.modulus)
    saved = commit_mod.MXU_MAX_N
    try:
        commit_mod.MXU_MAX_N = 4096
        ck = commit_mod.keygen(jax.random.PRNGKey(3), params, n_deg)
        assert ck.a1_dig is not None
    finally:
        commit_mod.MXU_MAX_N = saved
    with env_override("RINGZK_MXU", "0"):
        ck_ntt = commit_mod.keygen(jax.random.PRNGKey(3), params, n_deg)
    assert ck_ntt.a1_dig is None

    bound = params.verify_bound(n_deg)
    v = jax.random.randint(
        jax.random.PRNGKey(4), (1, params.k, n_deg), -bound, bound + 1, jnp.int32
    )
    closed = jax.jit(
        lambda v: commit_mod.matvec_key(ring, ck, "a", v, bound)
    )(v)
    argkey = jax.jit(
        lambda ck, v: commit_mod.matvec_key(ring, ck, "a", v, bound)
    )(ck, v)
    via_ntt = commit_mod.matvec_key(ring, ck_ntt, "a", v, bound)
    np.testing.assert_array_equal(np.asarray(closed), np.asarray(argkey))
    np.testing.assert_array_equal(np.asarray(closed), np.asarray(via_ntt))


# -- the digit matvec against the schoolbook golden model -----------------


def _schoolbook_matvec(a, v, q):
    """(A . v) mod q, centered: a [rows, k, N], v [B, k, N] -> [B, rows, N]."""
    a = np.asarray(a, np.int64)
    v = np.asarray(v, np.int64)
    out = np.zeros((v.shape[0], a.shape[0], a.shape[-1]), dtype=object)
    for row in range(a.shape[0]):
        for t in range(a.shape[1]):
            out[:, row] += ntt.negacyclic_schoolbook(
                a[row, t][None], v[:, t], q
            ).astype(object)
    out %= q
    return np.where(out > q // 2, out - q, out).astype(np.int64)


@pytest.mark.parametrize("which,bound", [("a1", 1), ("a", 10**6)])
def test_digit_matvec_matches_schoolbook_n512(which, bound):
    """matvec_key on the default N=512 key: the ternary commit width and
    the 3-digit response width, both key matrices."""
    from ringzk_tpu import Params
    from ringzk_tpu.protocols import commit as commit_mod

    params = Params()
    n_deg = 512
    ring = ntt.get_ring(n_deg, params.modulus)
    ck = commit_mod.keygen(jax.random.PRNGKey(40), params, n_deg)
    assert ck.a1_dig is not None and ck.a1_dig.shape == (
        params.k * n_deg, conv_mxu.KEY_DIGITS * params.n * n_deg
    )
    v = jax.random.randint(jax.random.PRNGKey(41), (2, params.k, n_deg),
                           -bound, bound + 1, jnp.int32)
    got = np.asarray(commit_mod.matvec_key(ring, ck, which, v, bound))
    a = ck.a1 if which == "a1" else jnp.concatenate([ck.a1, ck.a2], axis=0)
    np.testing.assert_array_equal(got, _schoolbook_matvec(a, v, params.modulus))


def test_digit_matvec_n1024_matches_schoolbook():
    """A one-row key at N=1024 (a 3072 x 4096 int8 operator), 1 and 3
    digits, an odd batch."""
    n_deg, k = 1024, 3
    ring = ntt.get_ring(n_deg, Q)
    a = jax.random.randint(jax.random.PRNGKey(50), (1, k, n_deg), -(Q // 2),
                           Q // 2 + 1, jnp.int32)
    w = conv_mxu.build_operator_digits_device(a, ring)
    for ndig, bound in [(1, 1), (3, 10**6)]:
        v = jax.random.randint(jax.random.PRNGKey(51), (3, k, n_deg), -bound,
                               bound + 1, jnp.int32)
        got = np.asarray(conv_mxu.matvec_digits(ring, w, 1, v, ndig))
        np.testing.assert_array_equal(got, _schoolbook_matvec(a, v, Q))


def test_keygen_digit_operator_n1024_commit_verify():
    """keygen at N=1024 builds the [kN, D*rowsN] operators, and a
    commitment made and opened through them verifies (a wrong message
    does not)."""
    from ringzk_tpu import Params, keygen
    from ringzk_tpu.protocols import commit as commit_mod

    params = Params()
    n_deg = 1024
    ck = keygen(jax.random.PRNGKey(53), params, n_deg)
    assert ck.a2_dig.shape == (
        params.k * n_deg, conv_mxu.KEY_DIGITS * params.l * n_deg
    )
    x = jax.random.randint(jax.random.PRNGKey(54), (2, params.l, n_deg),
                           -params.q, params.q + 1, jnp.int32)
    opening, com = commit_mod.commit(jax.random.PRNGKey(55), ck, x, params)
    assert bool(jnp.all(commit_mod.verify(ck, com, opening, params)))
    bad = opening._replace(x=opening.x.at[..., 0, 0].add(1))
    assert not bool(jnp.any(commit_mod.verify(ck, com, bad, params)))


def test_operator_device_build_matches_host(rng):
    """The on-device operator build equals the host KeyOperator digit for
    digit (full-range key entries)."""
    n, k, rows = 64, 3, 2
    ring = ntt.get_ring(n, Q)
    a = _rand_key_matrix(rng, rows, k, n)
    host = np.asarray(conv_mxu.KeyOperator(a, ring).w_digits)
    dev = np.asarray(
        conv_mxu.build_operator_digits_device(jnp.asarray(a, jnp.int32), ring)
    )
    np.testing.assert_array_equal(dev, host)
