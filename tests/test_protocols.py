"""Tier-2 integration tests: batched randomized protocol round-trips.

The reference runs 100 sequential randomized iterations per protocol at N=16
(/root/reference/tests/test.rs); here the 100 iterations are a *batch axis*
of one jitted program -- the batched equivalent -- plus the negative-path
tests the reference lacks (forged responses must fail; SURVEY.md section 4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ringzk_tpu import Params, keygen
from ringzk_tpu.protocols import commit as commit_mod
from ringzk_tpu.protocols import linear, open as open_mod, sum as sum_mod

N = 16
B = 100  # the reference's 100 iterations, as one batch
PARAMS = Params()


@pytest.fixture(scope="module")
def ck():
    return keygen(jax.random.PRNGKey(42), PARAMS, N)


def rand_x(key, batch):
    return jax.random.randint(
        key, batch + (PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32
    )


def rand_g(key, batch):
    return jax.random.randint(
        key, batch + (N,), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32
    )


# -- commitment scheme -------------------------------------------------------


def test_commit_verify_roundtrip(ck):
    kx, kc = jax.random.split(jax.random.PRNGKey(0))
    x = rand_x(kx, (B,))
    opening, com = commit_mod.commit(kc, ck, x, PARAMS)
    ok = commit_mod.verify(ck, com, opening, PARAMS)
    assert bool(jnp.all(ok))


def test_commit_wrong_opening_fails(ck):
    """README doctest semantics (/root/reference/src/commit.rs:151-171):
    an opening for a different message must not verify."""
    kx, kx2, kc, kc2 = jax.random.split(jax.random.PRNGKey(1), 4)
    x, x2 = rand_x(kx, (8,)), rand_x(kx2, (8,))
    opening, com = commit_mod.commit(kc, ck, x, PARAMS)
    opening2, com2 = commit_mod.commit(kc2, ck, x2, PARAMS)
    assert bool(jnp.all(commit_mod.verify(ck, com, opening, PARAMS)))
    assert not bool(jnp.any(commit_mod.verify(ck, com, opening2, PARAMS)))
    assert not bool(jnp.any(commit_mod.verify(ck, com2, opening, PARAMS)))


def test_commit_oversized_r_fails(ck):
    """Adversarial r violating the commit constraint must be rejected even
    if the algebra holds (the constraint check at
    /root/reference/src/commit.rs:182-184)."""
    kx, kc = jax.random.split(jax.random.PRNGKey(2))
    x = rand_x(kx, (4,))
    opening, com = commit_mod.commit(kc, ck, x, PARAMS)
    big = PARAMS.commit_bound(N) + 1
    bad_r = opening.r.at[..., 0, 0].set(big)
    bad = opening._replace(r=bad_r)
    assert not bool(jnp.any(commit_mod.verify(ck, com, bad, PARAMS)))


def test_commit_relaxed_opening_with_f(ck):
    """The relaxed verification f*c == a.r + f*[0;x]
    (/root/reference/src/commit.rs:200-209): exercised with a challenge-set
    f, which the reference defines but never exercises (f is always None)."""
    from ringzk_tpu.ops import sampling

    kx, kc, kf = jax.random.split(jax.random.PRNGKey(3), 3)
    x = rand_x(kx, (4,))
    opening, com = commit_mod.commit(kc, ck, x, PARAMS)
    f = sampling.challenge(kf, (4,), N, PARAMS.kappa)
    relaxed = opening._replace(f=f)
    # identity-f equivalence: f == 1 behaves exactly like f == None
    one = jnp.zeros((4, N), jnp.int32).at[..., 0].set(1)
    assert bool(jnp.all(commit_mod.verify(ck, com, opening._replace(f=one), PARAMS)))
    # honest opening with a random nonzero f: the relation f*c == a.r + f*z
    # does NOT hold for f != 1 with an honest (non-relaxed) commitment
    assert not bool(jnp.any(commit_mod.verify(ck, com, relaxed, PARAMS)))


# -- proof of opening --------------------------------------------------------


def test_open_proof_roundtrip(ck):
    kx, kp = jax.random.split(jax.random.PRNGKey(4))
    x = rand_x(kx, (B,))
    ok, opening_ok = jax.jit(
        lambda k, x: open_mod.roundtrip(k, ck, x, PARAMS)
    )(kp, x)
    assert bool(jnp.all(ok)) and bool(jnp.all(opening_ok))


def test_open_proof_forged_response_fails(ck):
    kx, kp, kc = jax.random.split(jax.random.PRNGKey(5), 3)
    x = rand_x(kx, (8,))
    rctx, pcom = open_mod.prover_commit(kp, ck, x, PARAMS)
    vctx, chal = open_mod.generate_challenge(kc, pcom, PARAMS)
    resp = open_mod.create_response(rctx, chal, PARAMS)
    assert bool(jnp.all(open_mod.verify(ck, resp, vctx, PARAMS)))
    forged = resp._replace(z=resp.z.at[..., 0, 0].add(1))
    assert not bool(jnp.any(open_mod.verify(ck, forged, vctx, PARAMS)))


def test_open_proof_norm_violation_fails(ck):
    kx, kp, kc = jax.random.split(jax.random.PRNGKey(6), 3)
    x = rand_x(kx, (4,))
    rctx, pcom = open_mod.prover_commit(kp, ck, x, PARAMS)
    vctx, chal = open_mod.generate_challenge(kc, pcom, PARAMS)
    resp = open_mod.create_response(rctx, chal, PARAMS)
    huge = resp._replace(z=resp.z.at[..., 0, 0].set(PARAMS.verify_bound(N) + 1))
    assert not bool(jnp.any(open_mod.verify(ck, huge, vctx, PARAMS)))


# -- proof of linear relation ------------------------------------------------


def test_linear_proof_roundtrip(ck):
    kx, kg, kp = jax.random.split(jax.random.PRNGKey(7), 3)
    x, g = rand_x(kx, (B,)), rand_g(kg, (B,))
    ok, op_ok = jax.jit(
        lambda k: linear.roundtrip(k, ck, g, x, PARAMS)
    )(kp)
    assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_linear_proof_wrong_relation_fails(ck):
    """Commit to x' != g*x: verifier's third equation must reject."""
    kx, kg, kp, kc = jax.random.split(jax.random.PRNGKey(8), 4)
    x, g = rand_x(kx, (4,)), rand_g(kg, (4,))
    rctx, pcom = linear.prover_commit(kp, ck, g, x, PARAMS)
    # swap g in the public commitment for a different scalar
    bad_g = rand_g(jax.random.PRNGKey(99), (4,))
    pcom_bad = pcom._replace(g=bad_g)
    vctx, chal = linear.generate_challenge(kc, pcom_bad, PARAMS)
    resp = linear.create_response(rctx, chal, PARAMS)
    assert not bool(jnp.any(linear.verify(ck, resp, vctx, PARAMS)))


# -- proof of sum ------------------------------------------------------------


@pytest.mark.parametrize("vl", [1, 4])
def test_sum_proof_roundtrip(ck, vl):
    kx, kg, kp = jax.random.split(jax.random.PRNGKey(9), 3)
    xs = jax.random.randint(
        kx, (16, vl, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32
    )
    gs = jax.random.randint(kg, (16, vl, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32)
    ok, op_ok = jax.jit(lambda k: sum_mod.roundtrip(k, ck, gs, xs, PARAMS))(kp)
    assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_sum_proof_forged_summand_fails(ck):
    kx, kg, kp, kc = jax.random.split(jax.random.PRNGKey(10), 4)
    xs = jax.random.randint(
        kx, (2, 4, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32
    )
    gs = jax.random.randint(kg, (2, 4, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32)
    rctx, pcom = sum_mod.prover_commit(kp, ck, gs, xs, PARAMS)
    vctx, chal = sum_mod.generate_challenge(kc, pcom, PARAMS)
    resp = sum_mod.create_response(rctx, chal, PARAMS)
    assert bool(jnp.all(sum_mod.verify(ck, resp, vctx, PARAMS)))
    forged = resp._replace(zs=resp.zs.at[..., 1, 0, 0].add(3))
    assert not bool(jnp.any(sum_mod.verify(ck, forged, vctx, PARAMS)))


def test_sum_proof_length_mismatch_rejected(ck):
    """The corrected length check (reference bug at
    /root/reference/src/prove/sum.rs:272-275 uses && for ||)."""
    kx, kg, kp, kc = jax.random.split(jax.random.PRNGKey(11), 4)
    xs = jax.random.randint(
        kx, (2, 4, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32
    )
    gs = jax.random.randint(kg, (2, 4, N), -PARAMS.q, PARAMS.q + 1, dtype=jnp.int32)
    rctx, pcom = sum_mod.prover_commit(kp, ck, gs, xs, PARAMS)
    vctx, chal = sum_mod.generate_challenge(kc, pcom, PARAMS)
    resp = sum_mod.create_response(rctx, chal, PARAMS)
    short = resp._replace(zs=resp.zs[..., :3, :, :])
    with pytest.raises(ValueError, match="summand count"):
        sum_mod.verify(ck, short, vctx, PARAMS)


# -- fresh keys per proof (the reference's loop regenerates keys) ------------


def test_batched_keys(ck):
    """Independent commitment keys as a batch axis (the reference generates
    a fresh ck every iteration; here keys batch like everything else)."""
    kk, kx, kp = jax.random.split(jax.random.PRNGKey(12), 3)
    cks = keygen(kk, PARAMS, N, batch_shape=(8,))
    x = rand_x(kx, (8,))
    ok, opening_ok = open_mod.roundtrip(kp, cks, x, PARAMS)
    assert bool(jnp.all(ok)) and bool(jnp.all(opening_ok))


def test_stacked_sibling_matvec_bit_identical(ck):
    """Stacked full-key matvecs (RINGZK_STACKED=2: linear's y/yp and z/zp
    plus sum's ys+yp / zs+zp; =1 is the sum-only default) must produce
    bit-identical protocol transcripts AND verdicts vs the per-vector
    dispatches (RINGZK_STACKED=0): the stack axis is just more independent
    matmul rows (protocols/commit.py:matvec_key_siblings,
    sum.py:_matvec_key_v1)."""
    from conftest import env_override

    # the stacked path requires the digit engine (stack_siblings_ok); without
    # operators both arms take the identical per-vector path and this test
    # would pass vacuously
    assert ck.a1_dig is not None and ck.a2_dig is not None

    def linear_transcript():
        kg, kx, kp, kc = jax.random.split(jax.random.PRNGKey(21), 4)
        g, x = rand_g(kg, (6,)), rand_x(kx, (6,))
        rctx, pcom = linear.prover_commit(kp, ck, g, x, PARAMS)
        vctx, chal = linear.generate_challenge(kc, pcom, PARAMS)
        resp = linear.create_response(rctx, chal, PARAMS)
        ok = linear.verify(ck, resp, vctx, PARAMS)
        return [pcom.t, pcom.tp, pcom.u, resp.z, resp.zp, ok]

    def sum_transcript():
        kg, kx, kp, kc = jax.random.split(jax.random.PRNGKey(22), 4)
        gs = jax.random.randint(kg, (4, 3, N), -PARAMS.q, PARAMS.q + 1, jnp.int32)
        xs = jax.random.randint(
            kx, (4, 3, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, jnp.int32
        )
        rctx, pcom = sum_mod.prover_commit(kp, ck, gs, xs, PARAMS)
        vctx, chal = sum_mod.generate_challenge(kc, pcom, PARAMS)
        resp = sum_mod.create_response(rctx, chal, PARAMS)
        ok = sum_mod.verify(ck, resp, vctx, PARAMS)
        return [pcom.ts, pcom.tp, pcom.u, resp.zs, resp.zp, ok]

    for transcript in (linear_transcript, sum_transcript):
        with env_override("RINGZK_STACKED", "2"):
            stacked = [np.asarray(a) for a in transcript()]
        with env_override("RINGZK_STACKED", "0"):
            split = [np.asarray(a) for a in transcript()]
        assert bool(stacked[-1].all()), "stacked roundtrip must verify"
        for a, b in zip(stacked, split):
            np.testing.assert_array_equal(a, b)


def test_stacked_flag_safe_with_batched_keys():
    """RINGZK_STACKED=2 must not break batched keys: those have no digit
    operators, so stack_siblings_ok routes them to the per-vector NTT path
    (a stacked axis would misalign against the key-batch broadcast in
    mat.matvec_hat). The linear roundtrip must still verify."""
    from conftest import env_override

    kk, kg, kx, kp = jax.random.split(jax.random.PRNGKey(23), 4)
    cks = keygen(kk, PARAMS, N, batch_shape=(4,))
    assert cks.a1_dig is None
    g, x = rand_g(kg, (4,)), rand_x(kx, (4,))
    with env_override("RINGZK_STACKED", "2"):
        ok, op_ok = linear.roundtrip(kp, cks, g, x, PARAMS)
    assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_roundtrip_chains(ck):
    """chains>1 splits the batch into independent sub-chains (the measured
    cross-chain overlap win, BENCHMARKS.md): all proofs must verify, a
    forged input must still fail, and a non-divisible batch must raise."""
    kx, kp = jax.random.split(jax.random.PRNGKey(31))
    x = rand_x(kx, (8,))
    ok, op_ok = jax.jit(
        lambda k, x: open_mod.roundtrip(k, ck, x, PARAMS, chains=2)
    )(kp, x)
    assert ok.shape == (8,) and bool(jnp.all(ok)) and bool(jnp.all(op_ok))
    # deep chain counts (the shipped default moved to 12 chains in round
    # 5's chain-scaling retune): still one verdict per proof, all passing
    x24 = rand_x(kx, (24,))
    ok12, op12 = jax.jit(
        lambda k, x: open_mod.roundtrip(k, ck, x, PARAMS, chains=12)
    )(kp, x24)
    assert ok12.shape == (24,) and bool(jnp.all(ok12)) and bool(jnp.all(op12))
    with pytest.raises(ValueError, match="chains"):
        open_mod.roundtrip(kp, ck, rand_x(kx, (6,))[:5], PARAMS, chains=2)

    kg = jax.random.PRNGKey(32)
    g = rand_g(kg, (8,))
    okl, opl = linear.roundtrip(kp, ck, g, x, PARAMS, chains=2)
    assert okl.shape == (8,) and bool(jnp.all(okl)) and bool(jnp.all(opl))

    gs = jax.random.randint(kg, (8, 2, N), -PARAMS.q, PARAMS.q + 1, jnp.int32)
    xs = jax.random.randint(
        kx, (8, 2, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, jnp.int32
    )
    oks, ops = sum_mod.roundtrip(kp, ck, gs, xs, PARAMS, chains=2)
    assert oks.shape == (8,) and bool(jnp.all(oks)) and bool(jnp.all(ops))

    # an UNBATCHED call must be rejected, not silently split along a
    # protocol structure axis (V here -- that would prove a different
    # statement; same for open's l rows)
    with pytest.raises(ValueError, match="unbatched"):
        sum_mod.roundtrip(kp, ck, gs[0], xs[0], PARAMS, chains=2)
    with pytest.raises(ValueError, match="unbatched"):
        open_mod.roundtrip(kp, ck, rand_x(kx, ())[0:], PARAMS, chains=2)

    # non-array inputs are normalized (list-of-arrays == the stacked array)
    # or rejected with the intended ValueError -- never an AttributeError
    # from .ndim probing
    okl2, opl2 = open_mod.roundtrip(kp, ck, list(x), PARAMS, chains=2)
    assert okl2.shape == (8,) and bool(jnp.all(okl2))
    with pytest.raises(ValueError):
        open_mod.roundtrip(kp, ck, 3, PARAMS, chains=2)


def test_roundtrip_staggered_matches_chained(ck):
    """RINGZK_STAGGER=1 (the explicit five-stage pipeline) must reproduce
    chained_roundtrip(chains=2) bit for bit: same key derivation, same
    chain split, same verdicts -- the barriers only pin scheduling."""
    from conftest import env_override

    kx, kp = jax.random.split(jax.random.PRNGKey(77))
    x = rand_x(kx, (8,))
    want = open_mod.roundtrip(kp, ck, x, PARAMS, chains=2)
    with env_override("RINGZK_STAGGER", "1"):
        got = open_mod.roundtrip(kp, ck, x, PARAMS, chains=2)
    assert jnp.array_equal(got[0], want[0]) and jnp.array_equal(got[1], want[1])
    assert bool(jnp.all(got[0])) and bool(jnp.all(got[1]))
    # generalized pipeline: chains=4 must also match the free-scheduled form
    want4 = open_mod.roundtrip(kp, ck, x, PARAMS, chains=4)
    with env_override("RINGZK_STAGGER", "1"):
        got4 = open_mod.roundtrip(kp, ck, x, PARAMS, chains=4)
    assert jnp.array_equal(got4[0], want4[0])
    assert jnp.array_equal(got4[1], want4[1])


def test_shared_dhat_bit_identity(ck):
    """RINGZK_SHARED_DHAT=1 (challenge transformed at the verifier's
    prime-subset size in create_response, sliced for the product) must be
    bit-identical to the default: per-prime transforms are independent, so
    extra planes never change the product planes. All three protocols."""
    from conftest import env_override

    kx, kg, kp = jax.random.split(jax.random.PRNGKey(91), 3)
    x = rand_x(kx, (8,))
    want = open_mod.roundtrip(kp, ck, x, PARAMS)
    with env_override("RINGZK_SHARED_DHAT", "1"):
        got = open_mod.roundtrip(kp, ck, x, PARAMS)
    assert jnp.array_equal(got[0], want[0]) and jnp.array_equal(got[1], want[1])
    assert bool(jnp.all(got[0])) and bool(jnp.all(got[1]))

    g = rand_g(kg, (8,))
    wl = linear.roundtrip(kp, ck, g, x, PARAMS)
    with env_override("RINGZK_SHARED_DHAT", "1"):
        gl = linear.roundtrip(kp, ck, g, x, PARAMS)
    assert all(jnp.array_equal(a, b) for a, b in zip(gl, wl))
    assert bool(jnp.all(gl[0]))

    gs = jax.random.randint(kg, (8, 2, N), -PARAMS.q, PARAMS.q + 1, jnp.int32)
    xs = jax.random.randint(
        kx, (8, 2, PARAMS.l, N), -PARAMS.q, PARAMS.q + 1, jnp.int32
    )
    ws = sum_mod.roundtrip(kp, ck, gs, xs, PARAMS)
    with env_override("RINGZK_SHARED_DHAT", "1"):
        ss = sum_mod.roundtrip(kp, ck, gs, xs, PARAMS)
    assert all(jnp.array_equal(a, b) for a, b in zip(ss, ws))
    assert bool(jnp.all(ss[0]))


def test_verify_honest_bound_hint_soundness(ck):
    """The honest_r_bound hint (the round-5 CSE lever) must not weaken
    verification: with the hint, a correct self-produced opening still
    passes and a WRONG-message opening still fails (the algebra check is
    unchanged; only the digit width of the A.r decomposition shrinks)."""
    kx, kx2, kc = jax.random.split(jax.random.PRNGKey(88), 3)
    x, x2 = rand_x(kx, (4,)), rand_x(kx2, (4,))
    opening, com = commit_mod.commit(kc, ck, x, PARAMS)
    ok = commit_mod.verify(ck, com, opening, PARAMS, honest_r_bound=PARAMS.b)
    assert bool(jnp.all(ok))
    wrong = opening._replace(x=x2)
    bad = commit_mod.verify(ck, com, wrong, PARAMS, honest_r_bound=PARAMS.b)
    assert not bool(jnp.any(bad))
    # and the hinted result equals the unhinted one bit-for-bit on honest r
    ok2 = commit_mod.verify(ck, com, opening, PARAMS)
    assert jnp.array_equal(ok, ok2)


def test_roundtrip_chains4(ck):
    """chains=4 (the round-5 shipped bench default) splits into four
    independent sub-chains; all proofs verify."""
    kx, kp = jax.random.split(jax.random.PRNGKey(89))
    x = rand_x(kx, (8,))
    ok, op_ok = open_mod.roundtrip(kp, ck, x, PARAMS, chains=4)
    assert ok.shape == (8,) and bool(jnp.all(ok)) and bool(jnp.all(op_ok))
