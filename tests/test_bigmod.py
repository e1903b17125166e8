"""Wide-modulus rings (q >= 2^32): the reference's full ZqI64 envelope.

The reference's `Params<I, N>` admits any odd i64 modulus
(/root/reference/src/params.rs:18,121-127 is just one instantiation at
q' = 3515337053). Rounds 1-3 capped this build at q < 2^32; round 4 adds
wide rings: centered int64 residues at the API boundary, an extended CRT
prime set sized to the coefficient bound, and a uint32-limb 64-bit
Montgomery fold (ops/mont64.py) for the only mod-q products outside the
NTT domain. These tests pin the envelope at q ~ 2^33 and at the largest
prime below 2^63, end-to-end: arithmetic vs the schoolbook golden model,
full roundtrips for all three protocols, forgery rejection, and the
adversarial norm-check soundness of the int64 path.

Wide rings need jax x64; each test scopes it with
jax.experimental.enable_x64 so the rest of the (x32) suite is untouched.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ringzk_tpu import Params, keygen
from ringzk_tpu.ops import norms, sampling
from ringzk_tpu.ops.ntt import get_ring, negacyclic_schoolbook
from ringzk_tpu.protocols import commit as commit_mod
from ringzk_tpu.protocols import linear, open as open_mod, sum as sum_mod

N = 32
Q33 = 2**33 + 9                       # odd, just past the old 2^32 ceiling
Q63 = 9223372036854775783             # largest prime < 2^63 (ZqI64 edge)

P33 = Params(q=Q33 // 2, modulus=Q33)
P63 = Params(q=Q63 // 2, modulus=Q63)

ALL = [pytest.param(P33, id="q2e33"), pytest.param(P63, id="q2e63")]


def centered_rand(rng, q, shape):
    half = q // 2
    return rng.integers(-half, half + 1, size=shape, dtype=np.int64)


@pytest.mark.parametrize("params", ALL)
def test_polymul_matches_schoolbook(params):
    with jax.enable_x64(True):
        ring = get_ring(N, params.modulus)
        assert ring.wide and ring.num_primes >= 3
        rng = np.random.default_rng(70)
        a = centered_rand(rng, params.modulus, (4, N))
        b = centered_rand(rng, params.modulus, (4, N))
        got = np.asarray(ring.polymul(jnp.asarray(a), jnp.asarray(b)))
        want = negacyclic_schoolbook(a, b, params.modulus)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", ALL)
def test_fwd_inv_roundtrip(params):
    with jax.enable_x64(True):
        ring = get_ring(N, params.modulus)
        rng = np.random.default_rng(71)
        x = centered_rand(rng, params.modulus, (8, N))
        got = np.asarray(ring.inv(ring.fwd(jnp.asarray(x))))
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("params", ALL)
def test_scalar_mul_add_exact(params):
    """t + d*m with a kappa-sparse ternary d and full-range m, t."""
    with jax.enable_x64(True):
        ring = get_ring(N, params.modulus)
        rng = np.random.default_rng(72)
        m = centered_rand(rng, params.modulus, (2, 1, N))
        t = centered_rand(rng, params.modulus, (2, 1, N))
        d = np.zeros((2, N), np.int64)
        d[:, : params.kappa % N] = rng.choice([-1, 1], size=(2, params.kappa % N))
        num = ring.primes_needed(
            min(params.kappa, N) * (params.modulus // 2 + 1)
        )
        got = np.asarray(
            ring.scalar_mul_add(jnp.asarray(d), jnp.asarray(m), jnp.asarray(t), num)
        )
        q = params.modulus
        want = (
            negacyclic_schoolbook(d[:, None], m, q).astype(object) + t.astype(object)
        ) % q
        want = np.where(want > q // 2, want - q, want)
        np.testing.assert_array_equal(got.astype(object), want)


@pytest.mark.parametrize("params", ALL)
def test_open_roundtrip_and_forgery(params):
    with jax.enable_x64(True):
        ck = keygen(jax.random.PRNGKey(80), params, N)
        assert ck.a1_dig is None, "wide moduli exceed digit capacity -> NTT path"
        assert ck.a1.dtype == jnp.int64
        kx, kp, kc = jax.random.split(jax.random.PRNGKey(81), 3)
        x = jnp.asarray(
            centered_rand(np.random.default_rng(82), params.modulus, (4, params.l, N))
        )
        ok, op_ok = open_mod.roundtrip(kp, ck, x, params)
        assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))

        rctx, pcom = open_mod.prover_commit(kp, ck, x, params)
        vctx, chal = open_mod.generate_challenge(kc, pcom, params)
        resp = open_mod.create_response(rctx, chal, params)
        forged = resp._replace(z=resp.z.at[..., 0, 0].add(1))
        assert not bool(jnp.any(open_mod.verify(ck, forged, vctx, params)))


def test_linear_roundtrip_q33():
    with jax.enable_x64(True):
        params = P33
        ck = keygen(jax.random.PRNGKey(83), params, N)
        rng = np.random.default_rng(84)
        g = jnp.asarray(centered_rand(rng, params.modulus, (2, N)))
        x = jnp.asarray(centered_rand(rng, params.modulus, (2, params.l, N)))
        ok, op_ok = linear.roundtrip(jax.random.PRNGKey(85), ck, g, x, params)
        assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_sum_roundtrip_q33():
    with jax.enable_x64(True):
        params = P33
        ck = keygen(jax.random.PRNGKey(86), params, N)
        rng = np.random.default_rng(87)
        gs = jnp.asarray(centered_rand(rng, params.modulus, (2, 3, N)))
        xs = jnp.asarray(centered_rand(rng, params.modulus, (2, 3, params.l, N)))
        ok, op_ok = sum_mod.roundtrip(jax.random.PRNGKey(88), ck, gs, xs, params)
        assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_commit_wrong_message_rejected_q33():
    with jax.enable_x64(True):
        params = P33
        ck = keygen(jax.random.PRNGKey(89), params, N)
        x = jnp.asarray(
            centered_rand(np.random.default_rng(90), params.modulus, (4, params.l, N))
        )
        opening, com = commit_mod.commit(jax.random.PRNGKey(91), ck, x, params)
        assert bool(jnp.all(commit_mod.verify(ck, com, opening, params)))
        bad = opening._replace(x=opening.x.at[..., 0, 0].add(1))
        assert not bool(jnp.any(commit_mod.verify(ck, com, bad, params)))


def test_wide_norm_check_adversarial():
    """Adversarial int64 coefficients far beyond int32 must reject, not
    wrap: the coefficient pre-check is the soundness leg of the wide norm
    path (ops/norms.py)."""
    with jax.enable_x64(True):
        bound = 10_000
        z = jnp.zeros((2, 3, N), jnp.int64).at[0, 0, 0].set(2**61)
        ok = norms.norm2_leq(z, bound, axis=-1)
        assert not bool(ok[0].all()) and bool(ok[1].all())
        # a huge coefficient engineered so the int32-truncated square sum
        # would pass must STILL reject (the wrap attack the pre-check kills)
        sneaky = jnp.zeros((1, N), jnp.int64).at[0, 0].set(2**32)  # int32-trunc 0
        assert not bool(norms.norm2_leq(sneaky, bound, axis=-1).all())


def test_wide_sampling_dtype():
    with jax.enable_x64(True):
        v = sampling.uniform_centered(jax.random.PRNGKey(1), (3,), N, Q33 // 2)
        assert v.dtype == jnp.int64
        assert int(jnp.max(jnp.abs(v))) <= Q33 // 2


def test_validate_envelope():
    with pytest.raises(ValueError, match="2\\^63"):
        Params(modulus=2**63 + 1, q=5).validate()
    # wide ring without x64 -> a clear error, not silent corruption
    if not jax.config.jax_enable_x64:
        with pytest.raises(ValueError, match="x64"):
            get_ring(N, 2**33 + 151)  # fresh modulus, not cached by other tests


def test_wide_wire_roundtrip(tmp_path):
    """RZK1 wire format and checkpointing carry int64 wide-ring pytrees
    (dtype code 3, RAW): dumps -> loads -> rebuild preserves every message
    type bit-for-bit."""
    from ringzk_tpu.utils import checkpoint, serial

    with jax.enable_x64(True):
        params = P33
        ck = keygen(jax.random.PRNGKey(92), params, N)
        x = jnp.asarray(
            centered_rand(np.random.default_rng(93), params.modulus, (2, params.l, N))
        )
        rctx, pcom = open_mod.prover_commit(jax.random.PRNGKey(94), ck, x, params)
        vctx, chal = open_mod.generate_challenge(jax.random.PRNGKey(95), pcom, params)
        resp = open_mod.create_response(rctx, chal, params)

        blob = serial.dumps(resp)
        back = serial.rebuild(open_mod.OpenProofResponse, serial.loads(blob))
        assert back.z.dtype == np.int64
        np.testing.assert_array_equal(np.asarray(resp.z), back.z)

        path = tmp_path / "wide_ctx.rzk"
        checkpoint.save(str(path), rctx)
        restored = checkpoint.load(
            str(path), open_mod.OpenProofResponseContext
        )
        np.testing.assert_array_equal(np.asarray(rctx.y), restored.y)
        np.testing.assert_array_equal(
            np.asarray(rctx.opening.r), restored.opening.r
        )
        # the restored context must still produce a verifying response
        resp2 = open_mod.create_response(restored, chal, params)
        assert bool(open_mod.verify(ck, resp2, vctx, params).all())


def test_wide_dp_mesh_roundtrip():
    """Wide rings through the dp-sharded multi-device path (8-device CPU
    mesh): batch axis sharded, accept-bit psum -- same program as the
    narrow headline config, int64 end to end."""
    from ringzk_tpu.parallel import mesh as pmesh

    with jax.enable_x64(True):
        params = P33
        ck = keygen(jax.random.PRNGKey(96), params, N)
        x = jnp.asarray(
            centered_rand(np.random.default_rng(97), params.modulus, (16, params.l, N))
        )
        m = pmesh.make_mesh()
        ok, all_ok = pmesh.batched_open_prove_verify(
            m, jax.random.PRNGKey(98), ck, x, params
        )
        assert ok.shape == (16,) and bool(np.asarray(all_ok))


def test_sp_ring_rejects_wide():
    """SpRing's sharded transform programs are int32-native; wide moduli
    must be refused cleanly (scoped non-goal, see parallel/ring_sp.py)."""
    from ringzk_tpu.parallel import ring_sp

    with jax.enable_x64(True):
        m = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("sp",))
        with pytest.raises(ValueError, match="wide"):
            ring_sp.SpRing(n=N, q=Q33, mesh=m)


def test_wide_small_q_takes_ntt_path():
    """A wide modulus with a small sampling bound must NOT build the int8
    digit operator (its uint32 mont_mul fold cannot carry wide residues):
    keygen routes to the NTT path and the roundtrip still verifies.
    Regression: round-4 gated on q <= digit_capacity only, so
    Params(q=1e6, modulus=2^33+9) crashed in matvec_digits."""
    with jax.enable_x64(True):
        params = Params(q=10**6, modulus=Q33)
        ck = keygen(jax.random.PRNGKey(99), params, N)
        assert ck.a1_dig is None and ck.a2_dig is None
        x = jnp.asarray(
            np.random.default_rng(100).integers(
                -params.q, params.q + 1, size=(2, params.l, N), dtype=np.int64
            )
        )
        ok, op_ok = open_mod.roundtrip(jax.random.PRNGKey(101), ck, x, params)
        assert bool(jnp.all(ok)) and bool(jnp.all(op_ok))


def test_polymul_tp_rejects_wide():
    """polymul_tp's fixed tp=3 program is narrow-only: wide moduli need
    more CRT primes and int64 residues -- reject, don't truncate."""
    from ringzk_tpu.parallel import ntt_tp

    with jax.enable_x64(True):
        m = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("tp",))
        a = jnp.zeros((16,), jnp.int64)
        with pytest.raises(ValueError, match="narrow"):
            ntt_tp.polymul_tp(m, a, a, 16, Q33)
