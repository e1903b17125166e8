"""Random samplers for the commitment scheme and sigma protocols.

Batched analog of the reference's three samplers:

  * uniform coefficients in [-bound, bound]
    (/root/reference/src/polynomial.rs:14-25)
  * iid Gaussian coefficients cast to integers -- a rounded/truncated
    discrete Gaussian (/root/reference/src/polynomial.rs:28-44; the Rust
    code converts f64 draws with ``I::from_f64``)
  * challenge-space polynomials: exactly kappa coefficients equal to +-1,
    positions chosen by shuffle (/root/reference/src/challenge_space.rs:12-33)

All samplers take an explicit ``jax.random`` key and a ``shape`` prefix, and
append the ring axis N themselves, so a batch of proofs draws all its
randomness in one fused kernel. Divergence note (documented, intentional):
the bit-stream differs from Rust `rand 0.10`; distributions are equivalent.
The reference's exact stream can only be matched by replaying its RNG -- see
utils/testvectors.py for the golden-vector interchange format instead.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp


def uniform_centered(key, shape, n: int, bound: int):
    """Uniform iid coefficients in [-bound, bound], ``shape + (n,)``.

    int32 for bounds up to 2^31 - 2 (the default parameter set uses
    bound = q//2 = 1757668526 for key generation); int64 draws above that
    (wide rings, modulus >= 2^32 -- requires jax x64, which the wide
    RingContext already enforces).
    """
    if not 0 < bound <= 2**62:
        raise ValueError(f"bound out of range: {bound}")
    if bound <= 2**31 - 2:
        return jax.random.randint(
            key, shape + (n,), minval=-bound, maxval=bound + 1, dtype=jnp.int32
        )
    return jax.random.randint(
        key, shape + (n,), minval=-bound, maxval=bound + 1, dtype=jnp.int64
    )


def gaussian_rounded(key, shape, n: int, sigma: float):
    """Iid N(0, sigma) coefficients truncated toward zero to int32.

    Matches the reference's ``Normal::sample`` + ``from_f64`` cast pipeline
    in distribution (Rust float->int casts truncate toward zero). sigma is
    ~2e4 for the default parameters, far inside exact f32 integer range.
    """
    g = jax.random.normal(key, shape + (n,), dtype=jnp.float32) * jnp.float32(sigma)
    return jnp.trunc(g).astype(jnp.int32)


def challenge(key, shape, n: int, kappa: int):
    """Sample from C = {c : ||c||_inf = 1, ||c||_1 = kappa}: kappa nonzero
    coefficients, each +-1 with fair coins, positions uniformly shuffled.

    Equivalent to the reference's "set first kappa to +-1 then Fisher-Yates"
    (/root/reference/src/challenge_space.rs:22-31). Batched via one
    argsort-of-uniforms permutation per leading index (a uniformly random
    permutation, as Fisher-Yates produces).
    """
    if kappa < 1:
        raise ValueError(f"kappa must be >= 1, got {kappa}")
    # For kappa > N the reference's `take(kappa)` clamps to N (all coeffs
    # +-1) -- its own integration tests run N=16 with kappa=36
    # (/root/reference/tests/test.rs:8). Replicate that semantics.
    kappa = min(kappa, n)
    signs, u = challenge_draws(key, shape, n)
    if kappa == n:
        return signs
    return jnp.where(_mask_topk(u, kappa), signs, jnp.zeros((), jnp.int32))


def _use_signkey() -> bool:
    """RINGZK_CHALLENGE_SIGNKEY=1 derives the challenge signs from the
    selection keys' low bit (one PRNG draw instead of two; changes the
    transcript stream -- goldens must be regenerated if this ever becomes
    the default). Read at trace time, like every RINGZK_* engine flag."""
    return os.environ.get("RINGZK_CHALLENGE_SIGNKEY", "0") == "1"


def challenge_draws(key, shape, n: int):
    """The challenge sampler's raw PRNG draws: (signs, selection keys).

    signs: iid +-1 int32 ``shape + (n,)``; u: iid uint32 selection keys of
    the same shape. The support is a uniform kappa-subset of lanes: the
    top-kappa of ``u`` under the stable order (key desc, lane asc) -- the
    same distribution as permuting by key order (Fisher-Yates analog), but
    top_k of kappa << N beats a full sort, and the threshold pair
    (kappa-th value, its lane) reconstructs the selected set exactly,
    including key-collision ties, via one lexicographic compare.

    Default: two independent draws (a rademacher plane + a uint32 key
    plane), matching the committed transcript goldens. With
    RINGZK_CHALLENGE_SIGNKEY=1, ONE uint32 draw supplies both: bit 0 is
    the sign (exactly fair, exactly independent of the other bits) and
    bits 1..31 are the selection key. The selection-key width drops from
    32 to 31 bits, doubling the already-negligible threshold-tie rate
    (~C(N,2)/2^31 per row, ~6e-5 at N=512; ties resolve by the same
    stable lane rule either way).

    Single source of truth for the key-split order and draw dtypes, shared
    by :func:`challenge` and its tests -- a refactor here changes both sides
    together.
    """
    if _use_signkey():
        u_full = jax.random.bits(key, shape + (n,), dtype=jnp.uint32)
        signs = 1 - 2 * (u_full & jnp.uint32(1)).astype(jnp.int32)
        return signs, u_full >> jnp.uint32(1)
    ksign, kperm = jax.random.split(key)
    # explicit float32 p: jax.random.rademacher routes through
    # bernoulli(p=0.5) whose draw dtype follows lax.dtype(p) -- a Python
    # float canonicalizes to float64 under jax x64, silently changing the
    # sign bitstream (and every committed transcript golden). Pinning p to
    # float32 reproduces the x32 rademacher bit-for-bit in BOTH modes
    # (tests/test_golden.py::test_transcript_digests_x64_invariant).
    bern = jax.random.bernoulli(ksign, jnp.float32(0.5), shape + (n,))
    signs = 2 * bern.astype(jnp.int32) - 1
    u = jax.random.bits(kperm, shape + (n,), dtype=jnp.uint32)
    return signs, u


def _mask_topk(u, kappa: int):
    """Top-kappa lane mask of iid uint32 keys via stable `lax.top_k`: the
    selected set is every lane ahead of the kappa-th under the order (key
    descending, lane ascending), ties at the threshold value included by
    ascending lane."""
    topv, topi = jax.lax.top_k(u, kappa)
    thr_v = topv[..., -1:]
    thr_i = topi[..., -1:]
    lane = jax.lax.broadcasted_iota(jnp.int32, u.shape, u.ndim - 1)
    return (u > thr_v) | ((u == thr_v) & (lane <= thr_i))


def challenge_difference(key, shape, n: int, kappa: int):
    """Sample from C-bar = {c - c' : c != c' in C} (invertible in R_q).

    Parity with /root/reference/src/challenge_space.rs:39-54. The resample
    loop on c == c' is omitted: for the parameter ranges used (N >= 16,
    kappa >= 2) a collision has probability < 2^-40; instead we flip one
    coefficient's sign deterministically on collision to guarantee c != c'.
    """
    k1, k2 = jax.random.split(key)
    c1 = challenge(k1, shape, n, kappa)
    c2 = challenge(k2, shape, n, kappa)
    eq = jnp.all(c1 == c2, axis=-1, keepdims=True)
    # on collision, negate c2 (still in C, and != c1 since kappa > 0)
    c2 = jnp.where(eq, -c2, c2)
    return c1 - c2
