"""Challenge support selection (ops/sampling.py) against a plain numpy
reference: the support is the first kappa lanes under the stable order
(key descending, lane ascending), threshold ties included by lane."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import env_override
from ringzk_tpu.ops import sampling


def _ref_mask(u, kappa):
    u = np.asarray(u, np.int64)
    mask = np.zeros(u.shape, bool)
    flat_u = u.reshape(-1, u.shape[-1])
    flat_m = mask.reshape(-1, u.shape[-1])
    lanes = np.arange(u.shape[-1])
    for row, m in zip(flat_u, flat_m):
        order = np.lexsort((lanes, -row))  # key desc, then lane asc
        m[order[:kappa]] = True
    return mask


def _ref_challenge(u, signs, kappa):
    return np.where(_ref_mask(u, kappa), np.asarray(signs), 0)


@pytest.mark.parametrize(
    "n,kappa", [(128, 36), (512, 36), (512, 60), (256, 1), (512, 511)]
)
def test_mask_topk_matches_numpy(rng, n, kappa):
    u = jnp.asarray(rng.integers(0, 2**32, size=(37, n), dtype=np.uint64),
                    jnp.uint32)
    got = np.asarray(sampling._mask_topk(u, kappa))
    np.testing.assert_array_equal(got, _ref_mask(u, kappa))
    assert (got.sum(-1) == kappa).all()


def test_mask_topk_tie_breaking(rng):
    """Keys from a tiny alphabet: many duplicates straddle the kappa-th
    value, and exactly kappa lanes are taken, lowest lanes first."""
    n, kappa = 128, 7
    u = jnp.asarray(rng.integers(0, 5, size=(64, n)), jnp.uint32)
    got = np.asarray(sampling._mask_topk(u, kappa))
    np.testing.assert_array_equal(got, _ref_mask(u, kappa))
    assert (got.sum(-1) == kappa).all()


def test_challenge_matches_numpy():
    """sampling.challenge == the numpy selection over its own draws
    (multi-dim batch), with kappa +-1 entries per row."""
    key = jax.random.PRNGKey(7)
    got = np.asarray(sampling.challenge(key, (3, 5), 512, 36))
    signs, u = sampling.challenge_draws(key, (3, 5), 512)
    np.testing.assert_array_equal(got, _ref_challenge(u, signs, 36))
    assert (np.abs(got).sum(-1) == 36).all()
    assert set(np.unique(got)) <= {-1, 0, 1}


def test_challenge_signkey_mode_matches_numpy():
    """The one-draw sign-key variant (31-bit keys, more threshold ties)
    selects by the same rule."""
    key = jax.random.PRNGKey(9)
    with env_override("RINGZK_CHALLENGE_SIGNKEY", "1"):
        got = np.asarray(sampling.challenge(key, (4, 3), 512, 36))
        signs, u = sampling.challenge_draws(key, (4, 3), 512)
    np.testing.assert_array_equal(got, _ref_challenge(u, signs, 36))
    assert (np.abs(got).sum(-1) == 36).all()
