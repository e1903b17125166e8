#!/usr/bin/env python
"""Regenerate tests/golden/mock_vectors.json: interchange vectors in EXACTLY
the schema scripts/rust_vector_gen emits (same keys per protocol, params
without "modulus", integer "seed", linear z/zp null, one n!=l family), but
produced by our own pipeline. tests/test_interop.py validates the vector
checkers against this file on every run, locking the schema on the Python
side so drift is caught here rather than on the one cargo machine that can
run the Rust generator. Runs on the CPU:

    python scripts/make_mock_vectors.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"  # the vectors are made on the CPU

import numpy as np

import jax
import jax.numpy as jnp

import ringzk_tpu as rz
from ringzk_tpu.protocols import linear as linear_mod
from ringzk_tpu.protocols import open as open_mod
from ringzk_tpu.protocols import sum as sum_mod

OUT = os.path.join(
    os.path.dirname(__file__), "..", "tests", "golden", "mock_vectors.json"
)

tol = lambda a: np.asarray(a).tolist()


def _params_json(params):
    # the Rust generator's Params object: no "modulus" key (the checker
    # derives it as 2*q + 1, /root/reference/src/params.rs:121-127)
    return {
        "q": params.q, "b": params.b, "n": params.n, "k": params.k,
        "l": params.l, "kappa": params.kappa,
    }


def _fixed_x(params, n, coeffs=(1, 2, 3, 4)):
    dt = np.int64 if params.modulus >= 2**32 else np.int32
    x = np.zeros((params.l, n), dt)
    x[:, : len(coeffs)] = coeffs
    return jnp.asarray(x)


def mock_open(seed, n=16, params=None):
    params = params or rz.Params()
    kk, kp, kc = jax.random.split(jax.random.PRNGKey(seed), 3)
    ck = rz.keygen(kk, params, n)
    x = _fixed_x(params, n)
    rctx, pcom = open_mod.prover_commit(kp, ck, x, params)
    vctx, chal = open_mod.generate_challenge(kc, pcom, params)
    resp = open_mod.create_response(rctx, chal, params)
    return {
        "n": n,
        "seed": seed,
        "params": _params_json(params),
        "ck": {"a1": tol(ck.a1), "a2": tol(ck.a2)},
        "x": tol(x),
        "r": tol(rctx.opening.r),
        "y": tol(rctx.y),
        "d": tol(chal.d),
        "c": tol(pcom.c.c),
        "t": tol(pcom.t),
        "z": tol(resp.z),
    }


def mock_linear(seed, n=16):
    params = rz.Params()
    kk, kp, kc = jax.random.split(jax.random.PRNGKey(seed), 3)
    ck = rz.keygen(kk, params, n)
    x = _fixed_x(params, n, (1, 2, 3))
    g = jnp.zeros((n,), jnp.int32).at[0].set(5).at[1].set(7)
    rctx, pcom = linear_mod.prover_commit(kp, ck, g, x, params)
    vctx, chal = linear_mod.generate_challenge(kc, pcom, params)
    # z/zp are null on the wire: LinearProofResponse derives no serde in the
    # reference (/root/reference/src/prove/linear.rs:318-325)
    return {
        "protocol": "linear",
        "n": n,
        "seed": seed,
        "params": _params_json(params),
        "ck": {"a1": tol(ck.a1), "a2": tol(ck.a2)},
        "g": tol(g),
        "x": tol(x),
        "r": tol(rctx.opening.r),
        "rp": tol(rctx.opening_p.r),
        "y": tol(rctx.y),
        "yp": tol(rctx.yp),
        "d": tol(chal.d),
        "c": tol(pcom.c.c),
        "cp": tol(pcom.cp.c),
        "t": tol(pcom.t),
        "tp": tol(pcom.tp),
        "u": tol(pcom.u),
        "z": None,
        "zp": None,
    }


def mock_sum(seed, n=16, vl=3):
    params = rz.Params()
    kk, kp, kc = jax.random.split(jax.random.PRNGKey(seed), 3)
    ck = rz.keygen(kk, params, n)
    xs = jnp.stack([_fixed_x(params, n, (i + 1,)) for i in range(vl)])
    gs = jnp.zeros((vl, n), jnp.int32).at[jnp.arange(vl), 0].set(
        2 * jnp.arange(vl) + 1
    )
    rctx, pcom = sum_mod.prover_commit(kp, ck, gs, xs, params)
    vctx, chal = sum_mod.generate_challenge(kc, pcom, params)
    resp = sum_mod.create_response(rctx, chal, params)
    return {
        "protocol": "sum",
        "n": n,
        "seed": seed,
        "params": _params_json(params),
        "ck": {"a1": tol(ck.a1), "a2": tol(ck.a2)},
        "gs": tol(gs),
        "xs": tol(xs),
        "rs": tol(rctx.openings.r),
        "rp": tol(rctx.opening_p.r),
        "ys": tol(rctx.ys),
        "yp": tol(rctx.yp),
        "d": tol(chal.d),
        "cs": tol(pcom.cs.c),
        "cp": tol(pcom.cp.c),
        "ts": tol(pcom.ts),
        "tp": tol(pcom.tp),
        "u": tol(pcom.u),
        "zs": tol(resp.zs),
        "zp": tol(resp.zp),
    }


def main():
    # wide-ring family: Q past 2^32 (the q the generator's QW const uses);
    # the wire schema stays modulus-free (derived 2q+1 = Q for odd Q)
    qw = 2**33 + 9
    with jax.enable_x64(True):
        wide_vec = mock_open(
            400, params=rz.Params(q=qw // 2, modulus=qw)
        )
    vectors = [
        mock_open(0),
        mock_linear(100),
        mock_sum(200),
        # n != l: the divergence family (reference's verifier panics on it)
        mock_open(300, params=rz.Params(n=2, k=5, l=1)),
        wide_vec,
        # k > 16: the accumulation envelope past the old ACC_MAX ceiling
        mock_open(500, params=rz.Params(k=20)),
    ]
    with open(os.path.abspath(OUT), "w") as f:
        json.dump(vectors, f)
    print("wrote", os.path.abspath(OUT))


if __name__ == "__main__":
    main()
