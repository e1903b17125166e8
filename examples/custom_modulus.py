#!/usr/bin/env python
"""Custom parameter sets: the genericity envelope in user code.

The reference is generic over the coefficient type and the const modulus Q
(/root/reference/src/params.rs:18) but ships one instantiation
(ZqI64<3515337053>). Here the modulus is a runtime Params field: any odd
modulus < 2^63 (the reference's full ZqI64 domain) with any power-of-two
ring degree works, engine selection included -- small moduli keep the int8
MXU digit key path, moduli within ~16.8M of 2^32 exceed the 4-digit
capacity and transparently fall back to the exact CRT-NTT key path
(protocols/commit.py keygen gate), and moduli >= 2^32 run the wide int64
ring (requires jax x64; ops/mont64.py). Norm bounds,
challenge structure, and all three sigma protocols are modulus-agnostic.

Run: JAX_PLATFORMS=cpu python examples/custom_modulus.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

import ringzk_tpu as rz
from ringzk_tpu.protocols import open as open_mod

N = 64

CONFIGS = [
    ("reference default (q ~ 2^31.7)", rz.Params()),
    ("small 15-bit prime", rz.Params(q=32749 // 2, modulus=32749)),
    ("2^32 - 5 (Montgomery carry regime)",
     rz.Params(q=4294967291 // 2, modulus=4294967291)),
    ("wider key matrix, 2 msg rows", rz.Params(n=2, k=6, l=2)),
]

WIDE_CONFIGS = [
    ("WIDE 2^33 + 9 (int64 ring)", rz.Params(q=(2**33 + 9) // 2, modulus=2**33 + 9)),
    ("WIDE largest prime < 2^63",
     rz.Params(q=9223372036854775783 // 2, modulus=9223372036854775783)),
]


def run_config(name, params):
        params.validate()
        kk, kx, kp = jax.random.split(jax.random.PRNGKey(1), 3)
        ck = rz.keygen(kk, params, N)
        dtype = jnp.int64 if params.modulus >= 2**32 else jnp.int32
        x = jax.random.randint(
            kx, (16, params.l, N), -params.q, params.q + 1, dtype=dtype
        )
        ok, opening_ok = jax.jit(
            lambda k, xx: open_mod.roundtrip(k, ck, xx, params)
        )(kp, x)
        engine = "MXU int8 digits" if ck.a1_dig is not None else "CRT-NTT"
        print(
            f"{name:40s} modulus={params.modulus:>10d} "
            f"sigma={params.standard_deviation(N):>6d} key engine={engine:15s} "
            f"16/16 proofs ok={bool(ok.all() & opening_ok.all())}"
        )


def main():
    for name, params in CONFIGS:
        run_config(name, params)
    # wide rings need int64 arrays; scope x64 so the narrow configs above
    # ran exactly as a default (x32) process would
    with jax.enable_x64(True):
        for name, params in WIDE_CONFIGS:
            run_config(name, params)


if __name__ == "__main__":
    main()
