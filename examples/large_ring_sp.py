#!/usr/bin/env python
"""Open proofs at a ring degree too large for one device's working set.

Demonstrates the sp (sequence-parallel) capability: a full open-proof
round trip at N=8192 with every coefficient vector block-sharded over the
"sp" mesh axis while the proof batch shards over "dp" -- the unmodified
protocol code runs under the SpRing override (parallel/protocol_sp.py),
with the distributed-butterfly NTT exchanging blocks via ppermute and the
exact 96-bit norm checks reducing across shards.

Run (8-device virtual CPU mesh):
  env JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/large_ring_sp.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

import ringzk_tpu as rz
from ringzk_tpu.parallel import protocol_sp


def main():
    params = rz.Params()
    n_deg = 8192
    batch = 8

    mesh = protocol_sp.make_sp_mesh(dp=2, sp=4)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}, N={n_deg}")

    kk, kx, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    ck = rz.keygen(kk, params, n_deg)
    x = jax.random.randint(
        kx, (batch, params.l, n_deg), -params.q, params.q + 1, dtype=jnp.int32
    )

    ok, all_ok = protocol_sp.open_roundtrip_sp(mesh, kp, ck, x, params)
    print(f"verified {batch} proofs at N={n_deg}: all_ok={bool(all_ok)}")
    assert bool(all_ok)


if __name__ == "__main__":
    main()
