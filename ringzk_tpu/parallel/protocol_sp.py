"""Full sigma protocols with the ring axis sharded over "sp" (x "dp" batch).

This is SURVEY.md section 5.7 as a *capability* rather than a demo: the
unmodified protocol layer (protocols/{commit,open,linear,sum}.py) runs with
ring degree N block-sharded across devices, because every protocol entry
point resolves its arithmetic through ``ops.ntt.get_ring`` and we install an
:class:`~ringzk_tpu.parallel.ring_sp.SpRing` override for the duration of
tracing. Everything the verifier does -- matvec_key against the (lane-
sharded) key hats, scalar_mul_add chains, exact 96-bit norm reductions
(partial sums per shard + XLA-inserted all-reduce), equality reduces, psum
batch-verify -- partitions over the ("dp", "sp") mesh in one jit program.

Usage mirrors parallel/mesh.py's dp-only wrappers:

    mesh = make_sp_mesh(dp=2, sp=4)
    ok, all_ok = open_roundtrip_sp(mesh, key, ck, x, params)

The commitment key is passed as a traced argument with its ring axes
lane-sharded; its digit operators (a layout that interleaves k and N)
are stripped -- the NTT matvec path is the sp-aware one.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ntt as ntt_mod
from ..params import Params
from ..protocols import linear as linear_mod
from ..protocols import open as open_mod
from ..protocols import sum as sum_mod
from ..protocols.commit import CommitmentKey
from .ring_sp import SpRing


def make_sp_mesh(dp: int, sp: int, devices=None) -> Mesh:
    """("dp", "sp") mesh: proof batch over dp, ring axis over sp."""
    devs = devices if devices is not None else jax.devices()
    if dp * sp > len(devs):
        raise ValueError(f"need {dp * sp} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[: dp * sp]).reshape(dp, sp), ("dp", "sp"))


def _lane_sharded_ck(mesh: Mesh, ck: CommitmentKey, sp_axis: str) -> CommitmentKey:
    """Strip digit operators; lane-shard key matrices and their NTT caches."""
    s3 = NamedSharding(mesh, P(None, None, sp_axis))
    s4 = NamedSharding(mesh, P(None, None, None, sp_axis))
    return CommitmentKey(
        a1=jax.device_put(ck.a1, s3),
        a2=jax.device_put(ck.a2, s3),
        a1_hat=jax.device_put(ck.a1_hat, s4),
        a2_hat=jax.device_put(ck.a2_hat, s4),
        a1_dig=None,
        a2_dig=None,
    )


@functools.lru_cache(maxsize=None)
def _sp_step_fn(
    roundtrip,
    n_data: int,
    data_ranks: tuple,
    mesh: Mesh,
    params: Params,
    n_deg: int,
    dp_axis: str,
    sp_axis: str,
):
    """One jitted ("dp", "sp")-sharded prove->...->verify program. Cached on
    everything static; traced under the SpRing override so the protocol
    layer's get_ring() resolves to the sharded transforms."""
    ring = SpRing(
        n=n_deg, q=params.modulus, mesh=mesh, axis=sp_axis, batch_axis=dp_axis
    )
    repl = NamedSharding(mesh, P())
    ck_spec = CommitmentKey(
        a1=NamedSharding(mesh, P(None, None, sp_axis)),
        a2=NamedSharding(mesh, P(None, None, sp_axis)),
        a1_hat=NamedSharding(mesh, P(None, None, None, sp_axis)),
        a2_hat=NamedSharding(mesh, P(None, None, None, sp_axis)),
        a1_dig=None,
        a2_dig=None,
    )
    data_spec = tuple(
        NamedSharding(mesh, P(dp_axis, *([None] * (r - 2)), sp_axis))
        for r in data_ranks
    )

    def fn(key, ck, *data):
        with ntt_mod.ring_override(ring), ntt_mod.xla_transforms():
            ok, op_ok = roundtrip(key, ck, *data, params)
        ok = ok & op_ok
        return ok, jnp.all(ok)

    return jax.jit(
        fn,
        in_shardings=(repl, ck_spec) + data_spec,
        out_shardings=(NamedSharding(mesh, P(dp_axis)), repl),
    )


def _run(roundtrip, mesh, key, ck, data, params, dp_axis, sp_axis):
    n_deg = data[-1].shape[-1]
    b = data[0].shape[0]
    if any(d.shape[0] != b for d in data):
        raise ValueError(f"batch axes disagree: {[d.shape[0] for d in data]}")
    if b % mesh.shape[dp_axis]:
        raise ValueError(f"batch {b} not divisible by dp={mesh.shape[dp_axis]}")
    ck = _lane_sharded_ck(mesh, ck, sp_axis)
    step = _sp_step_fn(
        roundtrip,
        len(data),
        tuple(d.ndim for d in data),
        mesh,
        params,
        n_deg,
        dp_axis,
        sp_axis,
    )
    return step(key, ck, *data)


def open_roundtrip_sp(
    mesh, key, ck, x, params: Params, dp_axis: str = "dp", sp_axis: str = "sp"
):
    """Open-proof round trip, x: [B, l, N], B over dp and N over sp.
    Returns (ok[B], all_ok) -- BASELINE config 5's psum batch-verify with
    the ring axis additionally sharded (config for very large N)."""
    return _run(open_mod.roundtrip, mesh, key, ck, (x,), params, dp_axis, sp_axis)


def linear_roundtrip_sp(
    mesh, key, ck, g, x, params: Params, dp_axis: str = "dp", sp_axis: str = "sp"
):
    """Linear-proof round trip: g [B, N], x [B, l, N], ring axis sp-sharded."""
    return _run(
        linear_mod.roundtrip, mesh, key, ck, (g, x), params, dp_axis, sp_axis
    )


def sum_roundtrip_sp(
    mesh, key, ck, gs, xs, params: Params, dp_axis: str = "dp", sp_axis: str = "sp"
):
    """Sum-proof round trip: gs [B, V, N], xs [B, V, l, N], ring axis
    sp-sharded."""
    return _run(
        sum_mod.roundtrip, mesh, key, ck, (gs, xs), params, dp_axis, sp_axis
    )
