"""Multi-device sharding of proof batches over a jax mesh.

The reference is single-threaded CPU (SURVEY.md section 2.2); this module
*introduces* the distributed story:

  * data parallelism: the proof batch axis shards over the mesh "dp" axis
    (across the cards of a host, and across hosts) -- thousands of independent
    sigma-protocol round trips run as one pjit program;
  * tensor parallelism: the CRT prime axis (P=3 independent NTT residue
    channels, the leading axis of every NTT-domain array) shards over a
    "tp" axis -- per-prime NTTs are embarrassingly parallel and only the
    final Garner reconstruction gathers the three residues
    (implemented in parallel/ntt_tp.py; the ring-degree "sp" axis lives in
    parallel/ring_sp.py + protocol_sp.py);
  * batch-verify reduction: verifier accept bits are AND-reduced with a psum
    over the mesh, the collective analog of the reference's per-proof bool.

Shardings are expressed with NamedSharding/PartitionSpec; XLA inserts the
collectives (all-gather for the CRT gather, psum for the verdict reduce).
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.ntt import xla_transforms
from ..params import Params
from ..protocols import linear as linear_mod
from ..protocols import open as open_mod
from ..protocols import sum as sum_mod
from ..protocols.commit import CommitmentKey


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D device mesh over the proof-batch axis."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]).reshape(n_devices), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Place a pytree of batch-leading arrays with the batch axis sharded."""

    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. the commitment key) across the mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )


def batched_open_prove_verify(
    mesh: Mesh,
    key,
    ck: CommitmentKey,
    x,
    params: Params,
    axis: str = "dp",
):
    """Full open-proof round trip for a sharded batch x: [B, l, N].

    Returns (ok: bool[B] sharded, all_ok: bool scalar replicated). The
    all-reduce of the accept bits is the psum batch-verify of
    BASELINE.json config 5.
    """
    _check_batch(mesh, x.shape[0])
    x = shard_batch(mesh, x, axis)
    return open_step_fn(mesh, ck, params, axis)(key, x)


@functools.lru_cache(maxsize=None)
def _step_fn(roundtrip, n_data: int, mesh: Mesh, params: Params, axis: str):
    """One jitted sharded program running a complete prove->challenge->
    respond->verify pipeline over a batch (the 'training step' analog).

    Every `roundtrip` is natively batch-parallel (leading axes everywhere),
    so no vmap is needed: the batch axes of the n_data proof inputs are
    sharded, the RNG key and ck are replicated, and XLA partitions the whole
    pipeline; the final jnp.all is the cross-device psum(AND) reduction.
    The transforms trace as the XLA stage chain (ops.ntt.xla_transforms),
    which GSPMD partitions like any elementwise program.

    Cached on (roundtrip, mesh, params, axis) with the commitment key as a
    traced argument, so repeated batches -- and repeated calls to the
    batched_* wrappers -- reuse one jitted program per mesh/params instead
    of recompiling per call.
    """

    repl = NamedSharding(mesh, P())
    data_spec = tuple(NamedSharding(mesh, P(axis)) for _ in range(n_data))

    @partial(
        jax.jit,
        in_shardings=(repl, repl) + data_spec,
        out_shardings=(NamedSharding(mesh, P(axis)), repl),
    )
    def step(key, ck, *data):
        with xla_transforms():
            ok, op_ok = roundtrip(key, ck, *data, params)
        ok = ok & op_ok
        return ok, jnp.all(ok)

    return step


def _bind_ck(step, mesh, ck):
    ck_repl = replicate(mesh, ck)
    return lambda key, *data: step(key, ck_repl, *data)


def open_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, axis: str = "dp"):
    """Sharded open-proof step: (key, x[B, l, N]) -> (ok[B], all_ok)."""
    return _bind_ck(_step_fn(open_mod.roundtrip, 1, mesh, params, axis), mesh, ck)


def linear_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, axis: str = "dp"):
    """Sharded linear-proof step: (key, g[B, N], x[B, l, N]) -> (ok[B], all_ok)."""
    return _bind_ck(_step_fn(linear_mod.roundtrip, 2, mesh, params, axis), mesh, ck)


def sum_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, axis: str = "dp"):
    """Sharded sum-proof step: (key, gs[B, V, N], xs[B, V, l, N]) -> (ok[B], all_ok)."""
    return _bind_ck(_step_fn(sum_mod.roundtrip, 2, mesh, params, axis), mesh, ck)


def batched_linear_prove_verify(mesh, key, ck, g, x, params, axis="dp"):
    """Full linear-proof round trip (x' = g*x) for a dp-sharded batch.

    g: [B, N] scalar polynomials, x: [B, l, N]. Returns (ok[B], all_ok)."""
    _check_batch(mesh, g.shape[0], x.shape[0])
    g, x = shard_batch(mesh, (g, x), axis)
    return linear_step_fn(mesh, ck, params, axis)(key, g, x)


def batched_sum_prove_verify(mesh, key, ck, gs, xs, params, axis="dp"):
    """Full sum-proof round trip (x' = sum_i g_i*x_i) for a dp-sharded batch.

    gs: [B, V, N], xs: [B, V, l, N]. Returns (ok[B], all_ok)."""
    _check_batch(mesh, gs.shape[0], xs.shape[0])
    gs, xs = shard_batch(mesh, (gs, xs), axis)
    return sum_step_fn(mesh, ck, params, axis)(key, gs, xs)


def _check_batch(mesh: Mesh, *batch_sizes: int):
    """All data inputs must share one leading batch axis, divisible by the
    device count (otherwise the jit raises an opaque XLA shape error)."""
    if len(set(batch_sizes)) > 1:
        raise ValueError(f"batch axes disagree across inputs: {batch_sizes}")
    nd = mesh.devices.size
    if batch_sizes[0] % nd:
        raise ValueError(f"batch {batch_sizes[0]} not divisible by {nd} devices")
