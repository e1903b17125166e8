"""Sequence-parallel negacyclic NTT: ring axis N sharded across devices.

The DP analog (parallel/mesh.py) scales proof *batches*; this module scales
*ring degree* -- the reference's only scaling axis is the const generic N,
handled single-threaded with O(N^2) schoolbook multiplication (SURVEY.md
section 5.7). Here the coefficient axis is block-sharded over an "sp" mesh
axis and the roll-based butterfly network splits into:

  * cross-device stages (partner distance t >= N_local): lane i's partner
    i ^ t lives on device (dev ^ (t / N_local)) at the SAME local offset, so
    the exchange is one pairwise jax.lax.ppermute of the whole local block
    per stage -- log2(n_dev) exchanges total, over the device interconnect;
  * local stages (t < N_local): identical to the single-device kernel on
    the local block (static rolls + selects).

Twiddle planes are sharded with the coefficients. The same split works for
the inverse transform with the stage order reversed (local stages first).

This is the SP/ring-attention analog for lattice ZK: it makes ring degrees
whose coefficient vectors exceed one chip's VMEM/HBM practical, and it
composes with the dp axis (mesh ("dp", "sp")) under one shard_map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.montgomery import MontCtx
from ..ops import ntt as ntt_mod


def _local_stage(ctx: MontCtx, x, w_plane, t: int, lane0: int, fwd: bool):
    """One butterfly stage on a local block; t < N_local. lane0 is the
    global offset of this block (for the is_lo parity). w_plane is the
    (plain, shoup) twiddle pair [2, N_local]."""
    n_loc = x.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (n_loc,), 0) + jnp.uint32(lane0)
    is_lo = (lane & jnp.uint32(t)) == 0
    xs = jnp.where(is_lo, jnp.roll(x, -t, axis=-1), jnp.roll(x, t, axis=-1))
    if fwd:
        prod = ctx.shoup_mul(w_plane[0], w_plane[1], jnp.where(is_lo, xs, x))
        return jnp.where(is_lo, ctx.add(x, prod), ctx.sub(xs, prod))
    return jnp.where(
        is_lo, ctx.add(x, xs), ctx.shoup_mul(w_plane[0], w_plane[1], ctx.sub(xs, x))
    )


def _cross_stage(ctx: MontCtx, x, w_plane, hop: int, axis: str, is_lo, fwd: bool):
    """One butterfly stage whose partner block is `hop` devices away: a
    single pairwise ppermute (dev ^ hop is an involution)."""
    n_dev = jax.lax.axis_size(axis)
    perm = [(d, d ^ hop) for d in range(n_dev)]
    xs = jax.lax.ppermute(x, axis, perm)
    if fwd:
        prod = ctx.shoup_mul(w_plane[0], w_plane[1], jnp.where(is_lo, xs, x))
        return jnp.where(is_lo, ctx.add(x, prod), ctx.sub(xs, prod))
    return jnp.where(
        is_lo, ctx.add(x, xs), ctx.shoup_mul(w_plane[0], w_plane[1], ctx.sub(xs, x))
    )


def _fwd_local_block(ctx, x, w_fwd_local, n: int, n_dev: int, axis: str):
    """Forward NTT body under shard_map: x [..., N_local] on each device."""
    n_loc = n // n_dev
    logn = n.bit_length() - 1
    dev = jax.lax.axis_index(axis)
    lane0 = dev * n_loc
    for s in range(logn):
        t = n >> (s + 1)
        w_plane = w_fwd_local[:, s]
        if t >= n_loc:
            hop = t // n_loc
            is_lo = (dev & hop) == 0
            x = _cross_stage(ctx, x, w_plane, hop, axis, is_lo, fwd=True)
        else:
            x = _local_stage(ctx, x, w_plane, t, lane0, fwd=True)
    return x


def _inv_local_block(ctx, x, w_inv_local, n: int, n_dev: int, axis: str):
    n_loc = n // n_dev
    logn = n.bit_length() - 1
    dev = jax.lax.axis_index(axis)
    lane0 = dev * n_loc
    for s in range(logn):
        t = 1 << s
        w_plane = w_inv_local[:, s]
        if t >= n_loc:
            hop = t // n_loc
            is_lo = (dev & hop) == 0
            x = _cross_stage(ctx, x, w_plane, hop, axis, is_lo, fwd=False)
        else:
            x = _local_stage(ctx, x, w_plane, t, lane0, fwd=False)
    return x


@functools.lru_cache(maxsize=None)
def _polymul_sp_fn(
    mesh: Mesh, n: int, q: int, axis: str, ndim: int, batch_axis: str | None
):
    """Build (once per mesh/N/q/ndim) the jitted shard_map program.

    Jitting here is essential: an un-jitted shard_map runs its body
    eagerly, dispatching every butterfly op across the mesh one at a time
    -- minutes of pure tracing overhead per call at large N.

    batch_axis: optional second mesh axis sharding the LEADING dim (dp x sp
    composition: independent polynomial batches split over "dp" while each
    ring is split over "sp"; the ppermute exchanges stay within each dp
    group because they name only the sp axis)."""
    ring = ntt_mod.get_ring(n, q)
    n_dev = mesh.shape[axis]

    lead = [batch_axis] + [None] * (ndim - 2) if batch_axis else [None] * (ndim - 1)
    spec_last = P(*(lead + [axis]))
    w_specs = P(None, None, axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec_last, spec_last) + (w_specs,) * 2 * ntt_mod.NUM_PRIMES,
        out_specs=spec_last,
    )
    def body(a_blk, b_blk, *tables):
        outs = []
        for i in range(ntt_mod.NUM_PRIMES):
            ctx = ring.mont[i]
            w_fwd, w_inv = tables[2 * i], tables[2 * i + 1]
            n_inv_scale = ring._tables[i][2]
            ah = _fwd_local_block(
                ctx, ctx.to_mont(ctx.reduce_i32_centered(a_blk)), w_fwd, n, n_dev, axis
            )
            bh = _fwd_local_block(
                ctx, ctx.reduce_i32_centered(b_blk), w_fwd, n, n_dev, axis
            )
            prod = ctx.mont_mul(ah, bh)
            y = _inv_local_block(ctx, prod, w_inv, n, n_dev, axis)
            y = ctx.shoup_mul(
                jnp.uint32(n_inv_scale[0]), jnp.uint32(n_inv_scale[1]), y
            )
            outs.append(y)
        return ring._crt_to_centered(outs)

    return jax.jit(body)


def polymul_sp(
    mesh: Mesh,
    a,
    b,
    n: int,
    q: int,
    axis: str = "sp",
    batch_axis: str | None = None,
):
    """Exact negacyclic product with the coefficient axis sharded over
    ``axis``. a (const operand) and b: [..., N] centered int32, N sharded.

    Demonstration/path for very large N; per-prime NTTs run under one
    shard_map with log2(n_dev) ppermute exchanges per transform. Pass
    ``batch_axis`` (e.g. "dp" on a ("dp", "sp") mesh) to additionally shard
    the leading batch dim -- the dp x sp composition.
    """
    ring = ntt_mod.get_ring(n, q)
    n_dev = mesh.shape[axis]
    if n % n_dev or (n // n_dev) & (n // n_dev - 1):
        raise ValueError("N / n_dev must be a power of two")
    if batch_axis and a.ndim < 2:
        raise ValueError("batch_axis requires a leading batch dim")

    tables = []
    for i in range(ntt_mod.NUM_PRIMES):
        _, _, _, w_fwd, w_inv = ring._tables[i]
        tables += [jnp.asarray(w_fwd), jnp.asarray(w_inv)]
    return _polymul_sp_fn(mesh, n, q, axis, a.ndim, batch_axis)(a, b, *tables)
