"""Sequence-parallel RingContext: ring axis N sharded across an "sp" mesh axis.

Round 1 shipped the distributed butterfly network as a standalone
``polymul_sp`` demo (ntt_sp.py). This module turns it into a *capability*:
:class:`SpRing` is a drop-in :class:`~ringzk_tpu.ops.ntt.RingContext` whose
``fwd``/``inv`` run the per-prime negacyclic NTTs under ``shard_map`` with the
coefficient axis block-sharded over ``axis`` (log2(n_dev) pairwise ppermute
exchanges per transform, over the device interconnect), while every *pointwise* protocol op --
NTT-domain MACs, Garner CRT, centered mod-q adds, 96-bit norm accumulations,
samplers -- stays ordinary jnp code that XLA's SPMD partitioner shards
automatically (lane-axis reductions become psums).

Installed into the protocol layer with :func:`ringzk_tpu.ops.ntt.ring_override`
(see parallel/protocol_sp.py): the unmodified protocols/{commit,open,linear,
sum}.py then execute with N sharded -- matvec_key, scalar_mul_add, and the
norm checks all become sp-aware without a fork of the protocol code. This is
the SP/ring-attention analog for ring degrees whose working set exceeds one
chip (the reference's only scaling axis is the const generic N, single-
threaded O(N^2) -- /root/reference/src/params.rs:44-47, SURVEY.md section 5.7).

Composes with the dp proof-batch axis: pass ``batch_axis="dp"`` on a
("dp", "sp") mesh and the leading batch dim of every transform input stays
dp-sharded (ppermutes name only the sp axis, so exchanges stay inside each
dp group).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ntt as ntt_mod
from ..ops import zq
from ..ops.ntt import NUM_PRIMES, RingContext
from .ntt_sp import _fwd_local_block, _inv_local_block


def _spec(ndim: int, axis: str, batch_axis, batch_pos: int) -> P:
    """Spec for a rank-``ndim`` array: ring axis (last) on ``axis``; leading
    batch dim (at ``batch_pos``) on ``batch_axis`` when present."""
    dims = [None] * ndim
    dims[-1] = axis
    if batch_axis is not None and ndim > batch_pos + 1:
        dims[batch_pos] = batch_axis
    return P(*dims)


@functools.lru_cache(maxsize=None)
def _sp_fwd_fn(
    n: int, q: int, mesh: Mesh, axis: str, batch_axis, ndim: int, num: int,
    const: bool,
):
    """shard_map program: centered int32 [..., N] -> uint32 [num, ..., N]
    (plain form, or Montgomery/const form when ``const``)."""
    ring = ntt_mod._get_ring_cached(n, q)
    n_dev = mesh.shape[axis]
    in_specs = (_spec(ndim, axis, batch_axis, 0),) + (P(None, None, axis),) * num
    out_spec = _spec(ndim + 1, axis, batch_axis, 1)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_spec
    )
    def body(x_blk, *w_blks):
        outs = []
        for i in range(num):
            ctx = ring.mont[i]
            xi = ctx.reduce_i32_centered(x_blk)
            if const:
                # to-Montgomery commutes with the (linear) NTT
                xi = ctx.to_mont(xi)
            outs.append(_fwd_local_block(ctx, xi, w_blks[i], n, n_dev, axis))
        return jnp.stack(outs, 0)

    return body


@functools.lru_cache(maxsize=None)
def _sp_inv_fn(
    n: int, q: int, mesh: Mesh, axis: str, batch_axis, ndim: int, num: int
):
    """shard_map program: per-prime INTT + N^{-1} scaling of a plain-form
    [num, ..., N] stack (Garner CRT runs outside -- it is pointwise)."""
    ring = ntt_mod._get_ring_cached(n, q)
    n_dev = mesh.shape[axis]
    in_specs = (_spec(ndim, axis, batch_axis, 1),) + (P(None, None, axis),) * num
    out_spec = _spec(ndim, axis, batch_axis, 1)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_spec
    )
    def body(xhat_blk, *w_blks):
        ys = []
        for i in range(num):
            ctx = ring.mont[i]
            n_inv_scale = ring._tables[i][2]
            y = _inv_local_block(ctx, xhat_blk[i], w_blks[i], n, n_dev, axis)
            ys.append(
                ctx.shoup_mul(
                    jnp.uint32(n_inv_scale[0]), jnp.uint32(n_inv_scale[1]), y
                )
            )
        return jnp.stack(ys, 0)

    return body


@dataclasses.dataclass(frozen=True)
class SpRing(RingContext):
    """RingContext with the coefficient axis sharded over ``mesh[axis]``.

    batch_axis: optional mesh axis name sharding the *leading* dim of every
    transform input (the dp proof-batch axis). Inputs without a leading
    batch dim (rank-1 polynomials) are treated as replicated over it.
    """

    mesh: Mesh = None
    axis: str = "sp"
    batch_axis: str | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.mesh is None:
            raise ValueError("SpRing requires a mesh")
        if self.wide:
            raise ValueError(
                "SpRing does not support wide moduli (q >= 2^32): the "
                "sharded transform programs are int32-native; use the "
                "unsharded wide ring (large-N wide rings fit single-chip)"
            )
        n_dev = self.mesh.shape[self.axis]
        n_loc = self.n // n_dev
        if self.n % n_dev or n_loc & (n_loc - 1) or n_loc < 2:
            raise ValueError(
                f"N={self.n} over {n_dev} '{self.axis}' devices needs a "
                "power-of-two local block >= 2"
            )

    @functools.cached_property
    def _w_tables(self):
        """(w_fwd, w_inv) jnp table tuples per prime ([2, log2 N, N] each).

        Materialized under ensure_compile_time_eval: the first touch may
        happen while tracing a user's jit, and a cached_property must never
        memoize a tracer (a second jit over the same SpRing would then see
        a leaked tracer -- UnexpectedTracerError)."""
        with jax.ensure_compile_time_eval():
            fwd, inv = [], []
            for i in range(NUM_PRIMES):
                _, _, _, w_f, w_i = self._tables[i]
                fwd.append(jnp.asarray(w_f))
                inv.append(jnp.asarray(w_i))
            return tuple(fwd), tuple(inv)

    def fwd(self, x, num: int = NUM_PRIMES):
        x = jnp.asarray(x, jnp.int32)
        fn = _sp_fwd_fn(
            self.n, self.q, self.mesh, self.axis, self.batch_axis, x.ndim,
            num, False,
        )
        return fn(x, *self._w_tables[0][:num])

    def fwd_const(self, x, num: int = NUM_PRIMES):
        x = jnp.asarray(x, jnp.int32)
        fn = _sp_fwd_fn(
            self.n, self.q, self.mesh, self.axis, self.batch_axis, x.ndim,
            num, True,
        )
        return fn(x, *self._w_tables[0][:num])

    def inv(self, xhat):
        num = xhat.shape[0]
        fn = _sp_inv_fn(
            self.n, self.q, self.mesh, self.axis, self.batch_axis, xhat.ndim,
            num,
        )
        ys = fn(xhat, *self._w_tables[1][:num])
        return self._crt_to_centered([ys[i] for i in range(num)])

    def scalar_mul_add(self, d, m, t, num: int = NUM_PRIMES,
                       d_num: int | None = None):
        """Composed chain only (the fused GPU kernel is not used in sharded
        programs).

        ``d_num`` (the RingContext CSE hint, see RingContext.scalar_mul_add)
        is accepted for drop-in signature parity and ignored: the sharded
        transforms here are built per call and the hint's opt-in flag is a
        single-chip scheduling experiment (measured-and-rejected there)."""
        d = jnp.asarray(d, jnp.int32)
        m = jnp.asarray(m, jnp.int32)
        t = jnp.asarray(t, jnp.int32)
        nbatch = d.ndim - 1
        if m.shape[:nbatch] != d.shape[:-1]:
            raise ValueError(
                f"scalar_mul_add: d batch {d.shape[:-1]} does not prefix "
                f"m shape {m.shape}"
            )
        if t.shape != m.shape:
            raise ValueError(
                f"scalar_mul_add: t shape {t.shape} != m shape {m.shape}"
            )
        struct = m.shape[nbatch:-1]
        mf = m.reshape(d.shape[:-1] + (-1, m.shape[-1]))
        tf = t.reshape(mf.shape)
        d_hat = self.fwd_const(d, num)
        dm = self.inv(self.dot_hat(d_hat[..., None, :], self.fwd(mf, num)))
        out = zq.add_centered(self.qctx, tf, dm)
        return out.reshape(d.shape[:-1] + struct + (m.shape[-1],))
