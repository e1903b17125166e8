"""Fused negacyclic NTT kernels for the GPU (Pallas, Triton route).

The XLA stage chain in ops/ntt.py expresses each of the log2(N) butterfly
stages as two rolls and a select, so XLA's fusion sends the stages through
device memory one after another. These kernels keep a block of polynomials
on chip for the whole transform: the forward kernel reads the centered
int32 block once and writes ``num`` uint32 CRT planes; the inverse kernel
reads the planes and writes centered int32, with the Garner CRT and the
mod-q fold inside. Narrow rings only (modulus < 2^32); wide rings take the
XLA chain.

Partner exchange without rolls or gathers, in constant geometry (Pease):
every forward stage pairs the two halves of the row ([TB, N] split in two
along the last axis) and writes the butterfly results interleaved (joined
along a new trailing axis); every inverse stage pairs neighbours and writes
the two halves. Storage order is then the logical order rotated by the
stage count, back in place after log2(N) stages, and every stage has the
same shapes, so the stages run as one loop with per-stage twiddle vectors
(the rotation is folded into the host-built tables). Each stage costs one
layout transpose.

The arithmetic is Harvey's lazy form of the chain's Shoup butterflies:
values stay in [0, 4p) between stages (4p < 2^32 for every base prime) and
are fully reduced once at the end, so the output is bit-identical to the
strict XLA chain (tests/test_ntt_kernel.py; chip_smoke.py on the card).

The Shoup quotient's high product is the ``mul.hi.u32`` instruction
through inline PTX in compiled kernels, and the 16-bit-limb emulation of
ops/u64.py in interpret mode (the CPU tests), which has no inline PTX.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import u64

# Elements of one [TB, N] block: TB = BLOCK_ELEMS // N rows. With 4 warps
# that is 32 values per thread for each live array, which keeps the
# butterfly's working set in registers; larger N takes more warps instead
# of fewer rows (one row is the least a block holds).
BLOCK_ELEMS = 4096
NUM_WARPS = 4


def block_rows(n: int) -> int:
    """Rows of one kernel block at ring degree ``n``."""
    return max(1, BLOCK_ELEMS // n)


def num_warps(n: int) -> int:
    """Warps per block: 4, or enough for 32 values a thread when one row
    alone exceeds BLOCK_ELEMS (capped at Triton's 32 warps)."""
    return min(32, max(NUM_WARPS, n // (BLOCK_ELEMS // NUM_WARPS)))


def _mul_hi(a, b, native: bool):
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    if not native:
        return u64.mul_hi(a, b)
    a, b = jnp.broadcast_arrays(a, b)
    # the asm result is declared int32: Triton's inline-asm results are
    # signless, and the bitcast gives them back the operands' uint32 type
    [hi] = pltriton.elementwise_inline_asm(
        "mul.hi.u32 $0, $1, $2;",
        args=[a, b],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.int32)],
    )
    return jax.lax.bitcast_convert_type(hi, jnp.uint32)


def _lazy_shoup(p: int, w, w_shoup, x, native: bool):
    """w*x mod p in [0, 2p) for any uint32 x (no final conditional subtract)."""
    return w * x - _mul_hi(w_shoup, x, native) * np.uint32(p)


def _csub(x, m: int):
    """x - m where x >= m (uint32, static m)."""
    mm = np.uint32(m)
    return x - jnp.where(x >= mm, mm, np.uint32(0))


def _split_pairs(x):
    """[TB, N] -> the even and odd entries of every row, [TB, N/2] x2."""
    tb, n = x.shape
    lo, hi = jnp.split(x.reshape(tb, n // 2, 2), 2, axis=-1)
    return lo.reshape(tb, n // 2), hi.reshape(tb, n // 2)


def _interleave(a, b):
    """Inverse of :func:`_split_pairs`: a at even, b at odd positions."""
    tb, h = a.shape
    return jnp.concatenate([a[..., None], b[..., None]], axis=-1).reshape(
        tb, 2 * h)


def _concat_halves(a, b):
    """[a | b] along every row (the inverse of splitting a row in two)."""
    tb, h = a.shape
    pair = jnp.concatenate([a[..., None], b[..., None]], axis=-1)
    return jnp.transpose(pair, (0, 2, 1)).reshape(tb, 2 * h)


def _stage_twiddles(w_ref, prime: int, stage):
    """Stage ``stage``'s per-pair twiddles (plain, Shoup), [1, N/2] each."""
    w = w_ref[prime, 0, stage]
    ws = w_ref[prime, 1, stage]
    return w[None, :], ws[None, :]


def _fwd_stages(p: int, n: int, x, w_ref, prime: int, native: bool):
    """Cooley-Tukey stages in constant geometry: every stage pairs the two
    halves of the row and writes the results interleaved, so storage order
    is the logical order rotated right by the stage count and returns to
    it after log2(N) stages (natural in, bit-reversed out). Lazy form:
    x in [0, 2p) -> fully reduced [0, p)."""
    two_p = np.uint32(2 * p)

    def stage(s, x):
        x = _csub(x, 2 * p)                            # [0, 4p) -> [0, 2p)
        lo, hi = jnp.split(x, 2, axis=-1)
        w, ws = _stage_twiddles(w_ref, prime, s)
        prod = _lazy_shoup(p, w, ws, hi, native)       # [0, 2p)
        return _interleave(lo + prod, lo + two_p - prod)   # [0, 4p)

    x = jax.lax.fori_loop(0, n.bit_length() - 1, stage, x)
    return _csub(_csub(x, 2 * p), p)


def _inv_stages(p: int, n: int, n_inv_scale, x, w_ref, prime: int,
                native: bool):
    """Gentleman-Sande stages in constant geometry (each stage pairs
    neighbours and writes the two halves of the row; bit-reversed in,
    natural out) and the N^-1 scaling. Lazy form: x in [0, 2p) -> fully
    reduced [0, p)."""
    two_p = np.uint32(2 * p)

    def stage(s, x):
        x = _csub(x, 2 * p)
        lo, hi = _split_pairs(x)
        w, ws = _stage_twiddles(w_ref, prime, s)
        return _concat_halves(
            lo + hi, _lazy_shoup(p, w, ws, lo + two_p - hi, native))

    x = jax.lax.fori_loop(0, n.bit_length() - 1, stage, x)
    x = _csub(x, 2 * p)
    scale, scale_shoup = (np.uint32(v) for v in n_inv_scale)
    return _csub(_lazy_shoup(p, scale, scale_shoup, x, native), p)


def _fwd_kernel(ring, num: int, native: bool, x_ref, w_ref, o_ref):
    x = x_ref[...]
    for i in range(num):
        ctx = ring.mont[i]
        o_ref[i] = _fwd_stages(
            ctx.p, ring.n, ctx.reduce_i32_centered(x), w_ref, i, native
        )


def _inv_kernel(ring, num: int, native: bool, x_ref, w_ref, o_ref):
    ys = [
        _inv_stages(ring.primes[i], ring.n, ring._tables[i][2], x_ref[i],
                    w_ref, i, native)
        for i in range(num)
    ]
    o_ref[...] = ring._crt_to_centered(ys)


def _rot(i, k: int, bits: int):
    """Rotate the low ``bits`` bits of the integers ``i`` left by ``k``."""
    k %= bits
    mask = (1 << bits) - 1
    return ((i << k) | (i >> (bits - k))) & mask


@functools.lru_cache(maxsize=None)
def _twiddle_table(ring, num: int, inverse: bool) -> np.ndarray:
    """[num, 2, log2 N, N/2] uint32: per prime and stage the twiddle of each
    constant-geometry butterfly (pair i of the stage) and its Shoup
    companion floor(w * 2^32 / p).

    Forward stage s reads storage (i, i + N/2), whose logical index is
    rotr(i, s): the lo element of group rotr(i, s) >> (bits - s), twiddle
    psi_rev[2^s + group]. Inverse stage s reads storage (2i, 2i + 1),
    logical rotl(2i, s): group rotl(2i, s) >> (s + 1) of N / 2^(s+1),
    twiddle psi_inv_rev[N / 2^(s+1) + group]."""
    n = ring.n
    bits = n.bit_length() - 1
    pairs = np.arange(n // 2)
    out = np.empty((num, 2, bits, n // 2), np.uint32)
    for i in range(num):
        p = ring.primes[i]
        table = ring._tables[i][1 if inverse else 0]
        for s in range(bits):
            if inverse:
                idx = (n >> (s + 1)) + (_rot(2 * pairs, s, bits) >> (s + 1))
            else:
                idx = (1 << s) + (_rot(pairs, bits - s, bits) >> (bits - s))
            out[i, 0, s] = table[idx]
        out[i, 1] = ((out[i, 0].astype(object) << 32) // p).astype(np.uint32)
    return out


def _pad_rows(x2d, axis: int, rows: int, tb: int):
    pad = (-rows) % tb
    if not pad:
        return x2d
    widths = [(0, 0)] * x2d.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x2d, widths)


def _call(kernel, x, w, in_block, out_block, out_shape, grid, n, interpret):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            in_block,
            pl.BlockSpec(w.shape, lambda i: (0, 0, 0, 0)),
        ],
        out_specs=out_block,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps(n)),
        interpret=interpret,
        name="ntt_kernel",
    )(x, jnp.asarray(w))


def fwd(ring, x, num: int, *, interpret: bool = False):
    """Centered int32 [..., N] -> plain NTT domain uint32 [num, ..., N]."""
    n = ring.n
    lead = x.shape[:-1]
    x2d = jnp.asarray(x, jnp.int32).reshape(-1, n)
    rows = x2d.shape[0]
    tb = block_rows(n)
    x2d = _pad_rows(x2d, 0, rows, tb)
    padded = x2d.shape[0]
    out = _call(
        functools.partial(_fwd_kernel, ring, num, not interpret),
        x2d,
        _twiddle_table(ring, num, False),
        pl.BlockSpec((tb, n), lambda i: (i, 0)),
        pl.BlockSpec((num, tb, n), lambda i: (0, i, 0)),
        jax.ShapeDtypeStruct((num, padded, n), jnp.uint32),
        (padded // tb,),
        n,
        interpret,
    )
    return out[:, :rows].reshape((num,) + lead + (n,))


def inv(ring, xhat, *, interpret: bool = False):
    """Plain NTT domain uint32 [num, ..., N] -> centered int32 [..., N]:
    the inverse transforms, Garner CRT and mod-q fold in one kernel."""
    n = ring.n
    num = xhat.shape[0]
    lead = xhat.shape[1:-1]
    x3d = xhat.reshape(num, -1, n)
    rows = x3d.shape[1]
    tb = block_rows(n)
    x3d = _pad_rows(x3d, 1, rows, tb)
    padded = x3d.shape[1]
    out = _call(
        functools.partial(_inv_kernel, ring, num, not interpret),
        x3d,
        _twiddle_table(ring, num, True),
        pl.BlockSpec((num, tb, n), lambda i: (0, i, 0)),
        pl.BlockSpec((tb, n), lambda i: (i, 0)),
        jax.ShapeDtypeStruct((padded, n), jnp.int32),
        (padded // tb,),
        n,
        interpret,
    )
    return out[:rows].reshape(lead + (n,))
