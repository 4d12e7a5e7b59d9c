"""Fused windowed tile-pair SpMM kernel — Pallas through Triton.

``WindowedPairs`` stores the matrix as a block-sorted list of dense
``(R, C)`` tiles; row block ``b`` owns the pair run
``block_ptr[b]:block_ptr[b+1]``. The kernel runs one program per
``(row block, row sub-block)``: it walks its block's pair run, loads
each ``(BR, BC)`` tile slice and the matching ``(BC, k)`` slice of the
fat vector, and accumulates the products in an f32 register tile. Each
output sub-block is written once; nothing carries between programs and
there are no atomics.

Against ``ops/windowed.py::spmm_windowed_xla`` (slab gather, batched
einsum, segment-sum) the kernel never materialises the gathered slabs
or the per-pair products in device memory: every tile is read once and
the fat-vector slabs are re-read from L2.

Shapes: Triton wants power-of-two blocks and ``pl.dot`` wants every
dimension of its right operand >= 16, so the wrapper pads ``k`` to the
next power of two >= 16 and the dispatchers route other tile shapes,
and f64 data, to the XLA path (:func:`kernel_supports`).

Replaces the reference row-wise hot loop
(``SparseMatrixFatVectorMultiplyRowWise.cpp:36-50``) at tile
granularity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["windowed_matmul_pallas", "spmm_windowed_pallas",
           "kernel_supports", "padded_width", "F32_PRECISION"]

#: Output rows and contraction columns one program holds at a time.
ROW_TILE = 64
COL_TILE = 64
#: ``pl.dot`` (Triton ``tt.dot``) refuses operand dimensions below 16.
MIN_DOT_DIM = 16
#: f32 dot algorithm: three TF32 tensor-core passes. Measured on the H200
#: inside the f32 tier and faster than the IEEE f32 dot (PERF.md).
F32_PRECISION = lax.DotAlgorithmPreset.TF32_TF32_F32_X3
NUM_WARPS = 4
NUM_STAGES = 3
_KERNEL_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def kernel_supports(block_rows: int, chunk_cols: int, dtype) -> bool:
    """Whether the Triton kernel takes tiles of this shape and dtype."""
    return (_pow2(block_rows) and _pow2(chunk_cols)
            and block_rows >= MIN_DOT_DIM and chunk_cols >= MIN_DOT_DIM
            and jnp.dtype(dtype) in _KERNEL_DTYPES)


def padded_width(k: int) -> int:
    """Fat-vector width the kernel runs at: next power of two >= 16."""
    return max(MIN_DOT_DIM, 1 << max(k - 1, 0).bit_length())


def _kernel(block_ptr_ref, pair_chunk_ref, tiles_ref, v_ref, out_ref, *,
            C: int, BR: int, BC: int, precision):
    b = pl.program_id(0)
    r0 = pl.program_id(1) * BR
    J = C // BC

    # One flat loop over (pair, column slice): its dynamic bounds lower
    # to a single scf.for that Triton software-pipelines.
    def body(i, acc):
        p = i // J
        c0 = (i % J) * BC
        tile = tiles_ref[p, pl.ds(r0, BR), pl.ds(c0, BC)]
        slab = v_ref[pl.ds(pair_chunk_ref[p] * C + c0, BC), :]
        return acc + pl.dot(tile, slab, precision=precision)

    acc = lax.fori_loop(block_ptr_ref[b] * J, block_ptr_ref[b + 1] * J,
                        body, jnp.zeros(out_ref.shape, jnp.float32))
    out_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("interpret",))
def windowed_matmul_pallas(block_ptr: jax.Array, pair_chunk: jax.Array,
                           tiles: jax.Array, v_pad: jax.Array, *,
                           interpret: bool = False) -> jax.Array:
    """Raw fused contraction: ``(nb*R, k)`` f32 block output.

    ``tiles``: (P, R, C) block-sorted, f32 or bf16; ``block_ptr``:
    (nb+1,) pair-run bounds; ``pair_chunk``: (P,) chunk of each pair;
    ``v_pad``: (rows, k) fat vector in the tiles' dtype with
    ``rows >= n_chunks*C`` and ``k`` a power of two >= 16. A block with
    an empty run gets zeros. ``interpret=True`` runs the kernel through
    the Pallas interpreter (CPU tests).
    """
    P, R, C = tiles.shape
    k = v_pad.shape[1]
    nb = block_ptr.shape[0] - 1
    if not kernel_supports(R, C, tiles.dtype):
        raise ValueError(
            f"tile shape ({R}, {C}) {tiles.dtype} not supported by the "
            "Triton kernel (powers of two >= 16, f32 or bf16)")
    if k != padded_width(k):
        raise ValueError(f"fat-vector width {k} must be a power of two "
                         f">= {MIN_DOT_DIM}; pad with padded_width()")
    if v_pad.dtype != tiles.dtype:
        raise ValueError(f"v_pad dtype {v_pad.dtype} != tiles dtype "
                         f"{tiles.dtype}")
    BR, BC = min(R, ROW_TILE), min(C, COL_TILE)
    precision = None
    if tiles.dtype == jnp.float32 and not interpret:
        # The CPU interpreter has no TF32 algorithms; its f32 dot is IEEE.
        precision = F32_PRECISION
    kernel = functools.partial(_kernel, C=C, BR=BR, BC=BC,
                               precision=precision)
    return pl.pallas_call(
        kernel,
        grid=(nb, R // BR),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=pl.BlockSpec((BR, k), lambda b, r: (b * (R // BR) + r, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * R, k), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="windowed_spmm",
    )(block_ptr, pair_chunk, tiles, v_pad)


def spmm_windowed_pallas(wp, v_p: jax.Array, *,
                         interpret: bool = False) -> jax.Array:
    """Padded-permuted-space SpMM through the fused kernel (drop-in for
    ``spmm_windowed_xla``): ``(pad_rows, k) -> (pad_rows, k)``.

    The fat vector is cast to the tiles' dtype (bf16 tiles take bf16
    operands with an f32 accumulator) and zero-padded to
    :func:`padded_width` columns; the pad columns are sliced off the
    result."""
    from .windowed import _finish

    k = v_p.shape[1]
    kp = padded_width(k)
    v_k = v_p.astype(wp.tiles.dtype)
    if kp != k:
        v_k = jnp.pad(v_k, ((0, 0), (0, kp - k)))
    computed = windowed_matmul_pallas(
        jnp.asarray(wp.block_ptr), jnp.asarray(wp.pair_chunk),
        jnp.asarray(wp.tiles), v_k, interpret=interpret)
    return _finish(wp, computed[:, :k], v_p)
