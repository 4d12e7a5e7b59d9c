"""SpMM over windowed tile pairs — slab gather + batched matmuls.

XLA path for ``formats/windowed.py::WindowedPairs``; the fused Triton
kernel (``ops/pallas_windowed.py``) computes the same contraction
without materializing the gathered slabs. Replaces the reference hot
loops (``SparseMatrixFatVectorMultiplyRowWise.cpp:36-50``) with:

    slabs[p] = v[pair_chunk[p]*C : (p+1)*C]        # P slab gathers
    out[pair_block[p]] += tiles[p] @ slabs[p]      # batched matmul

The only gathers are P slab fetches (P ~ #tiles, thousands — not
#nonzeros, millions) plus the block segment-sum.

Core functions live in the operand's *padded permuted* space
(``WindowedPairs.encode``/``decode``): fat vectors arrive pre-padded to
``wp.pad_rows`` rows, outputs leave padded — chained consumers pay zero
per-step layout transforms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.windowed import WindowedPairs
from .ell import spmm_ell

__all__ = ["spmm_windowed", "spmm_windowed_core", "spmm_windowed_xla"]


def _precision(tiles_dtype, v_dtype):
    # f32xf32 needs HIGHEST: the default GPU lowering may run f32 inputs
    # as TF32 (about three decimal digits).
    return (jax.lax.Precision.HIGHEST
            if tiles_dtype == jnp.float32 and v_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)


def _finish(wp: WindowedPairs, out_blocks: jax.Array,
            v_p: jax.Array) -> jax.Array:
    """(nb*R, k) block output -> padded-space result + spill."""
    m, n = wp.shape
    k = out_blocks.shape[1]
    pad = wp.pad_rows - out_blocks.shape[0]
    if pad > 0:
        out_blocks = jnp.concatenate(
            [out_blocks, jnp.zeros((pad, k), out_blocks.dtype)], axis=0)
    out = out_blocks
    if wp.spill is not None:
        # Restore via the m-row take rather than a compact scatter-add
        # over the spill rows (a sorted gather, no write conflicts).
        # The gather table is v_p UNSLICED (spill column ids are < n, so
        # the pad tail is never addressed — slicing would cost a 15 MB
        # copy per iterate), and the restore take is extended over the
        # pad tail (pointing at the all-zero row) so the result lands
        # directly in padded space with no concat+add of a second
        # full-size array.
        bell = wp.spill
        parts = [spmm_ell(b, v_p, unpad=False) for b in bell.buckets]
        parts.append(jnp.zeros((1, k), parts[0].dtype))
        stacked = jnp.concatenate(parts, axis=0)
        idx = bell.inv_row_perm
        tail = out.shape[0] - m
        if tail > 0:
            idx = jnp.concatenate([
                idx,
                jnp.full((tail,), stacked.shape[0] - 1, idx.dtype),
            ])
        out = out + jnp.take(stacked, idx, axis=0).astype(out.dtype)
    return out


def spmm_windowed_xla(wp: WindowedPairs, v_p: jax.Array) -> jax.Array:
    """Padded-permuted-space SpMM via slab gather + batched einsum +
    block segment-sum (pairs are block-sorted, so the segment-sum is a
    sorted reduction, not a scatter).

    ``v_p`` is a ``(pad_rows, k)`` fat vector from ``wp.encode``.
    Returns the padded-space ``(pad_rows, k)`` result.
    """
    R, C = wp.block_rows, wp.chunk_cols
    nb = wp.n_blocks
    k = v_p.shape[1]
    n_chunks = wp.n_chunks

    # f32 accumulation even for bf16 operands (matches the Triton kernel).
    out_dtype = jnp.promote_types(
        jnp.float32, jnp.promote_types(wp.tiles.dtype, v_p.dtype)
    )
    # Operands in the tiles' dtype, as the kernel takes them: bf16 x bf16
    # products are exact in the f32 accumulator.
    if v_p.dtype != wp.tiles.dtype:
        v_p = v_p.astype(wp.tiles.dtype)

    slabs = jnp.take(
        v_p[: n_chunks * C].reshape(n_chunks, C * k), wp.pair_chunk,
        axis=0,
    ).reshape(-1, C, k)  # (P, C, k)
    prods = jnp.einsum(
        "prc,pck->prk", wp.tiles, slabs,
        preferred_element_type=out_dtype,
        precision=_precision(wp.tiles.dtype, v_p.dtype),
    )
    out_blocks = jax.ops.segment_sum(
        prods, wp.pair_block, num_segments=nb, indices_are_sorted=True
    ).reshape(nb * R, k)
    return _finish(wp, out_blocks, v_p)


def spmm_windowed_core(wp: WindowedPairs, v_p: jax.Array, *,
                       use_pallas: bool | None = None) -> jax.Array:
    """Padded-permuted-space SpMM.

    ``use_pallas=None`` takes the fused Triton kernel on the GPU when it
    supports the format's tile shape and dtype
    (``pallas_windowed.kernel_supports``), and the XLA path otherwise —
    always on the CPU. ``use_pallas=True`` asks for the kernel
    explicitly: compiled on the GPU, through the Pallas interpreter on
    the CPU (tests). ``False`` forces the XLA path."""
    from ..utils.backend import platform
    from .pallas_windowed import kernel_supports, spmm_windowed_pallas

    on_gpu = platform() == "gpu"
    if use_pallas is None:
        use_pallas = on_gpu and kernel_supports(
            wp.block_rows, wp.chunk_cols, wp.tiles.dtype)
    if use_pallas:
        return spmm_windowed_pallas(wp, v_p, interpret=not on_gpu)
    return spmm_windowed_xla(wp, v_p)


def spmm_windowed(wp: WindowedPairs, v: jax.Array, *,
                  use_pallas: bool | None = None) -> jax.Array:
    """Full SpMM in original coordinates: encode -> iterate -> decode.

    Iterative consumers should instead call ``wp.encode`` once, chain
    ``wp.iterate``, and ``wp.decode`` once — the boundary permute/pad is
    a one-time cost (the PETSc never-regather lesson,
    ``report/425500_Report.tex:1092-1095``).
    """
    return wp.decode(
        spmm_windowed_core(wp, wp.encode(v), use_pallas=use_pallas)
    )
