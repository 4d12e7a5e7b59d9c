"""Band-dense SpMM — batched dense matmuls over halo windows.

The compute form of ``formats/banded.py``: the band contribution is three
batched matmuls (one per halo position — previous/self/next block), summed.
No gathers; the only data movement is the streaming read of the dense band
(which XLA pipelines at memory bandwidth) and the tiny fat-vector blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.banded import BandedBlocks
from .ell import spmm_bucketed

__all__ = ["spmm_banded"]


def spmm_banded(bb: BandedBlocks, v: jax.Array) -> jax.Array:
    """SpMM over band-dense storage. ``v`` is ``(n, k)``; returns ``(m, k)``.

    ``out[b] = sum_s band[b, :, sR:(s+1)R] @ v_blocks[b-1+s]`` — expressed
    as three batched matmuls over shifted block views, which is cheaper
    than materializing the ``(nb, 3R, k)`` halo windows.
    """
    m, n = bb.shape
    r = bb.block_rows
    nb = bb.n_blocks
    k = v.shape[1]

    # Mixed precision: a bf16-stored band (half the streaming traffic — the
    # dominant cost) still multiplies natively and accumulates
    # in the fat vector's dtype. The fat vector keeps its own precision.
    out_dtype = v.dtype if v.dtype.itemsize >= 4 else bb.band.dtype

    # Pad v to (nb + 2) blocks: one leading halo block, trailing fill.
    total = (nb + 2) * r
    v_pad = jnp.zeros((total, k), dtype=v.dtype)
    v_pad = jax.lax.dynamic_update_slice(v_pad, v[: total - r], (r, 0))
    v_blocks = v_pad.reshape(nb + 2, r, k)

    # f32xf32 needs HIGHEST precision: the default GPU lowering may run
    # f32 matmul inputs as TF32 (about three decimal digits), too coarse
    # for the f32 tier. The band contraction is memory-bound, so full f32
    # costs little. A deliberately bf16-stored band takes the native path.
    precision = (
        jax.lax.Precision.HIGHEST
        if bb.band.dtype == jnp.float32 and v.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    out = jnp.zeros((nb, r, k), dtype=out_dtype)
    for s in range(3):
        out = out + jnp.einsum(
            "brc,bck->brk",
            bb.band[:, :, s * r: (s + 1) * r],
            jax.lax.dynamic_slice_in_dim(v_blocks, s, nb, axis=0),
            preferred_element_type=out_dtype,
            precision=precision,
        )
    out = out.reshape(nb * r, k)[:m]

    if bb.spill is not None:
        out = out + spmm_bucketed(bb.spill, v[:n]).astype(out_dtype)
    return out
