"""Gather-based ELL SpMM — the gather-class hot path.

The reference's row-wise hot loop
(``Source Code/SparseMatrixFatVectorMultiplyRowWise.cpp:36-50``) walks CSR
with data-dependent bounds. That shape-dynamism blocks XLA tiling, so
the compute layout here is ELLPACK: every row padded to a static width ``W``,
turning SpMM into

    out = sum_w  vals[:, w, None] * v[cols[:, w], :]

i.e. one big device-memory gather (``nnz_padded`` rows of ``v``) followed
by a dense multiply-reduce — no scatter, no dynamic shapes, fully fusable.
``BucketedELL`` (SELL-style) bounds the padding waste on skewed matrices,
replacing the reference's non-zero-element load-balancing rationale
(``...NonZeroElement.cpp:24-39``) with a static-shape equivalent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.matrix import ELL, BucketedELL

__all__ = ["spmm_ell", "spmm_bucketed", "take_rows"]


def take_rows(v: jax.Array, idx: jax.Array) -> jax.Array:
    """Row gather. Fat vectors narrower than 8 columns are widened
    (zero-padded behind an optimization barrier so XLA materializes the
    wide table) before gathering: wider rows gather faster than narrow
    ones, which makes SpMV (k=1) cheaper. The width was tuned before the
    GPU port and has not been measured on the H200 (ROADMAP Speed #6)."""
    k = v.shape[1]
    if k < 8:
        vw = jax.lax.optimization_barrier(
            jnp.pad(v, ((0, 0), (0, 8 - k)))
        )
        return jnp.take(vw, idx, axis=0)[:, :k]
    return jnp.take(v, idx, axis=0)


def spmm_ell(ell: ELL, v: jax.Array, *, unpad: bool = True) -> jax.Array:
    """SpMM over a single ELL block. Returns ``(m, k)`` (or padded rows)."""
    mp, w = ell.cols.shape
    k = v.shape[1]
    gathered = take_rows(v, ell.cols.reshape(-1))
    gathered = gathered.reshape(mp, w, k)
    out = jnp.sum(ell.vals[:, :, None].astype(v.dtype) * gathered, axis=1)
    if unpad:
        out = out[: ell.shape[0]]
    return out


def spmm_bucketed(bell: BucketedELL, v: jax.Array) -> jax.Array:
    """SpMM over bucketed ELL: per-bucket dense reduce, then one gather to
    restore original row order (gather via ``inv_row_perm`` rather than a
    scatter)."""
    parts = [spmm_ell(b, v, unpad=False) for b in bell.buckets]
    # One zero row for rows absent from every bucket (empty rows map one
    # past the end in ``inv_row_perm`` — see BucketedELL.from_csr).
    parts.append(jnp.zeros((1, v.shape[1]), parts[0].dtype))
    stacked = jnp.concatenate(parts, axis=0)
    return jnp.take(stacked, bell.inv_row_perm, axis=0)
