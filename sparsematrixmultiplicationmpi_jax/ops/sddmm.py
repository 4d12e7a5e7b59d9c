"""SDDMM — sampled dense-dense matrix multiplication.

``out[i, j] = <a[i, :], b[j, :]>`` evaluated only at a sparse pattern's
nonzero positions: the companion primitive to SpMM in graph attention
(GAT/transformer-on-graph scores) and in factorization losses. Expressed
as two row gathers plus a dense row-wise reduction — the same
no-scatter recipe as the SpMM kernels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..formats.matrix import COO, CSR

__all__ = ["sddmm", "sddmm_coo"]


def sddmm_coo(pattern: COO, a: jax.Array, b: jax.Array, *,
              scale_by_values: bool = False) -> COO:
    """SDDMM over a COO pattern.

    ``a``: (m, d); ``b``: (n, d). Returns a COO with the same pattern and
    values ``<a[row], b[col]>`` (times the pattern's values when
    ``scale_by_values``).
    """
    m, n = pattern.shape
    if a.shape[0] != m or b.shape[0] != n or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"shape mismatch: pattern {pattern.shape}, a {a.shape}, "
            f"b {b.shape}"
        )
    ga = jnp.take(a, pattern.row_indices, axis=0)
    gb = jnp.take(b, pattern.col_indices, axis=0)
    values = jnp.sum(ga * gb, axis=1)
    if scale_by_values:
        values = values * pattern.values.astype(values.dtype)
    return dataclasses.replace(pattern, values=values)


def sddmm(pattern, a: jax.Array, b: jax.Array, *,
          scale_by_values: bool = False) -> COO:
    """SDDMM over a CSR or COO pattern (CSR converted at trace time)."""
    if isinstance(pattern, CSR):
        pattern = pattern.to_coo()
    return sddmm_coo(pattern, a, b, scale_by_values=scale_by_values)
