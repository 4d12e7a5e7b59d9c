"""Custom VJP for SpMM — training-grade autodiff.

Differentiating the gather-based SpMM w.r.t. the fat vector gives XLA a
scatter-add (the transpose of a gather), which runs at the same ~5 ns/row
wall the forward gather avoids by formatting. These wrappers replace the
AD transpose with a *forward* SpMM against the transposed operand — built
once at prepare time — so the backward pass runs on the same fast kernels
as the forward (band-dense, windowed tiles or bucketed ELL).

For the symmetric case (GCN-normalized adjacencies, SPD solver matrices:
A^T = A) the forward operand is reused outright.
"""

from __future__ import annotations

from typing import Callable

import jax

from ..formats.matrix import CSR
from .auto import auto_format, spmm_any

__all__ = ["make_spmm", "make_symmetric_spmm", "transpose_csr"]


def transpose_csr(csr: CSR) -> CSR:
    """Host-side transpose (build-time)."""
    import numpy as np

    coo = csr.to_coo()
    from ..io.mtx import expand_and_build_csr

    return expand_and_build_csr(
        np.asarray(coo.col_indices).astype(np.int64),
        np.asarray(coo.row_indices).astype(np.int64),
        np.asarray(coo.values),
        csr.shape[1], csr.shape[0], symmetric=False,
    )


def make_symmetric_spmm(operand) -> Callable[[jax.Array], jax.Array]:
    """``v -> A v`` with backward ``g -> A g`` (valid when ``A^T = A``)."""

    @jax.custom_vjp
    def f(v):
        return spmm_any(operand, v)

    def fwd(v):
        return f(v), None

    def bwd(_, g):
        return (spmm_any(operand, g),)

    f.defvjp(fwd, bwd)
    return f


def make_spmm(csr: CSR, **format_kwargs) -> Callable[[jax.Array], jax.Array]:
    """``v -> A v`` with backward ``g -> A^T g`` via a second prepared
    operand (general, non-symmetric matrices)."""
    operand = auto_format(csr, **format_kwargs)
    operand_t = auto_format(transpose_csr(csr), **format_kwargs)

    @jax.custom_vjp
    def f(v):
        return spmm_any(operand, v)

    def fwd(v):
        return f(v), None

    def bwd(_, g):
        return (spmm_any(operand_t, g),)

    f.defvjp(fwd, bwd)
    return f
