"""Sequential-oracle SpMM kernels.

Replacement for the reference's sequential kernel
(``Source Code/SparseMatrixFatVectorMultiply.cpp:11-31``): the canonical CSR
triple loop ``result[i][k] += values[j] * v[colIndices[j]][k]`` becomes a
single gather + segment-sum — the functional formulation XLA fuses onto the
VPU. Like the reference's sequential kernel, these serve double duty as the
correctness oracle for every distributed strategy
(differential-testing pattern of ``main.cpp:184,227,270``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.matrix import COO, CSR

__all__ = ["spmm_coo", "spmm_sequential", "spmm_dense"]


def spmm_coo(coo: COO, v: jax.Array) -> jax.Array:
    """SpMM via gather + sorted segment-sum over COO triplets.

    ``out[r] = sum_{j: row[j]==r} values[j] * v[col[j], :]`` — semantically
    the reference triple loop (``SparseMatrixFatVectorMultiply.cpp:22-27``)
    with the row loop turned into a segment reduction.
    """
    from .ell import take_rows

    m, _ = coo.shape
    gathered = take_rows(v, coo.col_indices)  # (nnz, k) HBM gather
    prods = coo.values[:, None].astype(v.dtype) * gathered
    return jax.ops.segment_sum(
        prods, coo.row_indices, num_segments=m, indices_are_sorted=True
    )


def spmm_sequential(matrix, v: jax.Array) -> jax.Array:
    """The single-device correctness oracle (reference: sequential kernel).

    Accepts CSR or COO; CSR is converted host-side (trace-time) to COO.
    """
    if isinstance(matrix, CSR):
        matrix = matrix.to_coo()
    return spmm_coo(matrix, v)


def spmm_dense(matrix, v: jax.Array) -> jax.Array:
    """Densify-and-matmul oracle — only for small test matrices."""
    dense = matrix.to_dense().astype(v.dtype)
    return jnp.dot(dense, v, preferred_element_type=v.dtype)


def spmm_host_f64(csr: CSR, v) -> "np.ndarray":
    """Host-side float64 oracle (numpy, no device involved).

    The device-independent ground truth for correctness checks: the
    reference's sequential kernel ran in f64 on the host too
    (``SparseMatrixFatVectorMultiply.cpp:11-31``), so device kernels running
    f32/bf16 are compared against this with a dtype-aware tolerance.
    Row sums via exclusive-cumsum differencing — vectorized and robust to
    empty rows.
    """
    import numpy as np

    vals = np.asarray(csr.values, dtype=np.float64)
    cols = np.asarray(csr.col_indices)
    row_ptr = np.asarray(csr.row_ptr).astype(np.int64)
    v = np.asarray(v, dtype=np.float64)
    prods = vals[:, None] * v[cols]
    csum = np.concatenate(
        [np.zeros((1, v.shape[1])), np.cumsum(prods, axis=0)], axis=0
    )
    return csum[row_ptr[1:]] - csum[row_ptr[:-1]]
