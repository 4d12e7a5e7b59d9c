"""Edge cases: empty matrices, degenerate shapes, dtype promotion."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import (
    CSR, BucketedELL, ELL, generate_fat_vector, max_abs_error,
    spmm_bucketed, spmm_ell, spmm_sequential,
)
from sparsematrixmultiplicationmpi_jax.io.generate import random_csr
from sparsematrixmultiplicationmpi_jax.parallel import (
    NonZeroElement, RowWise, make_mesh,
)


def _empty(m=6, n=5):
    return CSR.from_arrays(
        np.zeros(0), np.zeros(0, np.int32), np.zeros(m + 1, np.int32), (m, n)
    )


def test_empty_matrix_sequential():
    csr = _empty()
    v = jnp.asarray(generate_fat_vector(5, 3, seed=181))
    out = spmm_sequential(csr, v)
    assert out.shape == (6, 3)
    assert float(jnp.abs(out).max()) == 0.0


def test_empty_matrix_ell_paths():
    csr = _empty()
    v = jnp.asarray(generate_fat_vector(5, 2, seed=182))
    assert float(jnp.abs(spmm_ell(ELL.from_csr(csr), v)).max()) == 0.0
    assert float(
        jnp.abs(spmm_bucketed(BucketedELL.from_csr(csr), v)).max()
    ) == 0.0


def test_empty_matrix_distributed():
    csr = _empty(16, 16)
    mesh = make_mesh(4)
    v = jnp.asarray(generate_fat_vector(16, 2, seed=183))
    for strat in (RowWise(), NonZeroElement()):
        out = strat.spmm(strat.prepare(csr, mesh), v, mesh)
        assert float(jnp.abs(out).max()) == 0.0


def test_one_by_one():
    csr = CSR.from_dense(np.array([[2.5]]))
    v = jnp.asarray([[3.0, 4.0]])
    out = spmm_sequential(csr, v)
    np.testing.assert_allclose(np.asarray(out), [[7.5, 10.0]])


def test_scalar_k():
    # k=1 (SpMV) through every single-device path.
    csr = random_csr(20, 20, 100, seed=184)
    v = jnp.asarray(generate_fat_vector(20, 1, seed=185))
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert max_abs_error(spmm_sequential(csr, v), oracle) < 1e-10
    assert max_abs_error(
        spmm_bucketed(BucketedELL.from_csr(csr), v), oracle
    ) < 1e-10


def test_dtype_promotion_f32_values_f64_vector():
    csr = random_csr(10, 10, 40, seed=186).astype(jnp.float32)
    v = jnp.asarray(generate_fat_vector(10, 2, seed=187), jnp.float64)
    out = spmm_sequential(csr, v)
    assert out.dtype == jnp.float64


def test_int_fat_vector_rejected_gracefully():
    # Integer fat vectors promote through the float kernels.
    csr = random_csr(8, 8, 20, seed=188)
    v = jnp.asarray(generate_fat_vector(8, 2, seed=189), jnp.int32)
    out = spmm_sequential(csr, v.astype(csr.values.dtype))
    assert out.shape == (8, 2)


def test_rectangular_wide_and_tall():
    for m, n in [(3, 50), (50, 3)]:
        csr = random_csr(m, n, 40, seed=190 + m)
        v = jnp.asarray(generate_fat_vector(n, 4, seed=192))
        oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
        assert max_abs_error(
            spmm_bucketed(BucketedELL.from_csr(csr), v), oracle
        ) < 1e-10
