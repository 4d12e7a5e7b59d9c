"""Custom-VJP SpMM tests: backward equals A^T g without scatter."""

import jax
import jax.numpy as jnp
import numpy as np

from sparsematrixmultiplicationmpi_jax import CSR, generate_fat_vector
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr, random_csr
from sparsematrixmultiplicationmpi_jax.ops.autodiff import (
    make_spmm, make_symmetric_spmm, transpose_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format


def test_transpose_csr():
    csr = random_csr(12, 20, 80, seed=201)
    t = transpose_csr(csr)
    assert t.shape == (20, 12)
    np.testing.assert_allclose(
        np.asarray(t.to_dense()), np.asarray(csr.to_dense()).T
    )


def test_general_vjp_matches_dense():
    csr = random_csr(30, 25, 200, seed=202)
    f = make_spmm(csr)
    v = jnp.asarray(generate_fat_vector(25, 4, seed=203))
    dense = np.asarray(csr.to_dense())

    np.testing.assert_allclose(
        np.asarray(f(v)), dense @ np.asarray(v), atol=1e-9
    )
    # Cotangent: d/dv sum(w * (A v)) = A^T w
    w = np.asarray(generate_fat_vector(30, 4, seed=204))
    g = jax.grad(lambda vv: jnp.sum(jnp.asarray(w) * f(vv)))(v)
    np.testing.assert_allclose(np.asarray(g), dense.T @ w, atol=1e-9)


def test_symmetric_vjp_matches_dense():
    d = np.asarray(banded_csr(40, 5, 4, seed=205).to_dense())
    sym = d + d.T
    csr = CSR.from_dense(sym)
    f = make_symmetric_spmm(auto_format(csr))
    v = jnp.asarray(generate_fat_vector(40, 3, seed=206))
    w = np.asarray(generate_fat_vector(40, 3, seed=207))
    g = jax.grad(lambda vv: jnp.sum(jnp.asarray(w) * f(vv)))(v)
    np.testing.assert_allclose(np.asarray(g), sym.T @ w, atol=1e-9)


def test_vjp_jits_and_composes():
    csr = random_csr(16, 16, 60, seed=208)
    f = make_spmm(csr)

    @jax.jit
    def loss(v):
        return jnp.sum(f(f(v)) ** 2)  # A(A v): chain rule through two VJPs

    v = jnp.asarray(generate_fat_vector(16, 2, seed=209))
    g = jax.grad(loss)(v)
    dense = np.asarray(csr.to_dense())
    expected = 2 * dense.T @ dense.T @ (dense @ dense @ np.asarray(v))
    np.testing.assert_allclose(np.asarray(g), expected, atol=1e-8)
