"""Single-device kernel tests vs the dense oracle (differential pattern of
main.cpp:184,227,270 — every kernel against the sequential result)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import (
    CSR, ELL, BucketedELL,
    generate_fat_vector, max_abs_error,
    spmm_bcoo, spmm_bucketed, spmm_coo, spmm_dense, spmm_ell,
    spmm_sequential, to_bcoo,
)
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, cage4_like, dc1_like, powerlaw_csr, random_csr,
    roadnet_like,
)

MATRICES = {
    "cage4_like": lambda: cage4_like(),
    "random": lambda: random_csr(120, 90, 1000, seed=1),
    "banded": lambda: banded_csr(200, 9, 7, seed=2),
    "powerlaw": lambda: powerlaw_csr(150, 150, 2500, seed=3),
    "roadnet_like": lambda: roadnet_like(scale=0.002, seed=4),
    "dc1_like": lambda: dc1_like(scale=0.005, seed=5),
    "single_row": lambda: CSR.from_dense(np.ones((1, 64))),
    "single_col": lambda: CSR.from_dense(np.ones((64, 1))),
    "with_empty_rows": lambda: CSR.from_dense(
        np.diag([1.0, 0, 0, 2.0, 0, 3.0, 0, 0])
    ),
}

KS = [1, 3, 12]


def _oracle(csr, v):
    return np.asarray(csr.to_dense()) @ np.asarray(v)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", KS)
def test_spmm_sequential(name, k):
    csr = MATRICES[name]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=5))
    out = spmm_sequential(csr, v)
    assert out.shape == (csr.shape[0], k)
    assert max_abs_error(out, _oracle(csr, v)) < 1e-9


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", KS)
def test_spmm_ell(name, k):
    csr = MATRICES[name]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=6))
    out = spmm_ell(ELL.from_csr(csr), v)
    assert out.shape == (csr.shape[0], k)
    assert max_abs_error(out, _oracle(csr, v)) < 1e-9


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", KS)
def test_spmm_bucketed(name, k):
    csr = MATRICES[name]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=7))
    out = spmm_bucketed(BucketedELL.from_csr(csr), v)
    assert out.shape == (csr.shape[0], k)
    assert max_abs_error(out, _oracle(csr, v)) < 1e-9


@pytest.mark.parametrize("name", ["random", "powerlaw"])
def test_spmm_bcoo(name):
    csr = MATRICES[name]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 6, seed=8))
    out = spmm_bcoo(to_bcoo(csr), v)
    assert max_abs_error(out, _oracle(csr, v)) < 1e-9


def test_spmm_coo_padded():
    # Padded COO (explicit zeros at (0,0)) must not change the result —
    # required by the nnz-sharded strategy.
    csr = random_csr(30, 30, 200, seed=9)
    coo = csr.to_coo().pad_to(256)
    v = jnp.asarray(generate_fat_vector(30, 4, seed=10))
    assert max_abs_error(spmm_coo(coo, v), _oracle(csr, v)) < 1e-11


def test_spmm_jit_and_grad():
    # Kernels are functional: jit-able and differentiable w.r.t. the dense
    # operand (needed by the models layer).
    csr = random_csr(20, 20, 100, seed=11)
    bell = BucketedELL.from_csr(csr)
    v = jnp.asarray(generate_fat_vector(20, 3, seed=12))

    f = jax.jit(lambda vv: spmm_bucketed(bell, vv).sum())
    g = jax.grad(lambda vv: spmm_bucketed(bell, vv).sum())(v)
    # d(sum(Av))/dv = A^T 1 broadcast over k
    expected = np.asarray(csr.to_dense()).T.sum(axis=1, keepdims=True)
    assert max_abs_error(g, np.broadcast_to(expected, g.shape)) < 1e-9
    f(v)


def test_f32_tolerance():
    csr = random_csr(100, 100, 1200, seed=13).astype(jnp.float32)
    v = jnp.asarray(generate_fat_vector(100, 8, seed=14, dtype=np.float32))
    out = spmm_bucketed(BucketedELL.from_csr(csr), v)
    ref = _oracle(csr, v)
    assert max_abs_error(out, ref) < 1e-2  # f32 with values in [1,100]


def test_dense_oracle_matches_numpy():
    csr = MATRICES["random"]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 2, seed=15))
    assert max_abs_error(spmm_dense(csr, v), _oracle(csr, v)) < 1e-9


def test_sddmm_matches_dense():
    from sparsematrixmultiplicationmpi_jax.ops.sddmm import sddmm

    csr = random_csr(30, 20, 150, seed=220)
    rng = np.random.default_rng(221)
    a = jnp.asarray(rng.normal(size=(30, 7)))
    b = jnp.asarray(rng.normal(size=(20, 7)))
    out = sddmm(csr, a, b)
    dense_scores = np.asarray(a) @ np.asarray(b).T
    mask = np.asarray(csr.to_dense()) != 0
    expected = np.where(mask, dense_scores, 0.0)
    assert max_abs_error(out.to_dense(), expected) < 1e-10


def test_sddmm_scaled_and_grad():
    from sparsematrixmultiplicationmpi_jax.ops.sddmm import sddmm

    csr = random_csr(16, 16, 60, seed=222)
    rng = np.random.default_rng(223)
    a = jnp.asarray(rng.normal(size=(16, 4)))
    b = jnp.asarray(rng.normal(size=(16, 4)))
    out = sddmm(csr, a, b, scale_by_values=True)
    coo = csr.to_coo()
    rows, cols = np.asarray(coo.row_indices), np.asarray(coo.col_indices)
    expected = np.asarray(coo.values) * np.sum(
        np.asarray(a)[rows] * np.asarray(b)[cols], axis=1
    )
    np.testing.assert_allclose(np.asarray(out.values), expected, atol=1e-12)
    # Differentiable w.r.t. the dense factors (attention training).
    g = jax.grad(lambda aa: jnp.sum(sddmm(csr, aa, b).values ** 2))(a)
    assert g.shape == a.shape and bool(jnp.all(jnp.isfinite(g)))


def test_sddmm_shape_mismatch():
    from sparsematrixmultiplicationmpi_jax.ops.sddmm import sddmm

    csr = random_csr(8, 8, 20, seed=224)
    with pytest.raises(ValueError):
        sddmm(csr, jnp.ones((8, 3)), jnp.ones((9, 3)))
