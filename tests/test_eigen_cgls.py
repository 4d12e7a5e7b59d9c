"""Lanczos eigensolver and CGLS least-squares tests."""

import jax.numpy as jnp
import numpy as np

from sparsematrixmultiplicationmpi_jax import CSR, BucketedELL, spmm_bucketed
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr, random_csr
from sparsematrixmultiplicationmpi_jax.models import cgls, lanczos, topk_eigsh
from sparsematrixmultiplicationmpi_jax.ops.autodiff import make_spmm


def _sym_csr(n=60, seed=211, shift=6.0):
    d = np.asarray(banded_csr(n, 4, 3, seed=seed).to_dense())
    sym = d + d.T + shift * np.eye(n)
    return CSR.from_dense(sym), sym


def _closure(csr):
    bell = BucketedELL.from_csr(csr)
    return lambda v: spmm_bucketed(bell, v)


def test_topk_eigsh_matches_dense():
    csr, sym = _sym_csr()
    vals, vecs = topk_eigsh(_closure(csr), 60, k=3, steps=60)
    dense_vals = np.linalg.eigvalsh(sym)
    top3 = dense_vals[np.argsort(-np.abs(dense_vals))[:3]]
    np.testing.assert_allclose(
        np.sort(np.asarray(vals)), np.sort(top3), rtol=1e-8
    )
    # Residual check: ||A v - lambda v|| small.
    for i in range(3):
        v = np.asarray(vecs[:, i])
        r = sym @ v - float(vals[i]) * v
        assert np.linalg.norm(r) < 1e-6


def test_lanczos_orthogonal_basis():
    csr, _ = _sym_csr(seed=212)
    res = lanczos(_closure(csr), 60, steps=20)
    q = np.asarray(res.vectors)
    gram = q @ q.T
    np.testing.assert_allclose(gram, np.eye(20), atol=1e-8)


def test_cgls_overdetermined():
    # min ||A x - b|| with A (80 x 30): normal-equations solution.
    csr = random_csr(80, 30, 500, seed=213)
    f = make_spmm(csr)
    from sparsematrixmultiplicationmpi_jax.ops.autodiff import transpose_csr

    ft = _closure(transpose_csr(csr))
    rng = np.random.default_rng(214)
    b = rng.normal(size=(80, 2))
    res = cgls(f, ft, jnp.asarray(b), tol=1e-14, max_iter=500)
    a = np.asarray(csr.to_dense())
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


def test_cgls_1d_rhs():
    csr = random_csr(40, 25, 300, seed=215)
    from sparsematrixmultiplicationmpi_jax.ops.autodiff import transpose_csr

    f = _closure(csr)
    ft = _closure(transpose_csr(csr))
    b = np.random.default_rng(216).normal(size=40)
    res = cgls(f, ft, jnp.asarray(b), tol=1e-14)
    a = np.asarray(csr.to_dense())
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
    assert res.x.shape == (25,)


def test_preconditioned_cg_fewer_iterations():
    """Jacobi preconditioning must converge in fewer iterations on an
    ill-conditioned diagonal-dominant system."""
    rng = np.random.default_rng(217)
    n = 100
    # Wildly varying diagonal -> poor conditioning for plain CG.
    diag = 10.0 ** rng.uniform(0, 4, size=n)
    off = rng.normal(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.05)
    a = (off + off.T) * 0.1 + np.diag(diag)
    csr = CSR.from_dense(a)
    spmm = _closure(csr)
    b = jnp.asarray(rng.normal(size=n))
    from sparsematrixmultiplicationmpi_jax.models import conjugate_gradient

    plain = conjugate_gradient(spmm, b, tol=1e-10, max_iter=2000)
    inv_d = jnp.asarray(1.0 / diag)
    pre = conjugate_gradient(
        spmm, b, tol=1e-10, max_iter=2000,
        preconditioner=lambda r: r * inv_d[:, None],
    )
    x_ref = np.linalg.solve(a, np.asarray(b))
    np.testing.assert_allclose(np.asarray(pre.x), x_ref, atol=1e-5)
    assert int(pre.iterations) < int(plain.iterations)


def test_multi_head_gat():
    import jax
    from sparsematrixmultiplicationmpi_jax.models.gat import (
        init_gat, multi_head_gat,
    )
    from sparsematrixmultiplicationmpi_jax.models import (
        synthetic_node_classification,
    )

    adj, x, _, _ = synthetic_node_classification(30, 6, 2, seed=218)
    coo = adj.to_coo().astype(jnp.float64)
    heads = [init_gat(jax.random.PRNGKey(i), 6, 8, dtype=jnp.float64)
             for i in range(3)]
    out = multi_head_gat(heads, coo, x.astype(jnp.float64))
    assert out.shape == (30, 24)
    avg = multi_head_gat(heads, coo, x.astype(jnp.float64), concat=False)
    assert avg.shape == (30, 8)
