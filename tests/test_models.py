"""Model-layer tests: PageRank, solvers, and the GCN flagship."""

import jax
import jax.numpy as jnp
import numpy as np

from sparsematrixmultiplicationmpi_jax import BucketedELL, CSR, spmm_bucketed
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr, random_csr
from sparsematrixmultiplicationmpi_jax.models import (
    conjugate_gradient, gcn_forward, gcn_loss, init_gcn, jacobi,
    make_train_step, normalize_adjacency, pagerank, power_iteration,
    synthetic_node_classification,
)
from sparsematrixmultiplicationmpi_jax.models.pagerank import (
    _normalize_columns,
)


def _spmm_closure(csr):
    bell = BucketedELL.from_csr(csr)
    return lambda v: spmm_bucketed(bell, v)


def test_pagerank_matches_dense():
    csr = random_csr(60, 60, 500, seed=41)
    import dataclasses

    csr = dataclasses.replace(csr, values=jnp.abs(csr.values))
    norm = _normalize_columns(csr)
    ranks, iters = pagerank(_spmm_closure(norm), 60, tol=1e-12)
    # Dense fixed point for comparison.
    a = np.asarray(norm.to_dense())
    r = np.full(60, 1.0 / 60)
    for _ in range(2000):
        r = 0.85 * a @ r + 0.15 / 60
        r = r / r.sum()
    np.testing.assert_allclose(np.asarray(ranks), r, atol=1e-8)
    assert int(iters) < 200
    np.testing.assert_allclose(float(jnp.sum(ranks)), 1.0, atol=1e-9)


def test_power_iteration_dominant_eig():
    d = np.asarray(random_csr(40, 40, 300, seed=42).to_dense())
    sym = d + d.T + 10 * np.eye(40)  # well-separated dominant eig
    csr = CSR.from_dense(sym)
    lam, vec, iters = power_iteration(_spmm_closure(csr), 40, tol=1e-12)
    eigs = np.linalg.eigvalsh(sym)
    target = eigs[np.argmax(np.abs(eigs))]
    np.testing.assert_allclose(float(lam), target, rtol=1e-6)


def test_conjugate_gradient_spd():
    d = np.asarray(banded_csr(80, 3, 3, seed=43).to_dense())
    spd = d @ d.T + 5 * np.eye(80)
    csr = CSR.from_dense(spd)
    b = np.asarray(np.random.default_rng(44).normal(size=(80, 3)))
    res = conjugate_gradient(_spmm_closure(csr), jnp.asarray(b), tol=1e-12)
    x_ref = np.linalg.solve(spd, b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
    assert float(res.residual_norm) < 1e-8


def test_conjugate_gradient_1d_rhs():
    spd = 4 * np.eye(16) + np.diag(np.ones(15), 1) + np.diag(np.ones(15), -1)
    csr = CSR.from_dense(spd)
    b = np.arange(16.0)
    res = conjugate_gradient(_spmm_closure(csr), jnp.asarray(b))
    np.testing.assert_allclose(
        np.asarray(res.x), np.linalg.solve(spd, b), atol=1e-8
    )
    assert res.x.shape == (16,)


def test_jacobi_diagonally_dominant():
    rng = np.random.default_rng(45)
    off = rng.uniform(-0.1, 0.1, size=(30, 30)) * (rng.uniform(size=(30, 30)) < 0.2)
    np.fill_diagonal(off, 0)
    a = off + np.eye(30) * 3.0
    csr = CSR.from_dense(a)
    b = rng.normal(size=30)
    res = jacobi(_spmm_closure(csr), jnp.asarray(np.diag(a)), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(a, b), atol=1e-7)


def test_normalize_adjacency_symmetric_rows():
    adj, _, _, _ = synthetic_node_classification(50, 8, 3, seed=46)
    norm = normalize_adjacency(adj)
    dense = np.asarray(norm.to_dense())
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)
    # Spectral radius of D^-1/2 (A+I) D^-1/2 is <= 1.
    assert np.max(np.abs(np.linalg.eigvalsh(dense))) <= 1.0 + 1e-9


def test_gcn_forward_shapes():
    adj, x, labels, mask = synthetic_node_classification(64, 12, 4, seed=47)
    norm = normalize_adjacency(adj).astype(jnp.float64)
    spmm = _spmm_closure(norm)
    params = init_gcn(jax.random.PRNGKey(0), 12, 16, 4, dtype=jnp.float64)
    logits = gcn_forward(params, spmm, x.astype(jnp.float64))
    assert logits.shape == (64, 4)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_gcn_training_learns():
    import optax

    adj, x, labels, mask = synthetic_node_classification(128, 16, 3, seed=48)
    norm = normalize_adjacency(adj).astype(jnp.float64)
    spmm = _spmm_closure(norm)
    x = x.astype(jnp.float64)
    params = init_gcn(jax.random.PRNGKey(1), 16, 32, 3, dtype=jnp.float64)
    opt = optax.adam(1e-2)
    step = jax.jit(make_train_step(spmm, opt))
    opt_state = opt.init(params)
    loss0 = float(gcn_loss(params, spmm, x, labels, mask))
    for _ in range(60):
        params, opt_state, loss = step(params, opt_state, x, labels, mask)
    assert float(loss) < loss0 * 0.5
    # Training accuracy should be well above chance (1/3).
    preds = jnp.argmax(gcn_forward(params, spmm, x), axis=1)
    acc = float(jnp.mean((preds == labels)[mask]))
    assert acc > 0.7


def test_gat_layer():
    from sparsematrixmultiplicationmpi_jax.models.gat import (
        gat_layer, init_gat, segment_softmax,
    )
    from sparsematrixmultiplicationmpi_jax.models import (
        synthetic_node_classification,
    )

    adj, x, labels, mask = synthetic_node_classification(40, 8, 3, seed=230)
    coo = adj.to_coo().astype(jnp.float64)
    params = init_gat(jax.random.PRNGKey(0), 8, 16, dtype=jnp.float64)
    out = gat_layer(params, coo, x.astype(jnp.float64))
    assert out.shape == (40, 16)
    assert bool(jnp.all(jnp.isfinite(out)))
    # Attention weights sum to 1 per row with edges.
    rows = np.asarray(coo.row_indices)
    h = x.astype(jnp.float64) @ params.w
    scores = jax.nn.leaky_relu(
        jnp.take(h @ params.att_dst, coo.row_indices)
        + jnp.take(h @ params.att_src, coo.col_indices), 0.2)
    w = segment_softmax(scores, coo.row_indices, 40)
    sums = np.zeros(40)
    np.add.at(sums, rows, np.asarray(w))
    present = np.unique(rows)
    np.testing.assert_allclose(sums[present], 1.0, atol=1e-12)
    # Differentiable end to end.
    g = jax.grad(
        lambda p: jnp.sum(gat_layer(p, coo, x.astype(jnp.float64)) ** 2)
    )(params)
    assert bool(jnp.all(jnp.isfinite(g.w)))
