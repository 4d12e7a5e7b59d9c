"""Model workloads running end-to-end over the device mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from sparsematrixmultiplicationmpi_jax import CSR, generate_fat_vector
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr
from sparsematrixmultiplicationmpi_jax.models import (
    gcn_forward, gcn_loss, init_gcn, make_train_step, normalize_adjacency,
    synthetic_node_classification, topk_eigsh,
)
from sparsematrixmultiplicationmpi_jax.parallel import (
    BandedRowWise, RowWise, make_mesh,
)


def test_gcn_training_on_mesh():
    """Full GCN training loop with a mesh-distributed row-sharded
    adjacency: loss decreases and matches expectations of convergence."""
    import optax

    mesh = make_mesh(8)
    n, f, h, c = 128, 12, 24, 3
    adj, x, labels, mask = synthetic_node_classification(n, f, c, seed=330)
    strat = RowWise()
    operand = strat.prepare(normalize_adjacency(adj), mesh)
    spmm = lambda v: strat.spmm(operand, v, mesh)

    params = init_gcn(jax.random.PRNGKey(0), f, h, c, dtype=jnp.float64)
    x = x.astype(jnp.float64)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = jax.jit(make_train_step(spmm, opt))
    loss0 = float(gcn_loss(params, spmm, x, labels, mask))
    for _ in range(40):
        params, opt_state, loss = step(params, opt_state, x, labels, mask)
    assert float(loss) < loss0 * 0.6
    preds = jnp.argmax(gcn_forward(params, spmm, x), axis=1)
    acc = float(jnp.mean((preds == labels)[mask]))
    assert acc > 0.6


def test_lanczos_on_banded_mesh():
    """Top-k eigensolver where every matvec is the distributed halo-banded
    SpMM."""
    mesh = make_mesh(8)
    d = np.asarray(banded_csr(96, 3, 3, seed=331).to_dense())
    sym = d + d.T + 6 * np.eye(96)
    csr = CSR.from_dense(sym)
    strat = BandedRowWise(block_rows=8)
    operand = strat.prepare(csr, mesh)
    spmm = lambda v: strat.spmm(operand, v, mesh)
    vals, vecs = topk_eigsh(spmm, 96, k=2, steps=60)
    dense_vals = np.linalg.eigvalsh(sym)
    top2 = dense_vals[np.argsort(-np.abs(dense_vals))[:2]]
    np.testing.assert_allclose(
        np.sort(np.asarray(vals)), np.sort(top2), rtol=1e-7
    )
