"""Train the flagship GCN whose aggregation is the framework's SpMM.

Run: python examples/03_gcn_training.py
"""

import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)

import jax
import jax.numpy as jnp
import optax

from sparsematrixmultiplicationmpi_jax.formats.matrix import BucketedELL
from sparsematrixmultiplicationmpi_jax.models import (
    gcn_forward, gcn_loss, init_gcn, make_train_step, normalize_adjacency,
    synthetic_node_classification,
)
from sparsematrixmultiplicationmpi_jax.ops.ell import spmm_bucketed


def main():
    n, n_features, hidden, n_classes = 2048, 32, 64, 5
    adj, x, labels, mask = synthetic_node_classification(
        n, n_features, n_classes, seed=0
    )
    bell = BucketedELL.from_csr(normalize_adjacency(adj)).astype(jnp.float32)
    spmm = lambda v: spmm_bucketed(bell, v)

    params = init_gcn(jax.random.PRNGKey(0), n_features, hidden, n_classes)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = jax.jit(make_train_step(spmm, opt))

    for epoch in range(100):
        params, opt_state, loss = step(params, opt_state, x, labels, mask)
        if epoch % 20 == 0:
            preds = jnp.argmax(gcn_forward(params, spmm, x), axis=1)
            acc = float(jnp.mean((preds == labels)[mask]))
            print(f"epoch {epoch:3d}  loss {float(loss):.4f}  acc {acc:.3f}")

    preds = jnp.argmax(gcn_forward(params, spmm, x), axis=1)
    acc = float(jnp.mean((preds == labels)[~mask]))
    print(f"held-out accuracy: {acc:.3f}")


if __name__ == "__main__":
    main()
