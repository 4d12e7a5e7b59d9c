"""Graph convolutional network — the framework's flagship model.

A two-layer GCN (Kipf & Welling style) whose neighborhood aggregation is the
framework's SpMM: ``H' = act( Â (H W) + b )`` with ``Â`` the symmetrically
normalized adjacency in ELL/bucketed-ELL form. This is the canonical
production workload for SpMM-with-small-k — the fat-vector multiply the
reference benchmarks *is* the GCN aggregation step.

Everything is functional (explicit params pytree + optax), so the training
step jits and shards over a device mesh: adjacency rows and node features
sharded on the mesh axis, weights replicated, gradients combined by the
``psum`` XLA inserts for the replicated-weight/sharded-data layout.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..formats.matrix import CSR

__all__ = [
    "GCNParams", "normalize_adjacency", "init_gcn", "gcn_forward",
    "gcn_loss", "make_train_step", "synthetic_node_classification",
]


class GCNParams(NamedTuple):
    w1: jax.Array
    b1: jax.Array
    w2: jax.Array
    b2: jax.Array


def normalize_adjacency(csr: CSR, add_self_loops: bool = True) -> CSR:
    """Symmetric GCN normalization ``D^-1/2 (A + I) D^-1/2`` (host-side,
    format-build time)."""
    m, n = csr.shape
    if m != n:
        raise ValueError("adjacency must be square")
    coo = csr.to_coo()
    rows = np.asarray(coo.row_indices)
    cols = np.asarray(coo.col_indices)
    vals = np.abs(np.asarray(coo.values))
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(m)])
        cols = np.concatenate([cols, np.arange(m)])
        vals = np.concatenate([vals, np.ones(m)])
    deg = np.zeros(m)
    np.add.at(deg, rows, vals)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg == 0, 1, deg)), 0.0)
    # Normalize in f64 for accuracy, but PRESERVE the input dtype: an
    # f64 result from an f32 adjacency would silently build f64 formats,
    # which take the slower XLA path instead of the f32 kernels.
    in_dtype = np.asarray(coo.values).dtype
    vals = (dinv[rows] * vals * dinv[cols]).astype(in_dtype)
    from ..formats.matrix import COO

    return COO.from_arrays(vals, rows, cols, (m, m)).to_csr()


def init_gcn(key: jax.Array, n_features: int, hidden: int, n_classes: int,
             dtype=jnp.float32) -> GCNParams:
    k1, k2 = jax.random.split(key)
    s1 = jnp.sqrt(2.0 / n_features).astype(dtype)
    s2 = jnp.sqrt(2.0 / hidden).astype(dtype)
    return GCNParams(
        w1=jax.random.normal(k1, (n_features, hidden), dtype) * s1,
        b1=jnp.zeros((hidden,), dtype),
        w2=jax.random.normal(k2, (hidden, n_classes), dtype) * s2,
        b2=jnp.zeros((n_classes,), dtype),
    )


def gcn_forward(params: GCNParams, spmm: Callable[[jax.Array], jax.Array],
                x: jax.Array) -> jax.Array:
    """Two-layer GCN: logits = Â relu(Â X W1 + b1) W2 + b2.

    Dense projections run first so the SpMM's fat vector has the *small*
    dimension (hidden/classes), keeping the gather traffic minimal — the
    k-ordering insight from the reference's own fat-vector-dimension sweep
    (``results/visualisation_fat_vector.ipynb``).
    """
    h = spmm(jnp.dot(x, params.w1, preferred_element_type=x.dtype))
    h = jax.nn.relu(h + params.b1)
    logits = spmm(jnp.dot(h, params.w2, preferred_element_type=x.dtype))
    return logits + params.b2


def gcn_loss(params: GCNParams, spmm, x, labels, mask) -> jax.Array:
    logits = gcn_forward(params, spmm, x)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    mask = mask.astype(losses.dtype)
    return jnp.sum(losses * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def make_train_step(spmm, optimizer: optax.GradientTransformation):
    """Returns ``step(params, opt_state, x, labels, mask) ->
    (params, opt_state, loss)`` — jit it (optionally with shardings)."""

    def step(params, opt_state, x, labels, mask):
        loss, grads = jax.value_and_grad(gcn_loss)(
            params, spmm, x, labels, mask
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def synthetic_node_classification(n: int, n_features: int, n_classes: int,
                                  avg_degree: int = 8, seed: int = 0,
                                  dtype=jnp.float32):
    """Deterministic synthetic graph task: communities with intra-community
    edges and class-correlated features. Returns (adjacency CSR, x, labels,
    train_mask)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    # Edges mostly within class (homophily) so the GCN can learn.
    n_edges = n * avg_degree // 2
    src = rng.integers(0, n, size=2 * n_edges)
    dst = rng.integers(0, n, size=2 * n_edges)
    same = labels[src] == labels[dst]
    keep = same | (rng.uniform(size=src.size) < 0.1)
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    vals = np.ones(rows.size)
    from ..io.mtx import expand_and_build_csr

    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    adj = expand_and_build_csr(
        rows[idx], cols[idx], vals[idx], n, n, symmetric=False
    )
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    x = centers[labels] + rng.normal(size=(n, n_features))
    mask = rng.uniform(size=n) < 0.7
    return (
        adj,
        jnp.asarray(x, dtype),
        jnp.asarray(labels, jnp.int32),
        jnp.asarray(mask),
    )
