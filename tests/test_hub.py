"""Hub-column extraction hybrid (formats/hub.py, ops/auto.py hub
candidate) — the dc1 circuit-class path (VERDICT r4 next #5).
Differential vs the host f64 oracle per repo convention.
"""

import numpy as np

import jax
import jax.numpy as jnp

from sparsematrixmultiplicationmpi_jax.formats.hub import (
    HubExtracted, split_hub_columns,
)
from sparsematrixmultiplicationmpi_jax.io.generate import (
    dc1_like, generate_fat_vector, random_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64


def test_split_hub_columns_roundtrip():
    csr = dc1_like(scale=0.02).astype(np.float32)
    m, n = csr.shape
    counts = np.zeros(n, np.int64)
    coo = csr.to_coo()
    np.add.at(counts, np.asarray(coo.col_indices), 1)
    thr = int(counts.max() // 2) or 1
    split = split_hub_columns(csr, threshold=thr)
    assert split is not None
    ids, dense, rem = split
    assert (np.diff(ids) > 0).all()
    assert dense.shape == (m, len(ids))
    # extracted + remainder reconstruct the matrix exactly
    full = np.asarray(csr.to_dense())
    rec = np.array(rem.to_dense())
    rec[:, ids] += dense
    np.testing.assert_array_equal(rec, full)
    # extracted columns really were the dense ones
    assert (counts[ids] >= thr).all()


def test_split_returns_none_without_hubs():
    csr = random_csr(500, 500, 3000, seed=1).astype(np.float32)
    assert split_hub_columns(csr, threshold=400) is None


def test_auto_routes_dc1_to_hub_hybrid():
    # allow_hub is opt-in: measured on hardware the hybrid LOSES on dc1
    # (0.83x/0.94x, results/hub_dc1.json) -- this test covers the
    # opt-in path's correctness, not the default route.
    csr = dc1_like(scale=0.02).astype(np.float32)
    op = auto_format(csr, allow_hub=True)
    assert isinstance(op, HubExtracted), type(op)
    assert 1 <= op.n_hubs <= 64
    v = np.asarray(generate_fat_vector(csr.shape[1], 8, seed=2),
                   np.float32)
    out = np.asarray(spmm_any(op, jnp.asarray(v)), np.float64)
    ref = spmm_host_f64(csr, v)
    scale = float(np.abs(ref).max()) or 1.0
    assert float(np.abs(out - ref).max()) / scale < 5e-3


def test_hub_hybrid_under_jit_and_device_put():
    csr = dc1_like(scale=0.02).astype(np.float32)
    op = auto_format(csr, allow_hub=True)
    assert isinstance(op, HubExtracted)
    op = jax.device_put(op)  # pytree registration round-trip
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 4, seed=3),
                    np.float32)
    out = jax.jit(spmm_any)(op, v)
    ref = spmm_host_f64(csr, np.asarray(v))
    scale = float(np.abs(ref).max()) or 1.0
    assert float(np.abs(np.asarray(out, np.float64) - ref).max()) \
        / scale < 5e-3


def test_hub_astype_and_bf16_path():
    csr = dc1_like(scale=0.02).astype(np.float32)
    op = auto_format(csr, allow_hub=True)
    assert isinstance(op, HubExtracted)
    opb = op.astype(jnp.bfloat16)
    v = np.asarray(generate_fat_vector(csr.shape[1], 4, seed=4),
                   np.float32)
    out = np.asarray(spmm_any(opb, jnp.asarray(v, jnp.bfloat16)),
                     np.float64)
    ref = spmm_host_f64(csr, v)
    scale = float(np.abs(ref).max()) or 1.0
    assert float(np.abs(out - ref).max()) / scale < 5e-2


def test_uniform_matrix_does_not_pay_hub_candidate():
    csr = random_csr(2000, 2000, 20000, seed=5).astype(np.float32)
    op = auto_format(csr, allow_hub=True)
    assert not isinstance(op, HubExtracted)


def test_hub_off_by_default():
    # Default routing never builds HubExtracted: the hybrid measured a
    # LOSS on its target class (results/hub_dc1.json).
    csr = dc1_like(scale=0.02).astype(np.float32)
    op = auto_format(csr)
    assert not isinstance(op, HubExtracted)
