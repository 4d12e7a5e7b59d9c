"""Distributed banded strategy + RCM reordering tests (8-device CPU mesh)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import CSR, generate_fat_vector, max_abs_error
from sparsematrixmultiplicationmpi_jax.formats.reorder import (
    apply_symmetric_permutation, bandwidth, rcm_ordering,
)
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, cop20k_like, random_csr,
)
from sparsematrixmultiplicationmpi_jax.parallel import (
    BandedRowWise, get_strategy, make_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _check(strategy, csr, k, mesh, gather=True, tol=1e-9, seed=101):
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=seed))
    operand = strategy.prepare(csr, mesh)
    out = strategy.spmm(operand, v, mesh, gather_result=gather)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert out.shape == oracle.shape
    assert max_abs_error(np.asarray(out), oracle) < tol


def test_pure_band_no_spill(mesh):
    csr = banded_csr(256, 6, 5, seed=102)
    strat = BandedRowWise(block_rows=8)
    operand = strat.prepare(csr, mesh)
    assert operand.spill_cols is None
    _check(strat, csr, 7, mesh)


def test_band_with_spill(mesh):
    b = banded_csr(200, 5, 4, seed=103)
    r = random_csr(200, 200, 300, seed=104)
    csr = CSR.from_dense(np.asarray(b.to_dense()) + np.asarray(r.to_dense()))
    strat = BandedRowWise(block_rows=8)
    operand = strat.prepare(csr, mesh)
    assert operand.spill_cols is not None
    _check(strat, csr, 5, mesh)


def test_sharded_result(mesh):
    csr = banded_csr(192, 4, 3, seed=105)
    _check(BandedRowWise(block_rows=8), csr, 4, mesh, gather=False)


def test_blocks_not_divisible_by_mesh(mesh):
    # 37 rows, r=8 -> 5 blocks, padded to 8 across the mesh.
    csr = banded_csr(37, 3, 2, seed=106)
    _check(BandedRowWise(block_rows=8), csr, 3, mesh)


def test_cop20k_small_on_mesh(mesh):
    csr = cop20k_like(scale=0.02, seed=107)
    _check(BandedRowWise(), csr, 6, mesh, tol=1e-8)


def test_rejects_non_square(mesh):
    csr = random_csr(40, 30, 100, seed=108)
    with pytest.raises(ValueError):
        BandedRowWise(block_rows=8).prepare(csr, mesh)


def test_registered(mesh):
    assert isinstance(get_strategy("banded_row"), BandedRowWise)


def test_small_mesh():
    mesh1 = make_mesh(1)
    csr = banded_csr(64, 5, 4, seed=109)
    _check(BandedRowWise(block_rows=8), csr, 4, mesh1)


# ---- RCM reordering ----------------------------------------------------

def test_rcm_reduces_bandwidth():
    # A banded matrix scrambled by a random permutation: RCM should recover
    # a bandwidth near the original.
    rng = np.random.default_rng(110)
    csr = banded_csr(300, 8, 5, seed=111)
    scramble = rng.permutation(300)
    scrambled = apply_symmetric_permutation(csr, scramble)
    assert bandwidth(scrambled) > 100  # scrambled far off-diagonal
    perm = rcm_ordering(scrambled)
    restored = apply_symmetric_permutation(scrambled, perm)
    assert bandwidth(restored) < 64
    assert restored.nnz == csr.nnz


def test_rcm_permutation_is_valid():
    csr = random_csr(120, 120, 700, seed=112)
    perm = rcm_ordering(csr)
    assert sorted(perm.tolist()) == list(range(120))


def test_symmetric_permutation_spmm_equivalence():
    """y = A x must equal unpermute(A' x') with x' = x[perm]."""
    csr = banded_csr(100, 6, 4, seed=113)
    rng = np.random.default_rng(114)
    perm = rng.permutation(100)
    ap = apply_symmetric_permutation(csr, perm)
    x = np.asarray(generate_fat_vector(100, 3, seed=115))
    y = np.asarray(csr.to_dense()) @ x
    yp = np.asarray(ap.to_dense()) @ x[perm]
    inv = np.empty(100, dtype=int)
    inv[np.arange(100)] = np.arange(100)
    np.testing.assert_allclose(yp, y[perm], atol=1e-9)


def test_banded_row_wise_skewed_spill_tail():
    """A power-law spill must not inflate the ELL planes to m x max_row
    (observed 7 GB OOM pre-fix); overflow rides the nnz-sharded COO tail
    and the result stays correct."""
    from sparsematrixmultiplicationmpi_jax.io.generate import powerlaw_csr

    csr = powerlaw_csr(4000, 4000, 40000, seed=171)
    mesh = make_mesh(4)
    strat = BandedRowWise(block_rows=64)
    operand = strat.prepare(csr, mesh)
    if operand.spill_cols is not None:
        W = operand.spill_cols.shape[1]
        max_row = int(csr.row_lengths().max())
        assert W < max_row, (W, max_row)
        assert operand.tail_values is not None
    v = jnp.asarray(generate_fat_vector(4000, 5, seed=172))
    out = np.asarray(strat.spmm(operand, v, mesh))
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64

    oracle = spmm_host_f64(csr, np.asarray(v))
    np.testing.assert_allclose(out, oracle, atol=1e-8)
