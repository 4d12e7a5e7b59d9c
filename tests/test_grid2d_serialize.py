"""Grid2D strategy, format persistence, and distributed-model integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import (
    BucketedELL, CSR, generate_fat_vector, max_abs_error, spmm_bucketed,
)
from sparsematrixmultiplicationmpi_jax.formats.banded import BandedBlocks
from sparsematrixmultiplicationmpi_jax.formats.serialize import (
    load_format, save_format,
)
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_jax.models import (
    conjugate_gradient, pagerank,
)
from sparsematrixmultiplicationmpi_jax.models.pagerank import (
    _normalize_columns,
)
from sparsematrixmultiplicationmpi_jax.parallel import (
    BandedRowWise, Grid2D, RowWise, get_strategy, make_mesh, make_mesh_2d,
)


# ---- Grid2D ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_grid2d_matches_oracle(shape):
    mesh = make_mesh_2d(*shape)
    csr = random_csr(96, 70, 800, seed=141)
    v = jnp.asarray(generate_fat_vector(70, 12, seed=142))
    strat = Grid2D()
    operand = strat.prepare(csr, mesh)
    out = strat.spmm(operand, v, mesh)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert out.shape == oracle.shape
    assert max_abs_error(out, oracle) < 1e-9


def test_grid2d_sharded_result():
    mesh = make_mesh_2d(4, 2)
    csr = random_csr(64, 64, 500, seed=143)
    v = jnp.asarray(generate_fat_vector(64, 8, seed=144))
    strat = Grid2D()
    out = strat.spmm(strat.prepare(csr, mesh), v, mesh, gather_result=False)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert max_abs_error(np.asarray(out), oracle) < 1e-9


def test_grid2d_rejects_1d_mesh():
    mesh = make_mesh(4)
    with pytest.raises(ValueError):
        Grid2D().prepare(random_csr(16, 16, 50, seed=145), mesh)


def test_grid2d_registered():
    assert isinstance(get_strategy("grid2d"), Grid2D)


# ---- Format persistence ------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda csr: csr,
    lambda csr: csr.to_coo(),
    lambda csr: BucketedELL.from_csr(csr),
])
def test_save_load_round_trip(tmp_path, build):
    csr = powerlaw_csr(80, 80, 900, seed=146)
    obj = build(csr)
    path = str(tmp_path / "fmt.npz")
    save_format(path, obj)
    back = load_format(path)
    assert type(back) is type(obj)
    assert max_abs_error(back.to_dense(), obj.to_dense()) == 0.0


def test_save_load_banded_with_spill(tmp_path):
    b = banded_csr(100, 5, 4, seed=147)
    r = random_csr(100, 100, 150, seed=148)
    csr = CSR.from_dense(np.asarray(b.to_dense()) + np.asarray(r.to_dense()))
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    assert bb.spill is not None
    path = str(tmp_path / "bb.npz")
    save_format(path, bb)
    back = load_format(path)
    assert back.block_rows == bb.block_rows
    assert max_abs_error(back.to_dense(), csr.to_dense()) < 1e-12


def test_save_load_banded_no_spill(tmp_path):
    csr = banded_csr(64, 4, 3, seed=149)
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    assert bb.spill is None
    path = str(tmp_path / "bb2.npz")
    save_format(path, bb)
    back = load_format(path)
    assert back.spill is None
    assert max_abs_error(back.to_dense(), csr.to_dense()) == 0.0


# ---- Distributed models ------------------------------------------------

def test_cg_with_distributed_spmm():
    """CG solve where every matvec is a mesh-distributed banded SpMM."""
    mesh = make_mesh(8)
    d = np.asarray(banded_csr(96, 3, 3, seed=150).to_dense())
    spd = d @ d.T + 8 * np.eye(96)
    csr = CSR.from_dense(spd)
    strat = BandedRowWise(block_rows=8)
    operand = strat.prepare(csr, mesh)
    spmm = lambda x: strat.spmm(operand, x, mesh)
    b = np.random.default_rng(151).normal(size=(96, 2))
    res = conjugate_gradient(spmm, jnp.asarray(b), tol=1e-12)
    np.testing.assert_allclose(
        np.asarray(res.x), np.linalg.solve(spd, b), atol=1e-6
    )


def test_pagerank_with_distributed_spmm():
    mesh = make_mesh(4)
    csr = random_csr(60, 60, 500, seed=152)
    import dataclasses

    csr = dataclasses.replace(csr, values=np.abs(np.asarray(csr.values)))
    norm = _normalize_columns(csr)
    strat = RowWise()
    operand = strat.prepare(norm, mesh)
    ranks, iters = pagerank(
        lambda x: strat.spmm(operand, x, mesh), 60, tol=1e-10
    )
    # Compare against the single-device path.
    bell = BucketedELL.from_csr(norm)
    ranks_ref, _ = pagerank(lambda x: spmm_bucketed(bell, x), 60, tol=1e-10)
    np.testing.assert_allclose(
        np.asarray(ranks), np.asarray(ranks_ref), atol=1e-8
    )
