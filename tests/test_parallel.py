"""Distributed strategy tests on an 8-virtual-device CPU mesh.

The differential-testing pattern of the reference (every parallel kernel vs
the sequential oracle on identical inputs, ``main.cpp:184,227,270``) run on
virtual devices — the capability the reference lacked (SURVEY.md §4.5: "no
single-process MPI test mode")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import generate_fat_vector, max_abs_error
from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, cage4_like, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_jax.parallel import (
    ColumnWise, Library, NonZeroElement, RowWise, Sequential, get_strategy,
    make_mesh,
)

MATRICES = {
    "cage4_like": lambda: cage4_like(),
    "random": lambda: random_csr(100, 80, 900, seed=21),
    "banded": lambda: banded_csr(120, 6, 5, seed=22),
    "powerlaw": lambda: powerlaw_csr(90, 90, 1500, seed=23),
    "tall": lambda: random_csr(200, 10, 400, seed=24),
    "wide": lambda: random_csr(10, 200, 400, seed=25),
}

STRATS = [
    RowWise(),
    ColumnWise(),
    NonZeroElement(),
    NonZeroElement(reduce="scatter"),
    Library(),
]


@pytest.fixture(scope="module")
def mesh(devices8=None):
    return make_mesh(8)


def _run(strategy, csr, k, mesh, gather=True, seed=31):
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=seed))
    operand = strategy.prepare(csr, mesh)
    out = strategy.spmm(operand, v, mesh, gather_result=gather)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    return out, oracle


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize(
    "strategy", STRATS, ids=lambda s: f"{s.name}-{getattr(s, 'reduce', '')}"
)
def test_strategy_matches_oracle(name, strategy, mesh):
    csr = MATRICES[name]()
    out, oracle = _run(strategy, csr, 12, mesh)
    assert out.shape == oracle.shape
    assert max_abs_error(out, oracle) < 1e-9


@pytest.mark.parametrize(
    "strategy", STRATS, ids=lambda s: f"{s.name}-{getattr(s, 'reduce', '')}"
)
def test_strategy_sharded_result(strategy, mesh):
    """gather_result=False leaves the output distributed but must still
    materialize to the oracle value (the PETSc leave-distributed mode)."""
    csr = MATRICES["random"]()
    out, oracle = _run(strategy, csr, 8, mesh, gather=False)
    assert max_abs_error(np.asarray(out), oracle) < 1e-9


@pytest.mark.parametrize("k", [1, 3, 5, 8, 12, 17])
def test_column_wise_k_not_divisible(k, mesh):
    """Reference gives remainder columns to the last rank
    (ColumnWise.cpp:28); we pad — either way any k must work, including
    k < p (the degenerate case of report line 1036)."""
    csr = MATRICES["random"]()
    out, oracle = _run(ColumnWise(), csr, k, mesh)
    assert max_abs_error(out, oracle) < 1e-9


@pytest.mark.parametrize("k", [1, 7])
def test_row_wise_rows_not_divisible(k, mesh):
    csr = random_csr(37, 29, 150, seed=26)  # 37 rows !% 8 devices
    out, oracle = _run(RowWise(), csr, k, mesh)
    assert max_abs_error(out, oracle) < 1e-9


def test_nnz_not_divisible(mesh):
    csr = random_csr(50, 50, 331, seed=27)  # nnz !% 8
    out, oracle = _run(NonZeroElement(), csr, 4, mesh)
    assert max_abs_error(out, oracle) < 1e-9


def test_sequential_oracle(mesh):
    csr = MATRICES["random"]()
    out, oracle = _run(Sequential(), csr, 6, mesh)
    assert max_abs_error(out, oracle) < 1e-9


def test_mesh_subset():
    """Strategies work on a mesh smaller than the device count (the
    reference's -np sweep, batch_test.sh:44-50)."""
    for p in (1, 2, 4):
        mesh = make_mesh(p)
        csr = random_csr(64, 64, 500, seed=28)
        out, oracle = _run(RowWise(), csr, 4, mesh)
        assert max_abs_error(out, oracle) < 1e-9


def test_get_strategy():
    assert isinstance(get_strategy("row"), RowWise)
    assert isinstance(get_strategy("nnz", reduce="scatter"), NonZeroElement)
    with pytest.raises(ValueError):
        get_strategy("bogus")


def test_all_strategies_agree(mesh):
    """Cross-validate all strategies against each other bit-for-bit-ish on
    the same operands (the reference prints one comparison per algorithm;
    main.cpp:166-280)."""
    csr = MATRICES["powerlaw"]()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 9, seed=33))
    results = {}
    for s in [Sequential(), RowWise(), ColumnWise(), NonZeroElement()]:
        operand = s.prepare(csr, mesh)
        results[s.name] = np.asarray(s.spmm(operand, v, mesh))
    base = results.pop("sequential")
    for name, r in results.items():
        assert max_abs_error(r, base) < 1e-9, name


def test_row_wise_skewed_tail(mesh):
    """A matrix with one near-dense row must spill into the COO tail, not
    inflate the ELL planes to m x max_row_nnz (the power-law OOM class)."""
    import numpy as np
    rng = np.random.default_rng(300)
    m = 64
    dense = np.zeros((m, m))
    # one heavy row + light rows
    dense[3, :] = rng.normal(size=m)
    light = rng.uniform(size=(m, m)) < 0.05
    dense += np.where(light, rng.normal(size=(m, m)), 0.0)
    from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR as _CSR
    csr = _CSR.from_dense(dense)
    strat = RowWise()
    operand = strat.prepare(csr, mesh)
    assert operand.tail_values.shape[0] > 0           # tail engaged
    assert operand.cols.shape[1] < m                  # width capped
    out, oracle = _run(strat, csr, 5, mesh)
    assert max_abs_error(out, oracle) < 1e-9
    out, oracle = _run(strat, csr, 5, mesh, gather=False)
    assert max_abs_error(np.asarray(out), oracle) < 1e-9


def test_grid2d_skewed_tail():
    import numpy as np
    from sparsematrixmultiplicationmpi_jax.parallel import Grid2D, make_mesh_2d
    rng = np.random.default_rng(301)
    m = 48
    dense = np.zeros((m, m))
    dense[7, :] = rng.normal(size=m)
    light = rng.uniform(size=(m, m)) < 0.08
    dense += np.where(light, rng.normal(size=(m, m)), 0.0)
    from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR as _CSR
    csr = _CSR.from_dense(dense)
    mesh2 = make_mesh_2d(4, 2)
    strat = Grid2D()
    operand = strat.prepare(csr, mesh2)
    assert operand.tail_values.shape[0] > 0
    import jax.numpy as jnp
    v = jnp.asarray(generate_fat_vector(m, 6, seed=302))
    out = strat.spmm(operand, v, mesh2)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert max_abs_error(out, oracle) < 1e-9


def test_auto_multidevice_dispatch(mesh):
    """Auto on a multi-device mesh: banded matrices get the halo strategy,
    scattered matrices the hybrid row-wise; both match the oracle.

    Routing is by the single-device cost model (it replaced an
    unmeasured coverage >= 0.5 gate). The band here is mid-sized: at
    toy scale (the old 128-row band) the banded format's own inflation
    gate refuses dense-band storage, so the model correctly routes
    tiny bands to windowed tiles instead."""
    from sparsematrixmultiplicationmpi_jax.parallel import Auto
    from sparsematrixmultiplicationmpi_jax.parallel.banded_strategy import (
        BandedRowOperand,
    )
    from sparsematrixmultiplicationmpi_jax.parallel.strategies import (
        HybridRowOperand,
    )

    auto = Auto()
    band = banded_csr(2048, 20, 12, seed=310)
    op = auto.prepare(band, mesh)
    assert isinstance(op, BandedRowOperand)
    out, oracle = _run(auto, band, 4, mesh)
    assert max_abs_error(out, oracle) < 1e-9

    # Diffuse at scale: dense tiles can't clear the per-tile occupancy
    # threshold, so the gather-class hybrid wins. (At toy scale —
    # the old 1000x1000/6000 — the model routes to windowed: streaming
    # a few dense MB beats thousands of per-row gathers in the model.)
    scattered = random_csr(4000, 4000, 24000, seed=311)
    op2 = auto.prepare(scattered, mesh)
    assert isinstance(op2, HybridRowOperand)
    out, oracle = _run(auto, scattered, 4, mesh)
    assert max_abs_error(out, oracle) < 1e-9


def test_bf16_through_strategies(mesh):
    """bf16 values flow through the distributed strategies (the
    half-bandwidth production dtype), with bf16-scale accuracy vs the f64
    oracle."""
    csr = banded_csr(96, 4, 3, seed=320).astype(jnp.bfloat16)
    v = jnp.asarray(generate_fat_vector(96, 4, seed=321), jnp.bfloat16)
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64

    oracle = spmm_host_f64(csr, np.asarray(v, np.float64))
    scale = max(float(np.max(np.abs(oracle))), 1.0)
    for strat in (RowWise(), NonZeroElement()):
        operand = strat.prepare(csr, mesh)
        out = np.asarray(
            strat.spmm(operand, v, mesh), np.float64
        )
        rel = float(np.max(np.abs(out - oracle))) / scale
        assert rel < 5e-2, (strat.name, rel)
