"""Compiled-HLO audits of each strategy's communication structure.

Guards the claims in docs/DEPLOY.md (O(r*k)-per-link halo exchange for the
banded strategy) at the program level: the collectives XLA actually emits,
not what the docstrings promise. Runs on the 8-virtual-device CPU mesh.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, generate_fat_vector, random_csr,
)
from sparsematrixmultiplicationmpi_jax.parallel import (
    NonZeroElement, RowWise, make_mesh,
)
from sparsematrixmultiplicationmpi_jax.parallel.banded_strategy import (
    BandedRowWise,
)
from sparsematrixmultiplicationmpi_jax.utils.collectives import (
    collective_stats, compiled_hlo,
)


def _hlo(strategy, csr, mesh, k=4, gather_result=False):
    operand = strategy.prepare(csr, mesh)
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=5))
    return compiled_hlo(
        lambda op, vv: strategy.spmm(op, vv, mesh,
                                     gather_result=gather_result),
        operand, v,
    )


def test_banded_row_wise_is_ppermute_only():
    """No spill: the ONLY collective must be the neighbor halo exchange
    (collective-permute). An all-gather here would falsify the O(r*k)
    per-link scaling claim (docs/DEPLOY.md)."""
    csr = banded_csr(2048, 60, 8, seed=1)
    mesh = make_mesh(8)
    strat = BandedRowWise(block_rows=64)
    operand = strat.prepare(csr, mesh)
    assert operand.spill_cols is None, "fixture must be fully banded"
    hlo = _hlo(strat, csr, mesh, gather_result=False)
    stats = collective_stats(hlo)
    assert "collective-permute" in stats
    assert "all-gather" not in stats
    assert "all-reduce" not in stats
    assert "reduce-scatter" not in stats
    # Halo payload: 2 permutes of one (r, k) edge block each.
    count, nbytes = stats["collective-permute"]
    r, k = 64, 4
    assert nbytes <= 2 * 2 * r * k * 8  # generous: <= 2x the two edges


def test_banded_row_wise_spill_adds_one_all_gather():
    csr = banded_csr(2048, 60, 8, seed=2)
    # Inject off-band entries to force a spill.
    import numpy as np

    from sparsematrixmultiplicationmpi_jax.formats.matrix import COO

    coo = csr.to_coo()
    rng = np.random.default_rng(3)
    extra = 200
    rows = rng.integers(0, 2048, extra)
    cols = (rows + 1024) % 2048
    coo2 = COO.from_arrays(
        np.concatenate([np.asarray(coo.values), rng.uniform(-1, 1, extra)]),
        np.concatenate([np.asarray(coo.row_indices), rows]),
        np.concatenate([np.asarray(coo.col_indices), cols]),
        (2048, 2048),
    )
    csr2 = coo2.to_csr()
    mesh = make_mesh(8)
    strat = BandedRowWise(block_rows=64)
    operand = strat.prepare(csr2, mesh)
    assert operand.spill_cols is not None
    hlo = _hlo(strat, csr2, mesh, gather_result=False)
    stats = collective_stats(hlo)
    assert "collective-permute" in stats
    assert stats.get("all-gather", (0, 0))[0] >= 1  # the fat-vector gather
    assert "all-reduce" not in stats


def test_nnz_psum_lowers_to_all_reduce():
    csr = random_csr(256, 256, 2000, seed=4)
    mesh = make_mesh(8)
    hlo = _hlo(NonZeroElement(reduce="psum"), csr, mesh,
               gather_result=False)
    stats = collective_stats(hlo)
    assert "all-reduce" in stats


def test_nnz_scatter_lowers_to_reduce_scatter():
    csr = random_csr(256, 256, 2000, seed=5)
    mesh = make_mesh(8)
    hlo = _hlo(NonZeroElement(reduce="scatter"), csr, mesh,
               gather_result=False)
    stats = collective_stats(hlo)
    assert "reduce-scatter" in stats
    # The scatter variant exists precisely to avoid the O(m*k) all-reduce
    # (the reference defect, NonZeroElement.cpp:88).
    assert "all-reduce" not in stats


def test_row_wise_gather_lowers_to_all_gather():
    csr = random_csr(256, 256, 2000, seed=6)
    mesh = make_mesh(8)
    hlo = _hlo(RowWise(), csr, mesh, gather_result=True)
    stats = collective_stats(hlo)
    assert "all-gather" in stats


def test_row_wise_ungathered_moves_fewer_bytes():
    """Leaving the result sharded must strictly reduce collective bytes —
    the PETSc never-regather lesson, now program-verified."""
    csr = random_csr(512, 512, 4000, seed=7)
    mesh = make_mesh(8)
    strat = RowWise()

    def total_bytes(gather):
        hlo = _hlo(strat, csr, mesh, k=8, gather_result=gather)
        return sum(b for _, b in collective_stats(hlo).values())

    assert total_bytes(False) < total_bytes(True)


def test_collective_stats_counts_tuple_result_ops():
    """XLA's collective-combiner merges several all-gathers into one
    variadic op with a tuple result type; the byte audit must sum every
    tuple element, not stop at the tuple's opening parenthesis
    (ADVICE r2 #4 — the old parser counted 0 bytes for these)."""
    hlo = (
        "  %ag = (f32[16,8]{1,0}, f32[4,2]{1,0}) "
        "all-gather(f32[2,8] %a, f32[1,2] %b), replica_groups={}\n"
        "  %ar.1 = f32[8]{0} all-reduce(f32[8] %x), to_apply=%sum\n"
    )
    stats = collective_stats(hlo)
    assert stats["all-gather"] == (1, 16 * 8 * 4 + 4 * 2 * 4)
    assert stats["all-reduce"] == (1, 8 * 4)
