"""Format container tests: CSR/COO/ELL/BucketedELL round trips and pytrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import (
    CSR, COO, ELL, BucketedELL, max_abs_error,
)
from sparsematrixmultiplicationmpi_jax.io.generate import (
    powerlaw_csr, random_csr,
)


def _rand_dense(rng, m, n, density=0.2):
    d = rng.uniform(-1, 1, size=(m, n))
    mask = rng.uniform(size=(m, n)) < density
    return np.where(mask, d, 0.0)


def test_csr_dense_round_trip(rng):
    dense = _rand_dense(rng, 23, 17)
    csr = CSR.from_dense(dense)
    assert csr.shape == (23, 17)
    assert max_abs_error(csr.to_dense(), dense) == 0.0


def test_csr_coo_round_trip(rng):
    dense = _rand_dense(rng, 11, 31)
    csr = CSR.from_dense(dense)
    coo = csr.to_coo()
    assert coo.nnz == csr.nnz
    assert max_abs_error(coo.to_dense(), dense) == 0.0
    csr2 = coo.to_csr()
    assert max_abs_error(csr2.to_dense(), dense) == 0.0
    np.testing.assert_array_equal(csr2.row_ptr, csr.row_ptr)
    np.testing.assert_array_equal(csr2.col_indices, csr.col_indices)


def test_coo_sorted_by_row(rng):
    csr = random_csr(40, 40, 200, seed=5)
    coo = csr.to_coo()
    rows = np.asarray(coo.row_indices)
    assert np.all(np.diff(rows) >= 0)


def test_coo_pad(rng):
    csr = random_csr(10, 10, 30, seed=1)
    coo = csr.to_coo()
    padded = coo.pad_to(coo.nnz + 13)
    assert padded.nnz == coo.nnz + 13
    assert max_abs_error(padded.to_dense(), coo.to_dense()) == 0.0
    with pytest.raises(ValueError):
        coo.pad_to(coo.nnz - 1)


def test_ell_round_trip(rng):
    dense = _rand_dense(rng, 13, 29)
    csr = CSR.from_dense(dense)
    ell = ELL.from_csr(csr)
    assert ell.m_padded % 8 == 0
    assert max_abs_error(ell.to_dense(), dense) == 0.0


def test_ell_width_align(rng):
    csr = random_csr(9, 9, 20, seed=2)
    ell = ELL.from_csr(csr, width_align=128)
    assert ell.width == 128
    assert max_abs_error(ell.to_dense(), csr.to_dense()) == 0.0


def test_ell_width_too_small(rng):
    dense = np.ones((4, 6))
    csr = CSR.from_dense(dense)
    with pytest.raises(ValueError):
        ELL.from_csr(csr, width=3)


def test_bucketed_ell_round_trip_uniform(rng):
    csr = random_csr(64, 64, 600, seed=3)
    bell = BucketedELL.from_csr(csr)
    assert max_abs_error(bell.to_dense(), csr.to_dense()) == 0.0


def test_bucketed_ell_round_trip_skewed(rng):
    csr = powerlaw_csr(300, 300, 4000, seed=4)
    bell = BucketedELL.from_csr(csr)
    assert max_abs_error(bell.to_dense(), csr.to_dense()) == 0.0
    # Bucketing must bound padding waste well below single-width ELL.
    padded = sum(b.m_padded * b.width for b in bell.buckets)
    single = ELL.from_csr(csr)
    assert padded < single.m_padded * single.width


def test_bucketed_ell_perm_is_permutation(rng):
    csr = powerlaw_csr(100, 100, 900, seed=6)
    bell = BucketedELL.from_csr(csr)
    m = csr.shape[0]
    lengths = csr.row_lengths()
    perm = np.asarray(bell.row_perm)
    real = perm[perm < m]
    # Every NON-EMPTY row appears exactly once; empty rows are dropped
    # (they would otherwise pad the narrowest bucket — the round-2 spill
    # slot-inflation fix) and route to the appended zero row instead.
    nonempty = np.nonzero(lengths > 0)[0]
    assert sorted(real.tolist()) == nonempty.tolist()
    inv = np.asarray(bell.inv_row_perm)
    np.testing.assert_array_equal(perm[inv[nonempty]], nonempty)
    empty = np.nonzero(lengths == 0)[0]
    assert (inv[empty] == len(perm)).all()


def test_pytree_jit(rng):
    """Containers must traverse jit as pytrees with static shapes."""
    csr = random_csr(16, 16, 60, seed=7)

    @jax.jit
    def row_sums(c: CSR):
        m, _ = c.shape  # static inside trace
        return jax.ops.segment_sum(
            c.values,
            jnp.repeat(
                jnp.arange(m), jnp.diff(c.row_ptr), total_repeat_length=c.nnz
            ),
            num_segments=m,
        )

    out = row_sums(csr)
    expected = np.asarray(csr.to_dense()).sum(axis=1)
    assert max_abs_error(out, expected) < 1e-12


def test_astype(rng):
    csr = random_csr(8, 8, 20, seed=8)
    f32 = csr.astype(jnp.float32)
    assert f32.values.dtype == jnp.float32
    assert f32.col_indices.dtype == jnp.int32


def test_duplicate_coordinates_sum_in_densifying_formats():
    """CSR tolerates duplicate (row, col) entries (the oracle and every
    gather path SUM them — matching to_dense); densifying builds
    (windowed tiles, banded blocks) scatter by assignment and must
    coalesce first or silently drop values."""
    import numpy as np
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.formats.banded import (
        BandedBlocks,
    )
    from sparsematrixmultiplicationmpi_jax.formats.matrix import COO
    from sparsematrixmultiplicationmpi_jax.formats.windowed import (
        WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_jax.io.generate import (
        banded_csr, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64

    base = banded_csr(256, 10, 4, seed=31).astype(np.float32)
    coo = base.to_coo()
    i = np.asarray(coo.row_indices)
    j = np.asarray(coo.col_indices)
    v = np.asarray(coo.values)
    # duplicate the first 50 entries with different values
    dup = COO.from_arrays(
        np.concatenate([v, 10.0 + v[:50]]),
        np.concatenate([i, i[:50]]),
        np.concatenate([j, j[:50]]), base.shape,
    ).to_csr()
    vec = jnp.asarray(generate_fat_vector(dup.shape[1], 4, seed=32),
                      jnp.float32)
    oracle = spmm_host_f64(dup, vec)
    scale = np.abs(oracle).max()

    wp = WindowedPairs.from_csr(dup, block_rows=16, chunk_cols=128,
                                beat_gather_margin=1e9,
                                max_inflation=1e9)
    out_w = np.asarray(wp @ vec)
    assert np.abs(out_w - oracle).max() / scale < 5e-3

    bb = BandedBlocks.from_csr(dup, block_rows=16)
    out_b = np.asarray(bb @ vec)
    assert np.abs(out_b - oracle).max() / scale < 5e-3

    from sparsematrixmultiplicationmpi_jax.parallel import make_mesh
    from sparsematrixmultiplicationmpi_jax.parallel.windowed_strategy \
        import WindowedRowWise

    mesh = make_mesh(2)
    strat = WindowedRowWise(block_rows=16, chunk_cols=128)
    op = strat.prepare(dup, mesh)
    out_s = np.asarray(strat.spmm(op, vec, mesh))
    assert np.abs(out_s - oracle).max() / scale < 5e-3
