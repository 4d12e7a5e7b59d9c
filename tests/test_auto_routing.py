"""Auto format-routing regressions — each case pins a routing outcome
of the cost model (its constants were fitted before the GPU port and
wait for the refit, ROADMAP Speed #6):

* pure-band matrices -> BandedBlocks (2.7x fewer bytes than windowed
  tiles; auto picking windowed here measured 1.5x slower CG iterations),
* FEM-mesh matrices -> WindowedPairs,
* mild-skew graphs at large k -> BucketedELL (COO measured 2.3x slower
  at k=128: the segment-sum costs ~11.5 ns/nnz),
* heavy-skew graphs where ELL slot inflation explodes and tiles don't
  apply -> COO.
"""

import numpy as np
import jax.numpy as jnp

from sparsematrixmultiplicationmpi_jax.formats.banded import BandedBlocks
from sparsematrixmultiplicationmpi_jax.formats.matrix import COO, BucketedELL
from sparsematrixmultiplicationmpi_jax.formats.windowed import WindowedPairs
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector, powerlaw_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64


def _check(operand, csr, k=3):
    v = generate_fat_vector(csr.shape[1], k, seed=5)
    got = np.asarray(spmm_any(operand, jnp.asarray(
        v, dtype=np.asarray(csr.values).dtype)), np.float64)
    oracle = spmm_host_f64(csr, v)
    scale = np.abs(oracle).max() + 1e-30
    assert np.max(np.abs(got - oracle)) / scale < 5e-5


def test_pure_band_routes_to_banded():
    csr = banded_csr(20_000, 60, 12, seed=2).astype(jnp.float32)
    f = auto_format(csr, k_nominal=8)
    assert isinstance(f, BandedBlocks), type(f)
    assert f.est_seconds < np.inf
    _check(f, csr)


def test_fem_mesh_routes_to_windowed():
    csr = fem3d_csr(20_000, 420_000, seed=3).astype(jnp.float32)
    f = auto_format(csr, k_nominal=32)
    assert isinstance(f, WindowedPairs), type(f)
    _check(f, csr)


def test_mild_skew_large_k_routes_to_bucketed_ell():
    # avg degree ~6, mild skew (the GCN-graph class), uniform scatter so
    # tiles cannot win.
    rng = np.random.default_rng(7)
    m, deg = 30_000, 6
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, size=m * deg)
    vals = rng.uniform(0.5, 1.5, size=m * deg).astype(np.float32)
    csr = COO.from_arrays(vals, rows, cols, (m, m)).to_csr()
    f = auto_format(csr, k_nominal=128)
    assert isinstance(f, BucketedELL), type(f)
    _check(f, csr)


def test_heavy_skew_small_k_routes_to_coo():
    # Power-law WITHOUT tileable clustering: shuffle the column space so
    # RCM cannot cluster the hubs into dense tiles.
    csr0 = powerlaw_csr(30_000, 30_000, 240_000, seed=9)
    coo = csr0.to_coo()
    rng = np.random.default_rng(10)
    perm = rng.permutation(30_000)
    csr = COO.from_arrays(
        np.asarray(coo.values, np.float32),
        perm[np.asarray(coo.row_indices)],
        perm[np.asarray(coo.col_indices)][::-1].copy(),
        (30_000, 30_000)).to_csr()
    f = auto_format(csr, k_nominal=1)
    assert isinstance(f, (COO, BucketedELL, WindowedPairs)), type(f)
    if isinstance(f, (COO, BucketedELL)):
        _check(f, csr)


def test_auto_routes_diffuse_planar_to_windowed():
    """Roadnet-class routing: auto's windowed build gate must compare
    against the caller's REAL gather estimate, and the inflation RATIO
    must not veto small-byte builds."""
    import numpy as np

    from sparsematrixmultiplicationmpi_jax.formats.windowed import (
        WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_jax.io.generate import roadnet_like
    from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format

    csr = roadnet_like(scale=0.1).astype(np.float32)
    op = auto_format(csr, k_nominal=6)
    assert isinstance(op, WindowedPairs), type(op).__name__


def test_spill_majority_guard_refuses_mixed_band_scatter():
    """Spill-majority guard: a banded base + 75 % uniform off-band
    entries drives the windowed split to ~74 % spill, where the built
    format is the wrong class. The auto-search must refuse such tilings
    (SPILL_FRAC_REFUSE); a caller pinning block_rows still gets an
    explicit build."""
    import scipy.sparse as sp

    from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR

    base = banded_csr(30_000, 150, 12, seed=75)
    rnd_nnz = int(base.nnz * 0.75 / 0.25)
    from sparsematrixmultiplicationmpi_jax.io.generate import random_csr

    rnd = random_csr(30_000, 30_000, rnd_nnz, seed=76)
    a = sp.csr_matrix((np.asarray(base.values),
                       np.asarray(base.col_indices),
                       np.asarray(base.row_ptr)), shape=base.shape)
    b = sp.csr_matrix((np.asarray(rnd.values),
                       np.asarray(rnd.col_indices),
                       np.asarray(rnd.row_ptr)), shape=rnd.shape)
    s = (a + b).tocsr()
    csr = CSR.from_arrays(s.data, s.indices, s.indptr,
                          base.shape).astype(np.float32)

    op = auto_format(csr, k_nominal=32)
    assert not isinstance(op, WindowedPairs), type(op).__name__

    # Pinned build bypasses the guard (spill-path tests need it); the
    # beat-gather margin must also be waived — an explicit build is a
    # request, not a routing decision.
    pinned = WindowedPairs.from_csr(csr, k_nominal=32, block_rows=128,
                                    beat_gather_margin=np.inf)
    assert pinned is not None
    _check(pinned, csr, k=8)
