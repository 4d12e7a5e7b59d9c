"""Randomized cross-format/cross-kernel consistency sweep.

20 random matrices spanning shapes, densities, and skews; every format
round-trips and every single-device kernel matches the host f64 oracle.
The breadth net the reference's fixture-based testing lacked.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import (
    BucketedELL, ELL, generate_fat_vector, max_abs_error,
    spmm_bucketed, spmm_ell, spmm_sequential,
)
from sparsematrixmultiplicationmpi_jax.formats.banded import BandedBlocks
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.banded import spmm_banded
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64


def _random_case(seed):
    rng = np.random.default_rng(seed)
    kind = rng.choice(["random", "banded", "powerlaw", "rect"])
    if kind == "random":
        m = n = int(rng.integers(10, 300))
        return random_csr(m, n, int(rng.integers(1, 8) * m), seed=seed)
    if kind == "banded":
        m = int(rng.integers(16, 400))
        return banded_csr(m, int(rng.integers(1, 12)),
                          int(rng.integers(1, 9)), seed=seed)
    if kind == "powerlaw":
        m = n = int(rng.integers(30, 250))
        return powerlaw_csr(m, n, int(rng.integers(4, 20) * m), seed=seed)
    m, n = int(rng.integers(5, 200)), int(rng.integers(5, 200))
    return random_csr(m, n, int(rng.integers(10, 4 * min(m, n))), seed=seed)


@pytest.mark.parametrize("seed", range(240, 260))
def test_fuzz_all_kernels(seed):
    csr = _random_case(seed)
    m, n = csr.shape
    k = int(np.random.default_rng(seed + 1).integers(1, 17))
    v = generate_fat_vector(n, k, seed=seed + 2)
    oracle = spmm_host_f64(csr, v)
    vj = jnp.asarray(v)

    for name, out in [
        ("sequential", spmm_sequential(csr, vj)),
        ("ell", spmm_ell(ELL.from_csr(csr), vj)),
        ("bucketed", spmm_bucketed(BucketedELL.from_csr(csr), vj)),
        ("auto", spmm_any(auto_format(csr), vj)),
    ]:
        assert out.shape == (m, k), name
        assert max_abs_error(out, oracle) < 1e-8, (name, seed)

    if m == n:
        bb = BandedBlocks.from_csr(csr, block_rows=8)
        if bb is not None:
            out = spmm_banded(bb, vj)
            assert max_abs_error(out, oracle) < 1e-8, ("banded", seed)
            assert max_abs_error(bb.to_dense(), csr.to_dense()) < 1e-12


@pytest.mark.parametrize("seed", range(300, 312))
def test_fuzz_windowed_row_mesh(seed):
    """Randomized distributed windowed-row sweep: random structure x
    random p x random tile shape x random k, halo/replicate decided by
    prepare — every combination must match the host f64 oracle. The
    halo rebase arithmetic (windows, multi-hop, tail ownership) is
    exactly the kind of index bookkeeping fuzzing catches."""
    from sparsematrixmultiplicationmpi_jax.parallel import make_mesh
    from sparsematrixmultiplicationmpi_jax.parallel.windowed_strategy \
        import WindowedRowWise

    rng = np.random.default_rng(seed)
    kind = rng.choice(["banded", "fem", "powerlaw"])
    m = int(rng.integers(200, 1500))
    if kind == "banded":
        csr = banded_csr(m, int(rng.integers(2, 30)),
                         int(rng.integers(1, 9)), seed=seed)
    elif kind == "powerlaw":
        csr = powerlaw_csr(m, m, int(rng.integers(4, 15)) * m, seed=seed)
    else:
        from sparsematrixmultiplicationmpi_jax.io.generate import fem3d_csr

        csr = fem3d_csr(m, int(rng.integers(8, 20)) * m, seed=seed)
    p = int(rng.choice([1, 2, 4, 8]))
    k = int(rng.integers(1, 9))
    R = int(rng.choice([8, 16, 32]))
    mesh = make_mesh(p)
    strat = WindowedRowWise(
        block_rows=R, chunk_cols=128,
        reorder=None if rng.uniform() < 0.5 else "auto",
        input_mode=str(rng.choice(["auto", "halo", "replicate"])))
    operand = strat.prepare(csr, mesh)
    v = generate_fat_vector(csr.shape[1], k, seed=seed + 1)
    out = np.asarray(strat.spmm(operand, jnp.asarray(v), mesh))
    assert max_abs_error(out, spmm_host_f64(csr, v)) < 1e-8
