"""Band-dense hybrid format/op tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import CSR, generate_fat_vector, max_abs_error
from sparsematrixmultiplicationmpi_jax.formats.banded import (
    BandedBlocks, band_coverage,
)
from sparsematrixmultiplicationmpi_jax.formats.matrix import BucketedELL
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.banded import spmm_banded


def test_band_coverage():
    csr = banded_csr(200, 5, 4, seed=61)
    assert band_coverage(csr, 8) == 1.0  # bandwidth 5 < 8 => full coverage
    rnd = random_csr(200, 200, 1000, seed=62)
    assert band_coverage(rnd, 8) < 0.5


def test_banded_round_trip():
    csr = banded_csr(100, 7, 5, seed=63)
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    assert bb is not None and bb.spill is None
    assert max_abs_error(bb.to_dense(), csr.to_dense()) == 0.0


def test_banded_with_spill_round_trip():
    # Band plus random off-band entries -> spill path exercised.
    b = banded_csr(150, 6, 4, seed=64)
    r = random_csr(150, 150, 200, seed=65)
    dense = np.asarray(b.to_dense()) + np.asarray(r.to_dense())
    csr = CSR.from_dense(dense)
    bb = BandedBlocks.from_csr(csr, block_rows=16)
    assert bb is not None and bb.spill is not None
    assert max_abs_error(bb.to_dense(), dense) < 1e-12


@pytest.mark.parametrize("k", [1, 3, 12])
def test_spmm_banded(k):
    csr = banded_csr(170, 9, 6, seed=66)
    bb = BandedBlocks.from_csr(csr, block_rows=24)
    v = jnp.asarray(generate_fat_vector(170, k, seed=67))
    out = spmm_banded(bb, v)
    oracle = np.asarray(csr.to_dense()) @ np.asarray(v)
    assert out.shape == (170, k)
    assert max_abs_error(out, oracle) < 1e-9


def test_spmm_banded_with_spill():
    b = banded_csr(90, 4, 3, seed=68)
    r = random_csr(90, 90, 120, seed=69)
    dense = np.asarray(b.to_dense()) + np.asarray(r.to_dense())
    csr = CSR.from_dense(dense)
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    v = jnp.asarray(generate_fat_vector(90, 5, seed=70))
    out = spmm_banded(bb, v)
    assert max_abs_error(out, dense @ np.asarray(v)) < 1e-9


def test_spmm_banded_rows_not_multiple():
    csr = banded_csr(101, 5, 4, seed=71)  # 101 % 8 != 0
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    v = jnp.asarray(generate_fat_vector(101, 4, seed=72))
    out = spmm_banded(bb, v)
    assert max_abs_error(out, np.asarray(csr.to_dense()) @ np.asarray(v)) < 1e-9


def test_from_csr_rejects_scattered():
    rnd = random_csr(400, 400, 2000, seed=73)
    assert BandedBlocks.from_csr(rnd, candidates=(128,),
                                 min_coverage=0.9) is None


def test_block_rows_validation():
    csr = banded_csr(64, 3, 2, seed=74)
    with pytest.raises(ValueError):
        BandedBlocks.from_csr(csr, block_rows=10)


def test_auto_format_selection():
    from sparsematrixmultiplicationmpi_jax.formats.matrix import COO
    from sparsematrixmultiplicationmpi_jax.formats.windowed import (
        WindowedPairs,
    )

    band = banded_csr(600, 20, 8, seed=75)
    # Banded structure must land on a dense-tile format.
    assert isinstance(
        auto_format(band, candidates=(128,)), (WindowedPairs, BandedBlocks)
    )
    # Uniform random at scale (~1 nnz per tile) must land on a gather
    # format. (Power-law matrices may legitimately pick a windowed hybrid:
    # RCM clusters the hubs into dense tiles — see test_windowed.py.)
    scatter = random_csr(5000, 5000, 20000, seed=76)
    fmt = auto_format(scatter, min_coverage=0.9)
    assert isinstance(fmt, (BucketedELL, COO))


@pytest.mark.parametrize("maker,seed", [
    (lambda: banded_csr(300, 15, 7, seed=77), 78),
    (lambda: powerlaw_csr(250, 250, 3000, seed=79), 80),
    (lambda: random_csr(200, 160, 1500, seed=81), 82),
])
def test_spmm_auto(maker, seed):
    csr = maker()
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 6, seed=seed))
    out = spmm(csr, v)
    assert max_abs_error(out, np.asarray(csr.to_dense()) @ np.asarray(v)) < 1e-9


def test_spmm_banded_bf16_band_f32_vector():
    """bf16-stored band x f32 fat vector: accumulate in f32, bf16-level
    accuracy (the half-traffic production mode)."""
    import jax.numpy as jnp
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64

    csr = banded_csr(300, 8, 6, seed=85)
    bb = BandedBlocks.from_csr(csr, block_rows=8).astype(jnp.bfloat16)
    v = jnp.asarray(generate_fat_vector(300, 8, seed=86), jnp.float32)
    out = spmm_banded(bb, v)
    assert out.dtype == jnp.float32
    oracle = spmm_host_f64(csr, np.asarray(v))
    # bf16 error is relative to the result's magnitude scale (individual
    # small entries suffer cancellation, as in any bf16 reduction).
    rel = np.max(np.abs(np.asarray(out, np.float64) - oracle))
    rel /= np.max(np.abs(oracle))
    assert rel < 2e-2
