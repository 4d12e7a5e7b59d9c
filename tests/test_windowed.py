"""Windowed tile-pair format tests — differential vs the host f64 oracle
on the matrix families in io/generate.py (project test convention)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sparsematrixmultiplicationmpi_jax.formats.windowed import WindowedPairs
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_jax.ops.pallas_windowed import (
    spmm_windowed_pallas,
)
from sparsematrixmultiplicationmpi_jax.ops.windowed import (
    spmm_windowed, spmm_windowed_xla,
)

SMALL = dict(candidates=(8, 16, 32))
#: Tile shapes the Triton kernel takes (rows >= 16).
SMALL_KERNEL = dict(candidates=(16, 32))


def _families():
    return {
        "fem3d": fem3d_csr(2000, 40000, seed=11),
        "banded": banded_csr(800, 30, 10, seed=12),
        "random_dense_tiles": random_csr(400, 500, 30000, seed=13),
    }


@pytest.mark.parametrize("name", ["fem3d", "banded", "random_dense_tiles"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_windowed_matches_oracle(name, k):
    csr = _families()[name]
    wp = WindowedPairs.from_csr(csr, **SMALL)
    assert wp is not None, "expected windowed storage to win here"
    v = generate_fat_vector(csr.shape[1], k, seed=21)
    out = np.asarray(spmm_windowed(wp, jnp.asarray(v)))
    oracle = spmm_host_f64(csr, v)
    np.testing.assert_allclose(out, oracle, atol=1e-9)


def test_windowed_to_dense_roundtrip():
    csr = fem3d_csr(1200, 24000, seed=31)
    wp = WindowedPairs.from_csr(csr, **SMALL)
    np.testing.assert_allclose(
        np.asarray(wp.to_dense()), np.asarray(csr.to_dense()), atol=0
    )


def test_windowed_encode_iterate_decode_composition():
    csr = fem3d_csr(1500, 30000, seed=41)
    wp = WindowedPairs.from_csr(csr, **SMALL)
    assert wp.perm is not None  # RCM should engage on a shuffled mesh
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 4, seed=42))
    full = np.asarray(spmm_windowed(wp, v))
    staged = np.asarray(wp.decode(wp.iterate(wp.encode(v))))
    np.testing.assert_allclose(staged, full, rtol=1e-12)
    # Chained iterate == chained matmul (the solver-style contract).
    v2 = wp.decode(wp.iterate(wp.iterate(wp.encode(v))))
    oracle2 = spmm_host_f64(csr, spmm_host_f64(csr, np.asarray(v)))
    np.testing.assert_allclose(np.asarray(v2), oracle2, atol=1e-6)


def test_windowed_no_reorder_still_correct():
    csr = fem3d_csr(1500, 30000, seed=51)
    wp = WindowedPairs.from_csr(csr, reorder=None, **SMALL)
    if wp is None:
        pytest.skip("unordered mesh not tileable — acceptable refusal")
    assert wp.perm is None
    v = generate_fat_vector(csr.shape[1], 3, seed=52)
    np.testing.assert_allclose(
        np.asarray(spmm_windowed(wp, jnp.asarray(v))),
        spmm_host_f64(csr, v), atol=1e-9,
    )


def test_windowed_refuses_scatter_matrices():
    """Uniform random at scale has ~1 nnz per tile: every tile is below
    the dense threshold and the builder must refuse (gather path wins).
    Power-law matrices may legitimately yield a hybrid (RCM clusters the
    hubs into a few dense tiles) — then the result must be correct with
    most nnz on the spill path."""
    csr2 = random_csr(5000, 5000, 20000, seed=62)
    assert WindowedPairs.from_csr(csr2, candidates=(64, 128)) is None

    csr = powerlaw_csr(5000, 5000, 20000, seed=61)
    wp = WindowedPairs.from_csr(csr, candidates=(64, 128))
    if wp is not None:
        assert wp.spill is not None
        v = generate_fat_vector(csr.shape[1], 3, seed=63)
        np.testing.assert_allclose(
            np.asarray(spmm_windowed(wp, jnp.asarray(v))),
            spmm_host_f64(csr, v), atol=1e-9,
        )


def test_windowed_pallas_interpret_parity():
    csr = fem3d_csr(2000, 40000, seed=71)
    wp = WindowedPairs.from_csr(csr, **SMALL_KERNEL).astype(np.float32)
    for k in (1, 6, 32):
        v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=72),
                        dtype=jnp.float32)
        vp = wp.encode(v)
        ref = np.asarray(spmm_windowed_xla(wp, vp), dtype=np.float64)
        pal = np.asarray(spmm_windowed_pallas(wp, vp, interpret=True),
                         dtype=np.float64)
        np.testing.assert_allclose(pal, ref, rtol=2e-5, atol=2e-2)


def test_windowed_empty_blocks_get_dummy_coverage():
    """Row blocks whose every tile falls below the dense threshold get a
    dummy zero tile at build time, and their entries come back through
    the spill path — on the XLA path and through the kernel."""
    m = 2048
    rows = np.arange(0, 64)  # a dense cluster in block 0
    dense = np.zeros((m, m))
    rng = np.random.default_rng(81)
    dense[np.ix_(rows, rows)] = rng.uniform(1, 2, (64, 64))
    # Scattered singletons across many late blocks: absorbing each as a
    # dense tile would cost ~a tile-stream each, so the global optimizer
    # spills them — leaving those blocks empty (dummy-coverage path).
    rr = rng.choice(np.arange(256, m), size=400, replace=False)
    cc = rng.integers(0, m, size=400)
    dense[rr, cc] = 5.0
    from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR

    csr = CSR.from_dense(dense)
    # margin disabled: this pins dummy-coverage/spill mechanics, not the
    # windowed-vs-gather routing economics (auto owns that decision)
    wp = WindowedPairs.from_csr(csr, block_rows=16, reorder=None,
                                beat_gather_margin=1e9)
    assert wp is not None and wp.spill is not None
    counts = np.diff(np.asarray(wp.block_ptr))
    assert (counts >= 1).all()  # every block covered (dummies included)
    # dummy tiles are all-zero and live in otherwise-empty blocks
    pb = np.asarray(wp.pair_block)
    tile_sums = np.abs(np.asarray(wp.tiles)).sum(axis=(1, 2))
    assert (tile_sums == 0).any()
    v = jnp.asarray(generate_fat_vector(m, 2, seed=82))
    oracle = spmm_host_f64(csr, np.asarray(v))
    np.testing.assert_allclose(
        np.asarray(spmm_windowed(wp, v)), oracle, atol=1e-9)
    # The kernel takes f32/bf16 tiles; f32 is exact on these values up to
    # accumulation rounding.
    wp32 = wp.astype(np.float32)
    vp = wp32.encode(v.astype(jnp.float32))
    np.testing.assert_allclose(
        np.asarray(wp32.decode(
            spmm_windowed_pallas(wp32, vp, interpret=True))),
        oracle, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 5e-3),
                                        (jnp.bfloat16, 5e-2)])
def test_windowed_low_precision(dtype, rtol):
    csr = fem3d_csr(1500, 30000, seed=91)
    wp = WindowedPairs.from_csr(csr, **SMALL).astype(dtype)
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 4, seed=92),
                    dtype=jnp.float32)
    out = np.asarray(spmm_windowed(wp, v), dtype=np.float64)
    oracle = spmm_host_f64(csr, np.asarray(v, dtype=np.float64))
    np.testing.assert_allclose(
        out, oracle, rtol=rtol, atol=rtol * np.abs(oracle).max())


def test_windowed_nonsquare_skips_reorder():
    csr = random_csr(300, 700, 25000, seed=101)
    wp = WindowedPairs.from_csr(csr, candidates=(8, 16))
    if wp is None:
        pytest.skip("builder refused (fine for scatter structure)")
    assert wp.perm is None  # RCM needs square
    v = generate_fat_vector(700, 3, seed=102)
    np.testing.assert_allclose(
        np.asarray(spmm_windowed(wp, jnp.asarray(v))),
        spmm_host_f64(csr, v), atol=1e-9,
    )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_windowed_format_pairs_per_step_8_dispatch(dtype):
    """A format built with pairs_per_step=8 pads globally (no even-run
    padding) and spmm_windowed_pallas runs it end-to-end."""
    csr = fem3d_csr(2000, 40000, seed=161).astype(dtype)
    wp = WindowedPairs.from_csr(csr, block_rows=32, chunk_cols=128,
                                pairs_per_step=8)
    assert wp is not None and wp.pairs_per_step == 8
    assert wp.n_pairs % 8 == 0
    v = generate_fat_vector(csr.shape[1], 8, seed=162).astype(np.float32)
    oracle = spmm_host_f64(csr, v)
    v_p = wp.encode(jnp.asarray(v, dtype))
    got = np.asarray(
        wp.decode(spmm_windowed_pallas(wp, v_p, interpret=True)),
        dtype=np.float64)
    rel = np.abs(got - oracle).max() / np.abs(oracle).max()
    assert rel < (5e-3 if dtype == jnp.float32 else 3e-2)


@pytest.mark.parametrize("pps", [2, 8])
@pytest.mark.parametrize("k", [1, 6, 12])
def test_windowed_core_kpad_forced_pallas(pps, k):
    """Narrow k forced through the Triton kernel: the wrapper pads the
    fat vector to 16 columns (``pl.dot``'s minimum) and slices the
    result back — padded columns must not leak and the contraction must
    match the XLA path on the real columns."""
    from sparsematrixmultiplicationmpi_jax.ops.windowed import (
        spmm_windowed_core,
    )

    csr = fem3d_csr(2000, 40000, seed=91)
    wp = WindowedPairs.from_csr(
        csr, pairs_per_step=pps, beat_gather_margin=1e9,
        allow_spill=False, **SMALL_KERNEL).astype(np.float32)
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=92),
                    dtype=jnp.float32)
    vp = wp.encode(v)
    ref = np.asarray(spmm_windowed_xla(wp, vp), dtype=np.float64)
    got = np.asarray(spmm_windowed_core(wp, vp, use_pallas=True),
                     dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-2)
