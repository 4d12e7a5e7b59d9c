"""Triton windowed kernel tests: the real kernel through the Pallas
interpreter on the CPU, against ``spmm_windowed_xla`` and the host f64
oracle (``ops/pallas_windowed.py``). On the GPU the same kernel runs
compiled (``chip_smoke.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax.formats.matrix import CSR
from sparsematrixmultiplicationmpi_jax.formats.windowed import WindowedPairs
from sparsematrixmultiplicationmpi_jax.io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector, random_csr,
)
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_jax.ops.pallas_windowed import (
    kernel_supports, padded_width, spmm_windowed_pallas,
    windowed_matmul_pallas,
)
from sparsematrixmultiplicationmpi_jax.ops.windowed import spmm_windowed_xla

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _format(csr, R, C, **kw):
    kw.setdefault("beat_gather_margin", 1e9)
    kw.setdefault("max_inflation", 1e9)
    wp = WindowedPairs.from_csr(csr, block_rows=R, chunk_cols=C, **kw)
    assert wp is not None
    return wp


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("shape", [(16, 128), (128, 64)])
@pytest.mark.parametrize("k", [1, 6, 16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_xla_and_oracle(dtype, k, shape):
    """(16, 128) walks two column slices per pair; (128, 64) runs two
    row sub-blocks per block. k below 16 or not a power of two is
    padded by the wrapper."""
    R, C = shape
    dt = jnp.dtype(dtype)
    csr = fem3d_csr(600, 9000, seed=3).astype(dt)
    wp = _format(csr, R, C)
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=4), dt)
    vp = wp.encode(v)
    got = wp.decode(spmm_windowed_pallas(wp, vp, interpret=True))
    assert got.shape == (csr.shape[0], k)
    ref = wp.decode(spmm_windowed_xla(wp, vp))
    assert _rel_err(got, ref) < TOL[dtype]
    assert _rel_err(got, spmm_host_f64(csr, np.asarray(v, np.float64))) \
        < max(TOL[dtype], 1e-5)


def test_kernel_empty_blocks_give_zeros():
    """A block with an empty pair run writes zeros (no carry, no atomics:
    the program's accumulator starts at zero and is stored once)."""
    rng = np.random.default_rng(0)
    R, C, nb, n_chunks = 16, 32, 4, 3
    counts = np.array([2, 0, 3, 0])
    pb = np.repeat(np.arange(nb), counts)
    pc = rng.integers(0, n_chunks, len(pb)).astype(np.int32)
    block_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    tiles = rng.standard_normal((len(pb), R, C)).astype(np.float32)
    v = rng.standard_normal((n_chunks * C, 16)).astype(np.float32)
    out = np.asarray(windowed_matmul_pallas(
        jnp.asarray(block_ptr), jnp.asarray(pc), jnp.asarray(tiles),
        jnp.asarray(v), interpret=True))
    ref = np.zeros((nb * R, 16))
    for p in range(len(pb)):
        ref[pb[p] * R:(pb[p] + 1) * R] += (
            tiles[p].astype(np.float64) @ v[pc[p] * C:(pc[p] + 1) * C])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert not out[R:2 * R].any() and not out[3 * R:].any()


def test_kernel_with_spill_matches_oracle():
    """Spilled entries come back through the bucketed-ELL restore that
    the wrapper composes after the kernel."""
    b = banded_csr(500, 6, 4, seed=5)
    r = random_csr(500, 500, 700, seed=6)
    csr = CSR.from_dense(np.asarray(b.to_dense()) + np.asarray(r.to_dense())
                         ).astype(jnp.float32)
    wp = WindowedPairs.from_csr(csr, block_rows=32, chunk_cols=64,
                                reorder=None, beat_gather_margin=1e9)
    assert wp is not None and wp.spill is not None
    v = jnp.asarray(generate_fat_vector(500, 5, seed=7), jnp.float32)
    got = wp.decode(spmm_windowed_pallas(wp, wp.encode(v), interpret=True))
    assert _rel_err(got, spmm_host_f64(csr, np.asarray(v))) < 1e-5


def test_kernel_nonsquare_matrix():
    csr = random_csr(300, 700, 25000, seed=8).astype(jnp.float32)
    wp = _format(csr, 32, 128, reorder=None)
    assert wp.perm is None
    v = jnp.asarray(generate_fat_vector(700, 8, seed=9), jnp.float32)
    got = wp.decode(spmm_windowed_pallas(wp, wp.encode(v), interpret=True))
    assert got.shape == (300, 8)
    assert _rel_err(got, spmm_host_f64(csr, np.asarray(v))) < 1e-5


def test_kernel_noninteger_accuracy():
    """Non-dyadic values (integer fixtures are exact in any precision
    and hide rounding) hold the f32 tier with margin."""
    csr = fem3d_csr(800, 12000, seed=10)
    rng = np.random.default_rng(11)
    vals = (rng.uniform(0.1, 10.0, csr.nnz) * np.pi).astype(np.float32)
    csr = dataclasses.replace(csr, values=jnp.asarray(vals))
    wp = _format(csr, 32, 128)
    v = jnp.asarray(rng.uniform(-1, 1, (csr.shape[1], 8)), jnp.float32)
    got = wp.decode(spmm_windowed_pallas(wp, wp.encode(v), interpret=True))
    assert _rel_err(got, spmm_host_f64(csr, np.asarray(v, np.float64))) \
        < 1e-4


@pytest.mark.parametrize("k,width", [(1, 16), (6, 16), (16, 16), (17, 32),
                                     (32, 32), (33, 64)])
def test_padded_width(k, width):
    assert padded_width(k) == width


@pytest.mark.parametrize("R,C,dtype,ok", [
    (16, 128, jnp.float32, True), (128, 128, jnp.bfloat16, True),
    (8, 128, jnp.float32, False), (24, 128, jnp.float32, False),
    (16, 100, jnp.float32, False), (16, 128, jnp.float64, False),
])
def test_kernel_supports(R, C, dtype, ok):
    assert kernel_supports(R, C, dtype) is ok


def test_windowed_matmul_rejects_bad_inputs():
    bp = jnp.asarray([0, 1], jnp.int32)
    pc = jnp.zeros((1,), jnp.int32)
    tiles = jnp.zeros((1, 16, 32), jnp.float32)
    with pytest.raises(ValueError, match="power of two"):
        windowed_matmul_pallas(bp, pc, tiles,
                               jnp.zeros((32, 12), jnp.float32),
                               interpret=True)
    with pytest.raises(ValueError, match="dtype"):
        windowed_matmul_pallas(bp, pc, tiles,
                               jnp.zeros((32, 16), jnp.bfloat16),
                               interpret=True)
    with pytest.raises(ValueError, match="not supported"):
        windowed_matmul_pallas(bp, pc, jnp.zeros((1, 8, 32), jnp.float32),
                               jnp.zeros((32, 16), jnp.float32),
                               interpret=True)
