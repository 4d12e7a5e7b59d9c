"""Card-only tests: the Triton kernel compiled for the GPU (no
interpreter) against the XLA path and the host oracle. They skip on the
CPU; run them on a GPU machine with
``SPMM_TEST_GPU=1 python -m pytest tests -m gpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax.formats.windowed import WindowedPairs
from sparsematrixmultiplicationmpi_jax.io.generate import (
    fem3d_csr, generate_fat_vector,
)
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_jax.ops.pallas_windowed import (
    spmm_windowed_pallas,
)
from sparsematrixmultiplicationmpi_jax.ops.windowed import spmm_windowed_xla

pytestmark = pytest.mark.gpu


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("k", [1, 12, 32])
def test_gpu_kernel_f32_matches_oracle(gpu, k):
    csr = fem3d_csr(20000, 400000, seed=1).astype(jnp.float32)
    wp = WindowedPairs.from_csr(csr, block_rows=128, chunk_cols=128)
    assert wp is not None
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=2),
                    jnp.float32)
    vp = wp.encode(v)
    got = wp.decode(spmm_windowed_pallas(wp, vp))
    ref = spmm_host_f64(csr, np.asarray(v))
    assert _rel_err(got, ref) < 1e-4
    assert _rel_err(got, wp.decode(spmm_windowed_xla(wp, vp))) < 1e-4


@pytest.mark.parametrize("shape", [(16, 128), (64, 256), (256, 128)])
def test_gpu_kernel_bf16_tile_shapes(gpu, shape):
    csr = fem3d_csr(8000, 160000, seed=3).astype(jnp.bfloat16)
    wp = WindowedPairs.from_csr(csr, block_rows=shape[0],
                                chunk_cols=shape[1], beat_gather_margin=1e9)
    assert wp is not None
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 32, seed=4),
                    jnp.bfloat16)
    vp = wp.encode(v)
    got = wp.decode(spmm_windowed_pallas(wp, vp))
    assert _rel_err(got, wp.decode(spmm_windowed_xla(wp, vp))) < 2e-2


def test_gpu_windowed_row_kernel_on_one_device(gpu):
    from sparsematrixmultiplicationmpi_jax.parallel import (
        WindowedRowWise, make_mesh,
    )

    csr = fem3d_csr(20000, 400000, seed=5).astype(jnp.float32)
    mesh = make_mesh(1)
    strat = WindowedRowWise(block_rows=128, chunk_cols=128, kernel="pallas")
    v = jnp.asarray(generate_fat_vector(csr.shape[1], 8, seed=6),
                    jnp.float32)
    out = strat.spmm(strat.prepare(csr, mesh), v, mesh)
    assert jax.devices()[0] in out.sharding.device_set
    assert _rel_err(out, spmm_host_f64(csr, np.asarray(v))) < 1e-4
