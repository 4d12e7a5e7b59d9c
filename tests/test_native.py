"""Native C++ parser: parity with the numpy loader."""

import numpy as np
import pytest

from sparsematrixmultiplicationmpi_jax import max_abs_error, write_matrix_market
from sparsematrixmultiplicationmpi_jax.io import native
from sparsematrixmultiplicationmpi_jax.io.generate import powerlaw_csr, random_csr
from sparsematrixmultiplicationmpi_jax.io.mtx import read_matrix_market_numpy

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native parser unavailable (no g++)"
)


def _roundtrip(tmp_path, csr, **write_kwargs):
    path = str(tmp_path / "m.mtx")
    write_matrix_market(path, csr, **write_kwargs)
    a = native.read_matrix_market_native(path)
    b = read_matrix_market_numpy(path)
    assert a.shape == b.shape
    assert a.nnz == b.nnz
    np.testing.assert_array_equal(np.asarray(a.row_ptr), np.asarray(b.row_ptr))
    np.testing.assert_array_equal(
        np.asarray(a.col_indices), np.asarray(b.col_indices)
    )
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))


def test_parity_general(tmp_path):
    _roundtrip(tmp_path, random_csr(60, 45, 400, seed=91))


def test_parity_symmetric(tmp_path):
    d = np.asarray(random_csr(40, 40, 200, seed=92).to_dense())
    from sparsematrixmultiplicationmpi_jax import CSR

    _roundtrip(tmp_path, CSR.from_dense(d + d.T), symmetric=True)


def test_parity_pattern(tmp_path):
    csr = powerlaw_csr(50, 50, 300, seed=93)
    import dataclasses

    ones = dataclasses.replace(
        csr, values=np.ones_like(np.asarray(csr.values))
    )
    _roundtrip(tmp_path, ones, pattern=True)


def test_parity_multithreaded(tmp_path):
    # Body > 1 MiB forces the parallel path (mmio.cpp threshold).
    csr = random_csr(2000, 2000, 60_000, seed=94)
    path = str(tmp_path / "big.mtx")
    write_matrix_market(path, csr)
    assert (tmp_path / "big.mtx").stat().st_size > 1 << 20
    a = native.read_matrix_market_native(path, n_threads=4)
    b = read_matrix_market_numpy(path)
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    np.testing.assert_array_equal(
        np.asarray(a.col_indices), np.asarray(b.col_indices)
    )


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        native.read_matrix_market_native("/no/such/file.mtx")


def test_native_truncated(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 2.0\n")
    with pytest.raises(ValueError):
        native.read_matrix_market_native(str(p))


def test_native_default_in_read(tmp_path):
    # read_matrix_market prefers the native path transparently.
    from sparsematrixmultiplicationmpi_jax.io.mtx import read_matrix_market

    csr = random_csr(30, 30, 150, seed=95)
    path = str(tmp_path / "m.mtx")
    write_matrix_market(path, csr)
    out = read_matrix_market(path)
    assert max_abs_error(out.to_dense(), csr.to_dense()) == 0.0
