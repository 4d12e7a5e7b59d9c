"""Sparse matrix x dense fat-vector multiplication framework for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability set of the MPI
reference ``AlexisBalayre/SparseMatrixMultiplicationMPI``: Matrix Market
loading, CSR/COO/ELL sparse containers, SpMM kernels, and the reference's
three parallel decompositions (row-wise, column-wise, non-zero-element) as
first-class sharding strategies over a GPU device mesh.
"""

from .formats.banded import BandedBlocks
from .formats.matrix import CSR, COO, ELL, BucketedELL
from .formats.serialize import load_format, save_format
from .io.mtx import read_matrix_market, write_matrix_market
from .io.generate import generate_fat_vector
from .ops.auto import auto_format, spmm_any
from .ops.autodiff import make_spmm, make_symmetric_spmm
from .ops.oracle import spmm_host_f64, spmm_sequential, spmm_coo, spmm_dense
from .ops.ell import spmm_ell, spmm_bucketed
from .ops.banded import spmm_banded
from .ops.library import to_bcoo, spmm_bcoo
from .utils.compare import are_matrices_equal, max_abs_error
from .utils.timing import PhaseTimer, time_fn, time_fn_amortized

__version__ = "0.1.0"

__all__ = [
    "CSR", "COO", "ELL", "BucketedELL", "BandedBlocks",
    "load_format", "save_format",
    "read_matrix_market", "write_matrix_market", "generate_fat_vector",
    "auto_format", "spmm_any", "make_spmm", "make_symmetric_spmm",
    "spmm_host_f64", "spmm_sequential", "spmm_coo", "spmm_dense",
    "spmm_ell", "spmm_bucketed", "spmm_banded",
    "to_bcoo", "spmm_bcoo",
    "are_matrices_equal", "max_abs_error", "PhaseTimer", "time_fn",
    "time_fn_amortized",
]
