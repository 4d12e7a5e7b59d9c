"""Basic SpMM: load, multiply, validate — the reference's `./main` flow.

Run: python examples/01_spmm_basics.py [matrix.mtx]
"""

import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)


import jax.numpy as jnp
import numpy as np

import sparsematrixmultiplicationmpi_jax as smt
from sparsematrixmultiplicationmpi_jax.io.generate import cop20k_like
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64


def main():
    if len(sys.argv) > 1:
        csr = smt.read_matrix_market(sys.argv[1])
    else:
        csr = cop20k_like(scale=0.05)  # synthetic demo matrix
    csr = csr.astype(jnp.float32)
    m, n = csr.shape
    print(f"matrix {m}x{n}, {csr.nnz} nnz")

    k = 32
    v = jnp.asarray(smt.generate_fat_vector(n, k, seed=0), jnp.float32)

    operand = auto_format(csr)  # band-dense or bucketed ELL, by structure
    print(f"format: {type(operand).__name__}")
    out = spmm_any(operand, v)

    oracle = spmm_host_f64(csr, np.asarray(v))
    ok = smt.are_matrices_equal(
        np.asarray(out), oracle,
        tolerance=smt.utils.compare.default_tolerance(jnp.float32),
        relative=True,
    )
    print("Results are the same!" if ok else "Results are different!")


if __name__ == "__main__":
    main()
