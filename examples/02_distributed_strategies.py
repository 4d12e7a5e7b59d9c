"""All parallel strategies over a device mesh, validated and timed.

Run on CPU with virtual devices:
  JAX_PLATFORM_NAME=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/02_distributed_strategies.py
or on a multi-GPU host directly.
"""

import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)

import jax
import jax.numpy as jnp
import numpy as np

import sparsematrixmultiplicationmpi_jax as smt
from sparsematrixmultiplicationmpi_jax.bench.harness import run_benchmark
from sparsematrixmultiplicationmpi_jax.io.generate import cop20k_like
from sparsematrixmultiplicationmpi_jax.parallel import get_strategy, make_mesh


def main():
    csr = cop20k_like(scale=0.02).astype(jnp.float32)
    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} x {jax.devices()[0].device_kind}")

    for name in ["row", "column", "nnz", "banded_row", "auto", "library"]:
        rec = run_benchmark(
            csr, 16, get_strategy(name), mesh,
            matrix_name="cop20k_small", warmup=1, iters=3,
        )
        flag = "ok" if rec.correct else "MISMATCH"
        print(f"{name:12s} {rec.execution_time * 1e3:8.3f} ms  "
              f"{rec.gflops:7.2f} GFLOP/s  {flag}")


if __name__ == "__main__":
    main()
