#!/usr/bin/env python
"""Headline benchmark: SpMM throughput on a cop20k_A-stats matrix, k=32.

Prints ONE JSON line:
  {"metric": "spmm_gnnz_per_s_cop20k_k32", "value": N, "unit": "Gnnz/s",
   "vs_baseline": N, "platform": "gpu", "device_kind": ..., ...}

Baseline: the reference's best measured SpMM throughput on cop20k_A
(row-wise, k=12, 60 cores: 2,624,331 nnz / 0.1023 s = 0.02565 Gnnz/s,
from ``results/cop20k_A.csv`` — see BASELINE.md). The reference never ran
k=32; its per-nnz throughput *falls* with k (0.105 s @ k=1 -> 0.102 s @
k=12 best), so comparing our k=32 rate against its best-any-k rate is
conservative in the reference's favor.

Measures the GPU only: with no GPU it exits non-zero and prints no
result. No SuiteSparse download is possible offline, so the matrix is a
synthetic twin with cop20k_A's dims/nnz/symmetry
(``io/generate.py::cop20k_like``).

Run: ``python bench.py``
"""

import json
import sys

REFERENCE_GNNZ_PER_S = 2_624_331 / 0.1023 / 1e9  # best row-wise, k=12, 60 cores


def main() -> int:
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.bench.harness import run_benchmark
    from sparsematrixmultiplicationmpi_jax.io.generate import cop20k_like
    from sparsematrixmultiplicationmpi_jax.parallel import Auto, make_mesh
    from sparsematrixmultiplicationmpi_jax.utils.backend import platform
    from sparsematrixmultiplicationmpi_jax.utils.cache import (
        enable_compile_cache,
    )

    plat = platform()
    if plat != "gpu":
        print(f"bench.py: no GPU (JAX platform {plat!r}); this benchmark "
              "measures the GPU only", file=sys.stderr)
        return 1
    enable_compile_cache()

    k = 32
    csr = cop20k_like(dtype="float32")
    mesh = make_mesh(1)
    # Amortized steady-state timing: `inner` chained, data-dependent SpMMs
    # inside one compiled program — the per-iteration cost a solver/GNN
    # pipeline sees, with per-dispatch latency canceled by two-point
    # calibration.
    rec = run_benchmark(
        csr, k, Auto(), mesh, matrix_name="cop20k_like",
        warmup=2, iters=5, check=True, dtype=jnp.float32,
        amortized=True, inner=20,
    )
    result = {
        "metric": "spmm_gnnz_per_s_cop20k_k32",
        "value": rec.gnnz_per_s,
        "unit": "Gnnz/s",
        "vs_baseline": rec.gnnz_per_s / REFERENCE_GNNZ_PER_S,
        "execution_time_s": rec.execution_time,
        "gflops": rec.gflops,
        "roofline_fraction": rec.roofline_fraction,
        "correct": rec.correct,
        "platform": plat,
        "device_kind": rec.device_kind,
        "devices": rec.devices,
        "nnz": rec.nnz,
        "k": rec.k,
        "dtype": rec.dtype,
    }
    print(json.dumps(result))
    return 0 if rec.correct else 1


if __name__ == "__main__":
    sys.exit(main())
