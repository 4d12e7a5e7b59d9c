#!/usr/bin/env python
"""Full results sweep on the local GPU (writes results/).

Run from the repo root:
    python scripts/run_results_sweep.py
Resumes from results/sweep.csv if interrupted; refuses to run without a
GPU (a CPU timing is not a device number).

Envelope: k in {1, 3, 6, 9, 12, 32} on the main tier — covering all
five of the reference's k values ({1,3,6,9,12}, batch_test.sh:12) plus
the k=32 headline — and an amazon0302-like family (the near-banded
co-purchase graph from the reference's matrix-impact sweep). After the
sweep, a sanity pass re-measures any physically implausible row
(>95 % roofline or non-monotonic in k, harness.suspicious_records) as
the median of 3 amortized runs before the report is rendered — REPORT.md
must never headline a number the hardware cannot produce.
"""
import sys

import jax
import jax.numpy as jnp
from sparsematrixmultiplicationmpi_jax.bench.harness import (
    read_csv, remeasure_record, suspicious_records, sweep, write_csv,
    write_json)
from sparsematrixmultiplicationmpi_jax.bench.plots import render_all
from sparsematrixmultiplicationmpi_jax.bench.report import render_report
from sparsematrixmultiplicationmpi_jax.io.generate import (
    amazon0302_like, banded_csr, cage4_like, cop20k_like, dc1_like,
    powerlaw_csr, random_csr, roadnet_like)
from sparsematrixmultiplicationmpi_jax.utils.backend import platform

if platform() != "gpu":
    sys.exit("run_results_sweep.py: no GPU; refusing to record CPU timings")
DEVICE_KIND = jax.devices()[0].device_kind

matrices = {
    "cage4_like": cage4_like().astype(jnp.float32),
    "fem_banded_100k": banded_csr(100_000, 150, 18, seed=11).astype(jnp.float32),
    "powerlaw_100k": powerlaw_csr(100_000, 100_000, 1_500_000, seed=12).astype(jnp.float32),
    "uniform_random_100k": random_csr(100_000, 100_000, 1_200_000, seed=13).astype(jnp.float32),
    "amazon0302_like": amazon0302_like().astype(jnp.float32),
    "cop20k_like": cop20k_like().astype(jnp.float32),
}
# Failed jobs (r.error set) print distinctly from numeric mismatches.
progress = lambda r: print(  # noqa: E731
    f"{r.matrix} k={r.k} {r.strategy} ({r.dtype}): "
    + (f"FAILED {r.error}" if r.error else
       f"{r.execution_time*1e3:.3f} ms "
       f"{r.gnnz_per_s:.3f} Gnnz/s {'ok' if r.correct else 'MISMATCH'}"),
    flush=True)

CHECKPOINT = "results/sweep.csv"
common = dict(
    device_counts=[1], warmup=1, iters=2, amortized=True,
    checkpoint_csv=CHECKPOINT,
    resume_from=CHECKPOINT,
    progress=progress,
    job_timeout=600.0,
)

bf16_names = ("cop20k_like", "fem_banded_100k", "powerlaw_100k")
tier3 = {"roadnet_like": roadnet_like().astype(jnp.float32),
         "dc1_like": dc1_like().astype(jnp.float32)}

records = sweep(
    matrices, ks=[1, 6, 12, 32],
    strategy_names=["row", "column", "nnz", "windowed_row", "auto",
                    "library"],
    comm_split=True, **common,
)
# k in {3, 9} (the reference's remaining batch_test.sh k values) run
# the three informative fast strategies only: the gather and library
# classes' k-scaling is already characterized at four other k values.
records += sweep(
    matrices, ks=[3, 9],
    strategy_names=["column", "windowed_row", "auto"],
    comm_split=True, **common,
)
# bf16 tier: the Auto strategy under the comparator's documented bf16
# tolerance, suffixed names so resume keys stay unique.
records += sweep(
    {f"{name}_bf16": csr for name, csr in matrices.items()
     if name in bf16_names},
    ks=[32], strategy_names=["auto"], dtype=jnp.bfloat16, **common,
)
# Matrix-impact tier (reference analog: the k=6 sweep over 6
# structurally distinct matrices, report/425500_Report.tex:673-692 /
# results/analysis.csv): the two families the main tier lacks — planar
# road network (barely-scales regime) and circuit hubs (load-imbalance
# regime).
records += sweep(
    tier3,
    ks=[6], strategy_names=["windowed_row", "auto"],
    comm_split=True, **common,
)

# The JSON/figures/report come from the FULL checkpoint CSV, not the
# in-memory list: a resumed run's `records` only holds the jobs it ran
# itself.
all_records = read_csv(CHECKPOINT)

# ---- sanity pass: re-measure implausible rows before publishing.
by_name = dict(matrices)
by_name.update(tier3)
for name in bf16_names:
    by_name[f"{name}_bf16"] = matrices[name].astype(jnp.bfloat16)
sus = suspicious_records(all_records)
for rec, reason in sus:
    csr = by_name.get(rec.matrix)
    if csr is None:
        print(f"SUSPECT (not re-measured): {rec.matrix} k={rec.k} "
              f"{rec.strategy}: {reason}", flush=True)
        continue
    print(f"re-measuring {rec.matrix} k={rec.k} {rec.strategy} "
          f"({reason})", flush=True)
    new = remeasure_record(csr, rec)
    key = (rec.matrix, rec.k, rec.strategy, rec.devices, rec.dtype)
    all_records = [
        new if (r.matrix, r.k, r.strategy, r.devices, r.dtype) == key
        else r for r in all_records]
    progress(new)
if sus:
    write_csv(CHECKPOINT, all_records)

write_json("results/sweep.json", all_records,
           hardware=f"{DEVICE_KIND} (1 device)",
           note="amortized steady-state timing")
paths = render_all(all_records, "results/figures")
render_report(all_records, "results/REPORT.md",
              title=f"{DEVICE_KIND} results — matrix x k x strategy sweep")
print(f"{len(all_records)} records ({len(records)} new), "
      f"{len(paths)} figures + REPORT.md", flush=True)
