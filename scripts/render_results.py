#!/usr/bin/env python
"""Render results/REPORT.md + figures from a sweep checkpoint CSV.

The sweep itself renders on completion; this standalone renderer covers
interrupted runs (the checkpoint CSV is append-only and resumable).

Run: JAX_PLATFORM_NAME=cpu python scripts/render_results.py \
        [csv=results/sweep.csv] [outdir=results]
"""
import csv
import sys


def load_records(path):
    from sparsematrixmultiplicationmpi_jax.bench.harness import BenchRecord

    def _f(x):
        return float(x) if x not in (None, "") else None

    recs = []
    for r in csv.DictReader(open(path)):
        recs.append(BenchRecord(
            matrix=r["matrix"], m=int(r["m"]), n=int(r["n"]),
            nnz=int(r["nnz"]), k=int(r["k"]), strategy=r["strategy"],
            devices=int(r["devices"]),
            execution_time=float(r["execution_time"]),
            prepare_time=float(r["prepare_time"]),
            correct=r["correct"] == "True", max_error=_f(r["max_error"]),
            gflops=float(r["gflops"]), gnnz_per_s=float(r["gnnz_per_s"]),
            roofline_fraction=_f(r.get("roofline_fraction")),
            dtype=r["dtype"], device_kind=r["device_kind"],
            gathered=r["gathered"] == "True",
            comp_time=_f(r.get("comp_time")),
            comm_time=_f(r.get("comm_time")),
            time_upper_bound=_f(r.get("time_upper_bound")),
        ))
    return recs


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/sweep.csv"
    outdir = sys.argv[2] if len(sys.argv) > 2 else "results"
    from sparsematrixmultiplicationmpi_jax.bench.plots import render_all
    from sparsematrixmultiplicationmpi_jax.bench.report import render_report

    records = load_records(path)
    paths = render_all(records, f"{outdir}/figures")
    kinds = sorted({r.device_kind for r in records})
    render_report(records, f"{outdir}/REPORT.md",
                  title=f"{', '.join(kinds)} results — matrix x k x "
                        "strategy sweep")
    print(f"{len(records)} records -> {len(paths)} figures + REPORT.md")


if __name__ == "__main__":
    main()
