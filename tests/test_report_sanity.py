"""Publication-sanity layer for the sweep/report pipeline (VERDICT r4
weak #2: REPORT.md once printed a 115.8 %-of-roofline row as "Best"):
suspicious-row detection, the median re-measure protocol, and the
report's refusal to headline impossible numbers.
"""

import dataclasses

import numpy as np

import jax.numpy as jnp

from sparsematrixmultiplicationmpi_jax.bench.harness import (
    BenchRecord, read_csv, remeasure_record, suspicious_records,
    write_csv,
)
from sparsematrixmultiplicationmpi_jax.bench.report import render_report
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr
from sparsematrixmultiplicationmpi_jax.parallel.mesh import make_mesh


def _rec(**kw):
    base = dict(
        matrix="m", m=100, n=100, nnz=1000, k=6, strategy="auto",
        devices=1, execution_time=1e-3, prepare_time=0.0, correct=True,
        max_error=0.0, gflops=1.0, gnnz_per_s=1.0,
        roofline_fraction=0.3, dtype="float32", device_kind="NVIDIA H200",
        gathered=True,
    )
    base.update(kw)
    return BenchRecord(**base)


def test_suspicious_roofline_and_monotonicity():
    recs = [
        _rec(k=1, execution_time=1e-3),
        _rec(k=6, execution_time=1.2e-3),
        # impossible: above the byte roofline
        _rec(k=12, execution_time=0.2e-3, roofline_fraction=1.16),
        # non-monotonic pair: k=16 slower than 1.5x k=32
        _rec(k=16, execution_time=9e-3),
        _rec(k=32, execution_time=2e-3),
    ]
    flagged = suspicious_records(recs)
    reasons = {r.k: why for r, why in flagged}
    assert 12 in reasons and "roofline" in reasons[12]
    assert 16 in reasons and "non-monotonic" in reasons[16]
    assert 32 in reasons  # both ends of the implausible pair re-measure
    assert 1 not in reasons and 6 not in reasons


def test_suspicious_skips_failed_and_unresolved():
    recs = [
        _rec(k=1, execution_time=float("nan"),
             roofline_fraction=None),
        _rec(k=6, execution_time=1e-3, error="boom",
             roofline_fraction=2.0),
    ]
    assert suspicious_records(recs) == []


def test_report_never_headlines_impossible_rows():
    recs = [
        _rec(k=6, strategy="honest", execution_time=2e-3,
             gnnz_per_s=0.5, roofline_fraction=0.4),
        _rec(k=6, strategy="artifact", execution_time=0.5e-3,
             gnnz_per_s=2.0, roofline_fraction=1.16),
    ]
    text = render_report(recs)
    assert "Best: **honest**" in text
    assert "measurement artifact" in text and "116.0%" in text


def test_remeasure_record_median_and_spread(tmp_path):
    csr = banded_csr(512, 10, 5, seed=1).astype(jnp.float32)
    rec = _rec(matrix="fem", k=4, strategy="sequential",
               roofline_fraction=1.5)
    mesh = make_mesh(1)
    new = remeasure_record(csr, rec, runs=3, mesh=mesh, iters=2,
                           inner=10)
    assert new.remeasured == 3
    assert new.strategy == "sequential" and new.k == 4
    if new.execution_time == new.execution_time:  # resolved on this host
        assert new.spread_rel is not None and new.spread_rel >= 0
    # round-trips through the CSV schema (new columns)
    p = tmp_path / "r.csv"
    write_csv(str(p), [new])
    back = read_csv(str(p))[0]
    assert back.remeasured == 3
    assert (back.spread_rel is None) == (new.spread_rel is None)


def test_remeasured_marker_in_report():
    rec = dataclasses.replace(
        _rec(k=6, execution_time=1e-3, gnnz_per_s=1.0),
        remeasured=3, spread_rel=0.2)
    text = render_report([rec])
    assert "median of 3 runs" in text
