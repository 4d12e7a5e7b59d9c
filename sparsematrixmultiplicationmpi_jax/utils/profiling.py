"""Profiler integration — first-class replacement for the reference's
comment-toggled debug timers.

The reference's communication/computation split was produced by
*uncommenting* timer blocks inside every kernel and rebuilding
(``RowWise.cpp:21-23,52-60,89-98``; scraped by ``get_csv_debug.sh``). Here:

* ``trace(dir)`` captures a full XLA device profiler trace (TensorBoard or
  Perfetto viewable) around any region — per-op device timings included,
  no rebuild;
* ``annotate(name)`` marks application phases inside a trace;
* ``comm_comp_split`` estimates the collective-vs-compute split by
  differential timing (run with the result left sharded vs gathered),
  which is the honest way to attribute time when XLA overlaps collectives
  with compute (SURVEY.md §7 hard-part (e)).
"""

from __future__ import annotations

import contextlib
import os

import jax

__all__ = ["trace", "annotate", "comm_comp_split"]


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed region."""
    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir,
                            create_perfetto_link=create_perfetto_link):
        yield log_dir


def annotate(name: str):
    """Named phase annotation visible in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def comm_comp_split(strategy, operand, v, mesh, *, inner: int = 10,
                    warmup: int = 1, iters: int = 3):
    """Estimate (total, compute, communication) seconds per SpMM.

    Times the strategy with the result gathered (total) and left sharded
    (compute + intra-kernel collectives); the difference estimates the
    result-aggregation collective — the reference's "communication time"
    (``RowWise.cpp:89-98``), measured without wall-clocked barriers.
    """
    from .timing import measure_amortized

    def per_iter(gather):
        timing, _ = measure_amortized(
            lambda vv, op: strategy.spmm(op, vv, mesh,
                                         gather_result=gather),
            v, operand, inner=inner, warmup=warmup, iters=iters,
        )
        # Sub-resolution slopes fall back to the chained upper bound: both
        # variants are measured identically, so the *difference* (the comm
        # estimate) stays meaningful even when each absolute number is only
        # a bound.
        return (timing.seconds_per_iter if timing.resolved
                else timing.upper_bound)

    t_total = per_iter(True)
    t_comp = per_iter(False)
    return t_total, t_comp, max(t_total - t_comp, 0.0)
