"""Structured phase timing.

Replaces the reference's two-tier timing story — ``MPI_Wtime`` wall clocks
around each algorithm (``main.cpp:161-163`` etc.) plus *commented-out* debug
timers inside every kernel (``RowWise.cpp:21-23,52-60,89-98``) that had to be
uncommented to produce ``results_debug.csv`` — with a first-class,
always-available phase timer that understands JAX's async dispatch
(``block_until_ready`` instead of ``MPI_Barrier``) and exports
machine-readable records instead of grep-able stdout prose.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import jax

__all__ = ["PhaseTimer", "Timing", "time_fn", "measure_amortized",
           "AmortizedTiming", "time_fn_amortized"]


@dataclasses.dataclass
class Timing:
    """One timed measurement (seconds)."""

    name: str
    seconds: float

    def to_dict(self):
        return {"name": self.name, "seconds": self.seconds}


class PhaseTimer:
    """Accumulates named phase timings; the ``results_debug.csv`` analog."""

    def __init__(self):
        self.records: List[Timing] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase. ``sync`` is an optional array/pytree to
        ``block_until_ready`` before stopping the clock (the reference used
        ``MPI_Barrier`` + ``MPI_Wtime``; with XLA async dispatch the fence
        must be on the data)."""
        start = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            target = result.get("sync", sync)
            if target is not None:
                jax.block_until_ready(target)
            self.records.append(Timing(name, time.perf_counter() - start))

    def total(self, prefix: str = "") -> float:
        return sum(r.seconds for r in self.records if r.name.startswith(prefix))

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out


def _fence(result):
    """Completion barrier: block, then fetch one element (a round trip
    that cannot complete before the computation has)."""
    import numpy as np

    result = jax.block_until_ready(result)
    leaves = jax.tree.leaves(result)
    if leaves and hasattr(leaves[0], "addressable_shards"):
        np.asarray(leaves[0].addressable_shards[0].data).ravel()[:1]
    elif leaves:
        np.asarray(leaves[0]).ravel()[:1]
    return result


def time_fn(fn, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Benchmark a jitted function: returns (best_seconds, result).

    Warms up (compile), then takes the best of ``iters`` timed runs,
    fenced by a value fetch — the MPI_Wtime-pair analog
    (``main.cpp:161-163``) done correctly for an async runtime.
    The fetch round trip is included in the measurement; for
    dispatch-latency-free numbers use :func:`time_fn_amortized`.
    """
    result = None
    for _ in range(max(warmup, 1)):
        result = _fence(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        result = _fence(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result


@dataclasses.dataclass
class AmortizedTiming:
    """Result of a two-point amortized measurement.

    ``seconds_per_iter`` is NaN when the measurement is below the timing
    resolution (the two-point slope is smaller than the run-to-run noise of
    its own endpoints) — a sub-resolution kernel must surface as
    "< upper_bound", never as a garbage throughput number (a 49-nnz matrix
    once printed 1.7e6 Gnnz/s in a shipped report). ``upper_bound`` is
    always a valid bound: the full chained wall time divided by the chain
    length, which includes dispatch overhead and therefore cannot
    understate the kernel time.
    """

    seconds_per_iter: float   # NaN when below resolution
    upper_bound: float        # t_hi / inner — always >= the true per-iter
    resolved: bool
    t_lo: float               # best wall time of the 1-iteration chain
    t_hi: float               # best wall time of the `inner`-iteration chain
    noise: float              # endpoint run-to-run spread (median - best)


def measure_amortized(fn, v, *args, inner: int = 20, warmup: int = 1,
                      iters: int = 3, calibrate: bool = True):
    """Steady-state per-call time of ``fn(v, *args) -> array``.

    Chains ``inner`` dependent invocations inside one jitted program
    (each iteration's full output feeds a tiny perturbation of ``v``, so
    the compiler can neither hoist nor dead-code-eliminate any of them) and
    divides wall time by ``inner``. With ``calibrate`` the single-dispatch
    envelope is measured at two chain lengths and the slope is returned,
    canceling per-dispatch latency entirely.

    This measures what a production pipeline sees (the kernel runs inside a
    larger jitted program, dispatched once) rather than per-call dispatch
    overhead — the distinction the reference never had to make because MPI
    dispatch is nanoseconds while an accelerator dispatch is microseconds
    or more.

    When the slope is indistinguishable from measurement noise (tiny
    matrices whose whole chain runs inside the dispatch envelope — the
    reference's cage4 class), the timing is flagged unresolved instead of
    clamped to a fake floor. Returns (AmortizedTiming, last_result).

    If the operand supports the permuted-space iteration protocol
    (``encode``/``iterate``/``decode`` — see ``ops/auto.spmm_any``), pass
    the *iterate* body here and keep encode/decode outside: the two-point
    slope then measures exactly the marginal cost of one more multiply,
    with one-time transforms cancelled — the quantity an iterative solver
    pays per step.
    """
    import jax.numpy as jnp

    def chain(n):
        @jax.jit
        def run(v, *args):
            def body(_, carry):
                vv, acc = carry
                out = fn(vv, *args)
                # Consume the FULL output so nothing is DCE-able, and feed
                # it back so iterations are sequentially dependent.
                c = (jnp.sum(out) * 1e-30).astype(vv.dtype)
                return vv + c, acc + c
            _, acc = jax.lax.fori_loop(
                0, n, body, (v, jnp.zeros((), v.dtype))
            )
            return acc
        return run

    def stats(run):
        # Fence with a VALUE FETCH of the chained scalar: a true round
        # trip that cannot complete before the computation has.
        for _ in range(max(warmup, 1)):
            float(run(v, *args))
        times = []
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            float(run(v, *args))
            times.append(time.perf_counter() - t0)
        times.sort()
        best = times[0]
        noise = times[len(times) // 2] - best  # median - best spread
        return best, noise

    t_hi, noise_hi = stats(chain(inner))
    if calibrate:
        t_lo, noise_lo = stats(chain(1))
        slope = (t_hi - t_lo) / (inner - 1)
        # Resolution floor: the slope must exceed the endpoints' own
        # run-to-run spread (plus a perf_counter granularity guard) to mean
        # anything. Below it, report unresolved with an honest upper bound.
        resolution = max((noise_hi + noise_lo) / (inner - 1), 1e-7)
        resolved = slope > resolution
        per = slope if resolved else float("nan")
        noise = noise_hi + noise_lo
    else:
        t_lo, per, resolved, noise = float("nan"), t_hi / inner, True, noise_hi
    timing = AmortizedTiming(
        seconds_per_iter=per, upper_bound=t_hi / inner,
        resolved=resolved, t_lo=t_lo, t_hi=t_hi, noise=noise,
    )
    return timing, fn(v, *args)


def time_fn_amortized(fn, v, *args, inner: int = 20, warmup: int = 1,
                      iters: int = 3, calibrate: bool = True):
    """Back-compat wrapper over :func:`measure_amortized` returning
    ``(seconds_per_iteration, last_result)``; NaN when below resolution."""
    timing, result = measure_amortized(
        fn, v, *args, inner=inner, warmup=warmup, iters=iters,
        calibrate=calibrate,
    )
    return timing.seconds_per_iter, result
