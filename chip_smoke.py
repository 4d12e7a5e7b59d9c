#!/usr/bin/env python
"""GPU smoke test: the SpMM main path end to end on one card (or four).

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --multi    # four GPUs: the distributed strategies

Default run, one process, one line per phase:

1. device     platform, device kind and count, plus the card's name and
              power limit from nvidia-smi. Fails unless the platform is gpu.
2. bench      ``bench.py``'s path: cop20k_like (121,192 rows, 2.62 M nnz),
              k=32, f32, ``Auto`` amortized chain, checked against the
              host f64 oracle at the f32 tier. Then the same
              ``WindowedPairs`` chain with the Triton kernel against
              ``spmm_windowed_xla``, in turns.
3. parity     the kernel, ``spmm_windowed_xla`` and the oracle on
              cop20k_like's own ``WindowedPairs`` at k in {1, 8, 32}.
4. formats    the other format classes at k=32 (bucketed ELL, COO
              segment-sum, BCOO): times for the router refit.
5. contract   every single-card strategy at k=12 in f64 against the
              sequential oracle at the reference's 1e-6 absolute.
6. gcn        one GCN training step at 100k nodes through
              ``make_symmetric_spmm``, against the XLA-path step.

``--multi`` runs only the four-card phase: RowWise, ColumnWise,
NonZeroElement (psum and scatter), BandedRowWise, WindowedRowWise and
Auto at k in {1, 32}, Grid2D on a 2x2 mesh and the sharded GCN step,
each against its oracle, with each output's device ids and every card's
peak bytes.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
Any failure raises: the script then exits non-zero and prints no
result. Without a GPU it fails in phase 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 5e-3  # utils/compare.py::default_tolerance(float32)


def log(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(expect_count: int | None = None):
    import jax

    devs = jax.devices()
    d = devs[0]
    log("device", platform=d.platform, kind=repr(d.device_kind),
        count=len(devs))
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {d.platform!r}")
    if expect_count is not None and len(devs) < expect_count:
        raise RuntimeError(f"need {expect_count} GPUs, have {len(devs)}")
    print(nvidia_smi(), flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _peak_bytes(devices) -> list:
    out = []
    for d in devices:
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def _check_f32(out, csr, v, label: str) -> float:
    """Max error vs the host f64 oracle; raises outside the f32 tier
    (relative, conditioned — bench/harness.py's check)."""
    import dataclasses

    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_host_f64
    from sparsematrixmultiplicationmpi_jax.utils.compare import (
        are_matrices_equal, max_abs_error,
    )

    out = np.asarray(out, dtype=np.float64)
    oracle = spmm_host_f64(csr, np.asarray(v, np.float64))
    cond = spmm_host_f64(
        dataclasses.replace(csr, values=np.abs(np.asarray(csr.values))),
        np.abs(np.asarray(v, np.float64)))
    err = max_abs_error(out, oracle)
    if not np.all(np.isfinite(out)) or not are_matrices_equal(
            out, oracle, tolerance=F32_TOL, relative=True,
            condition_scale=cond):
        raise AssertionError(f"{label}: outside the f32 tier "
                             f"(max abs error {err:.3e})")
    return err


def _chain_time(enc, body, dec, v, operand, inner: int):
    """Amortized seconds per chained multiply, and the decoded output."""
    import jax

    from sparsematrixmultiplicationmpi_jax.utils.timing import (
        measure_amortized,
    )

    v_enc = jax.jit(enc)(v, operand)
    timing = None
    for n in (inner, inner * 4):
        timing, out = measure_amortized(body, v_enc, operand, inner=n,
                                        warmup=1, iters=5)
        if timing.resolved:
            break
    out = jax.jit(dec)(out, operand)
    return timing.seconds_per_iter, out


def phase_bench(csr, inner: int = 20):
    """bench.py's path, then kernel vs XLA on the same chain."""
    import jax
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.bench.harness import run_benchmark
    from sparsematrixmultiplicationmpi_jax.formats.windowed import (
        WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_jax.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.ops.pallas_windowed import (
        kernel_supports, spmm_windowed_pallas,
    )
    from sparsematrixmultiplicationmpi_jax.ops.windowed import (
        spmm_windowed_xla,
    )
    from sparsematrixmultiplicationmpi_jax.parallel import Auto, make_mesh
    from sparsematrixmultiplicationmpi_jax.utils.backend import platform

    k = 32
    mesh = make_mesh(1)
    auto = Auto()
    t0 = time.perf_counter()
    op = auto.prepare(csr, mesh)
    jax.block_until_ready(jax.tree.leaves(op))
    prep = time.perf_counter() - t0
    fmt = type(op).__name__
    shape = ""
    if isinstance(op, WindowedPairs):
        shape = (f"({op.block_rows},{op.chunk_cols}) pairs={op.n_pairs} "
                 f"spill={'yes' if op.spill is not None else 'no'}")
    rec = run_benchmark(csr, k, auto, mesh, matrix_name="cop20k_like",
                        warmup=2, iters=5, check=True, dtype=jnp.float32,
                        amortized=True, inner=inner)
    log("bench", format=fmt, tiles=repr(shape), prepare_s=f"{prep:.1f}",
        time_s=rec.execution_time, gnnz_per_s=rec.gnnz_per_s,
        correct=rec.correct, max_error=rec.max_error,
        roofline_fraction=rec.roofline_fraction,
        peak_bytes=_peak_bytes(mesh.devices.flat)[0])
    if not rec.correct:
        raise AssertionError("bench path: Auto chain outside the f32 tier")
    if not isinstance(op, WindowedPairs):
        return op, None
    if not kernel_supports(op.block_rows, op.chunk_cols, op.dtype):
        log("bench_ab", kernel="not applicable", tiles=repr(shape))
        return op, None

    interpret = platform() != "gpu"
    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=0),
                    jnp.float32)
    enc = lambda x, o: o.encode(x)  # noqa: E731
    dec = lambda x, o: o.decode(x)  # noqa: E731
    bodies = {
        "xla": lambda x, o: spmm_windowed_xla(o, x),
        "kernel": lambda x, o: spmm_windowed_pallas(
            o, x, interpret=interpret),
    }
    # In turns (A B B A), best of each: one card, one process.
    order = list(bodies) + list(reversed(bodies))
    times = {name: [] for name in bodies}
    errs = {}
    for name in order:
        t, out = _chain_time(enc, bodies[name], dec, v, op, inner)
        times[name].append(t)
        errs[name] = _check_f32(out, csr, v, f"bench_ab {name}")
    log("bench_ab",
        **{f"{n}_s": min(ts) for n, ts in times.items()},
        **{f"{n}_runs": ts for n, ts in times.items()},
        **{f"{n}_max_error": e for n, e in errs.items()})
    return op, times


def phase_parity(csr, op, ks=(1, 8, 32), inner: int = 20):
    """Kernel vs spmm_windowed_xla vs the oracle on cop20k's own format."""
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.formats.windowed import (
        WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_jax.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.ops.pallas_windowed import (
        F32_PRECISION, padded_width, spmm_windowed_pallas,
    )
    from sparsematrixmultiplicationmpi_jax.ops.windowed import (
        spmm_windowed_xla,
    )
    from sparsematrixmultiplicationmpi_jax.utils.backend import platform

    if not isinstance(op, WindowedPairs):
        raise AssertionError(f"parity needs a WindowedPairs, got "
                             f"{type(op).__name__}")
    interpret = platform() != "gpu"
    enc = lambda x, o: o.encode(x)  # noqa: E731
    dec = lambda x, o: o.decode(x)  # noqa: E731
    kern = lambda x, o: spmm_windowed_pallas(  # noqa: E731
        o, x, interpret=interpret)
    xla = lambda x, o: spmm_windowed_xla(o, x)  # noqa: E731
    for k in ks:
        v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=1),
                        jnp.float32)
        t_k, out_k = _chain_time(enc, kern, dec, v, op, inner)
        t_x, out_x = _chain_time(enc, xla, dec, v, op, inner)
        e_k = _check_f32(out_k, csr, v, f"parity k={k} kernel")
        e_x = _check_f32(out_x, csr, v, f"parity k={k} xla")
        log("parity", k=k, kernel_width=padded_width(k),
            precision=F32_PRECISION.name, tolerance=f"{F32_TOL} rel",
            kernel_max_error=e_k, xla_max_error=e_x,
            kernel_s=t_k, xla_s=t_x)


def phase_formats(csr, k: int = 32, inner: int = 20):
    """The other format classes at k: data for the router refit."""
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.formats.matrix import BucketedELL
    from sparsematrixmultiplicationmpi_jax.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.ops.ell import spmm_bucketed
    from sparsematrixmultiplicationmpi_jax.ops.library import (
        spmm_bcoo, to_bcoo,
    )
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_coo

    v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=2),
                    jnp.float32)
    ident = lambda x, o: x  # noqa: E731
    for name, operand, fn in (
            ("bucketed_ell", BucketedELL.from_csr(csr), spmm_bucketed),
            ("coo", csr.to_coo(), spmm_coo),
            ("bcoo", to_bcoo(csr), spmm_bcoo)):
        t, out = _chain_time(ident, lambda x, o, fn=fn: fn(o, x), ident,
                             v, operand, inner)
        err = _check_f32(out, csr, v, f"formats {name}")
        log("formats", format=name, k=k, time_s=t, max_error=err)


def phase_contract(csr64, k: int = 12):
    """Every single-card strategy in f64 vs the sequential oracle at the
    reference's 1e-6 absolute (utils/compare.py)."""
    import jax
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.parallel import (
        Sequential, get_strategy, make_mesh,
    )
    from sparsematrixmultiplicationmpi_jax.utils.compare import (
        DEFAULT_ABS_TOL, are_matrices_equal, max_abs_error,
    )

    if not jax.config.jax_enable_x64:
        raise RuntimeError("phase_contract needs jax_enable_x64")
    mesh = make_mesh(1)
    v = jnp.asarray(generate_fat_vector(csr64.shape[1], k, seed=0),
                    jnp.float64)
    seq = Sequential()
    oracle = np.asarray(seq.spmm(seq.prepare(csr64, mesh), v, mesh))
    names = ("row", "column", "nnz", "library", "auto", "banded_row",
             "windowed_row")
    for name in names:
        strat = get_strategy(name)
        out = np.asarray(strat.spmm(strat.prepare(csr64, mesh), v, mesh))
        err = max_abs_error(out, oracle)
        ok = are_matrices_equal(out, oracle, tolerance=DEFAULT_ABS_TOL)
        log("contract", strategy=strat.name, dtype="float64", k=k,
            max_abs_error=err, tolerance=DEFAULT_ABS_TOL, same=ok)
        if not ok:
            raise AssertionError(f"{strat.name}: Results are different!")


def _gcn_problem(n: int, seed: int = 0):
    import jax.numpy as jnp

    from sparsematrixmultiplicationmpi_jax.models import (
        normalize_adjacency, synthetic_node_classification,
    )

    adj, x, labels, mask = synthetic_node_classification(
        n, 64, 8, seed=seed, dtype=jnp.float32)
    return normalize_adjacency(adj), x, labels, mask


def _gcn_step(spmm, x, labels, mask):
    import jax
    import optax

    from sparsematrixmultiplicationmpi_jax.models import (
        init_gcn, make_train_step,
    )

    params = init_gcn(jax.random.PRNGKey(0), x.shape[1], 32, 8,
                      x.dtype)
    opt = optax.adam(1e-2)
    step = jax.jit(make_train_step(spmm, opt))
    _, _, loss = step(params, opt.init(params), x, labels, mask)
    return float(loss)


def phase_gcn(n: int = 100_000):
    """One GCN training step through make_symmetric_spmm, vs the same
    step differentiated through the XLA path."""
    from sparsematrixmultiplicationmpi_jax.ops.auto import (
        auto_format, spmm_any,
    )
    from sparsematrixmultiplicationmpi_jax.ops.autodiff import (
        make_symmetric_spmm,
    )

    adj, x, labels, mask = _gcn_problem(n)
    op = auto_format(adj)
    t0 = time.perf_counter()
    loss = _gcn_step(make_symmetric_spmm(op), x, labels, mask)
    t_step = time.perf_counter() - t0
    loss_xla = _gcn_step(lambda v: spmm_any(op, v, use_pallas=False), x,
                         labels, mask)
    log("gcn", nodes=n, format=type(op).__name__, loss=loss,
        xla_loss=loss_xla, first_step_s=f"{t_step:.2f}")
    if not np.isfinite(loss):
        raise AssertionError(f"GCN step loss is not finite: {loss}")
    if abs(loss - loss_xla) > F32_TOL * max(abs(loss_xla), 1.0):
        raise AssertionError(f"GCN loss {loss} vs XLA path {loss_xla}")


def _device_ids(arr) -> list:
    return sorted(d.id for d in arr.sharding.device_set)


def phase_multi(csr, devices, ks=(1, 32), gcn_nodes: int = 100_000):
    """The distributed strategies on four devices, each vs its oracle."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sparsematrixmultiplicationmpi_jax.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_jax.models import (
        gcn_loss, init_gcn,
    )
    from sparsematrixmultiplicationmpi_jax.parallel import (
        Auto, BandedRowWise, ColumnWise, Grid2D, NonZeroElement, RowWise,
        WindowedRowWise, make_mesh, make_mesh_2d,
    )

    mesh = make_mesh(4, devices=devices)
    mesh2 = make_mesh_2d(2, 2, devices=devices)
    cases = [
        (RowWise(), True, mesh), (ColumnWise(), True, mesh),
        (NonZeroElement(reduce="psum"), True, mesh),
        (NonZeroElement(reduce="scatter"), False, mesh),
        (BandedRowWise(), True, mesh), (WindowedRowWise(), True, mesh),
        (Auto(), True, mesh), (Grid2D(), True, mesh2),
    ]
    for strat, gather, m in cases:
        t0 = time.perf_counter()
        op = strat.prepare(csr, m)
        prep = time.perf_counter() - t0
        for k in ks:
            v = jnp.asarray(generate_fat_vector(csr.shape[1], k, seed=3),
                            jnp.float32)
            out = strat.spmm(op, v, m, gather_result=gather)
            ids = _device_ids(out)
            err = _check_f32(np.asarray(out)[: csr.shape[0]], csr, v,
                             f"multi {strat.name} k={k}")
            log("multi", strategy=strat.name, k=k, gather=gather,
                prepare_s=f"{prep:.1f}", max_error=err, devices=ids)
            if len(ids) != 4:
                raise AssertionError(
                    f"{strat.name}: output on devices {ids}, not 4 cards")

    adj, x, labels, mask = _gcn_problem(gcn_nodes)
    loss_1dev = _gcn_step(lambda vv: _replicated_spmm(adj, vv), x, labels,
                          mask)
    row = RowWise()
    operand = row.prepare(adj, mesh)
    rep = NamedSharding(mesh, P())
    params = jax.device_put(
        init_gcn(jax.random.PRNGKey(0), x.shape[1], 32, 8, x.dtype), rep)
    opt = optax.adam(1e-2)
    opt_state = jax.device_put(opt.init(params), rep)
    x, labels, mask = (jax.device_put(a, rep) for a in (x, labels, mask))

    def spmm(vv):
        return row.spmm(operand, vv, mesh, gather_result=True)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(gcn_loss)(
            params, spmm, x, labels, mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, loss = step(params, opt_state)
    log("multi_gcn", nodes=gcn_nodes, loss=float(loss),
        single_device_loss=loss_1dev,
        devices=_device_ids(params.w1))
    if not np.isfinite(float(loss)) or abs(
            float(loss) - loss_1dev) > F32_TOL * max(abs(loss_1dev), 1.0):
        raise AssertionError(f"sharded GCN loss {float(loss)} vs "
                             f"single-device {loss_1dev}")
    log("multi_peak_bytes", per_device=_peak_bytes(devices))


def _replicated_spmm(adj, v):
    from sparsematrixmultiplicationmpi_jax.ops.oracle import spmm_coo

    return spmm_coo(adj.to_coo(), v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-GPU distributed phase")
    args = p.parse_args(argv)

    import jax

    from sparsematrixmultiplicationmpi_jax.io.generate import cop20k_like
    from sparsematrixmultiplicationmpi_jax.utils.cache import (
        enable_compile_cache,
    )

    dev = phase_device(expect_count=4 if args.multi else None)
    enable_compile_cache()
    t0 = time.perf_counter()
    csr = cop20k_like(dtype=np.float32)
    if args.multi:
        devices = jax.devices()[:4]
        phase_multi(csr, devices)
    else:
        op, _ = phase_bench(csr)
        phase_parity(csr, op)
        phase_formats(csr)
        phase_gcn()
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            phase_contract(cop20k_like(dtype=np.float64))
        finally:
            jax.config.update("jax_enable_x64", x64)
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
