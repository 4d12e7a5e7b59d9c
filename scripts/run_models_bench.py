#!/usr/bin/env python
"""Model-level GPU benchmarks: GCN training, CG solve, PageRank.

Run from the repo root on a GPU machine:
    python scripts/run_models_bench.py
Writes results/models.json, labelled with the device kind.
"""
import json, time
import jax, jax.numpy as jnp, numpy as np, optax
from sparsematrixmultiplicationmpi_jax.formats.banded import BandedBlocks
from sparsematrixmultiplicationmpi_jax.formats.matrix import BucketedELL
from sparsematrixmultiplicationmpi_jax.io.generate import banded_csr, cop20k_like
from sparsematrixmultiplicationmpi_jax.models import (
    init_gcn, make_train_step, normalize_adjacency, pagerank,
    synthetic_node_classification, conjugate_gradient)
from sparsematrixmultiplicationmpi_jax.models.pagerank import _normalize_columns
from sparsematrixmultiplicationmpi_jax.ops.auto import auto_format, spmm_any
from sparsematrixmultiplicationmpi_jax.ops.autodiff import make_symmetric_spmm

results = {}

# ---- GCN training on a 100k-node graph --------------------------------
n, f, h, c = 100_000, 64, 128, 16
adj, x, labels, mask = synthetic_node_classification(n, f, c, avg_degree=16, seed=1)
operand = jax.device_put(
    jax.tree.map(lambda a: a.astype(np.float32) if a.dtype.kind == "f" else a,
                 auto_format(normalize_adjacency(adj), k_nominal=128)), jax.devices()[0])
print("gcn operand:", type(operand).__name__, flush=True)
spmm = make_symmetric_spmm(operand)
params = init_gcn(jax.random.PRNGKey(0), f, h, c)
opt = optax.adam(1e-2)
opt_state = opt.init(params)
step = jax.jit(make_train_step(spmm, opt))
params, opt_state, loss = step(params, opt_state, x, labels, mask)  # compile
float(loss)
N = 20
t0 = time.perf_counter()
for _ in range(N):
    params, opt_state, loss = step(params, opt_state, x, labels, mask)
lv = float(loss)  # fetch = fence
dt = (time.perf_counter() - t0) / N
results["gcn_train_100k_nodes"] = {
    "step_ms": round(dt*1e3, 2), "steps_per_s": round(1/dt, 1),
    "nodes": n, "edges": adj.nnz, "hidden": h, "loss_finite": bool(np.isfinite(lv))}
print(results["gcn_train_100k_nodes"], flush=True)

# ---- CG solve on a 121k SPD banded system -----------------------------
spd_csr = banded_csr(121_192, 60, 12, seed=2)
import dataclasses
coo = spd_csr.to_coo()
i, j = np.asarray(coo.row_indices), np.asarray(coo.col_indices)
vals = np.abs(np.asarray(coo.values))
from sparsematrixmultiplicationmpi_jax.io.mtx import expand_and_build_csr
sym = expand_and_build_csr(np.concatenate([i, j]), np.concatenate([j, i]),
                           np.concatenate([vals, vals]) * 0.01,
                           121_192, 121_192, False)
deg = np.zeros(121_192); np.add.at(deg, np.asarray(sym.to_coo().row_indices), np.abs(np.asarray(sym.values)))
diag_boost = expand_and_build_csr(np.arange(121_192), np.arange(121_192), deg + 1.0, 121_192, 121_192, False)
spd = expand_and_build_csr(
    np.concatenate([np.asarray(sym.to_coo().row_indices), np.arange(121_192)]),
    np.concatenate([np.asarray(sym.to_coo().col_indices), np.arange(121_192)]),
    np.concatenate([np.asarray(sym.values), deg + 1.0]),
    121_192, 121_192, False).astype(jnp.float32)
op2 = jax.device_put(auto_format(spd), jax.devices()[0])
print("cg operand:", type(op2).__name__, flush=True)
spmm2 = lambda v: spmm_any(op2, v)
b = jnp.asarray(np.random.default_rng(3).normal(size=(121_192, 8)), jnp.float32)
solve = jax.jit(lambda bb: conjugate_gradient(spmm2, bb, tol=1e-5, max_iter=200))
res = solve(b); float(res.residual_norm)
t0 = time.perf_counter()
res = solve(b)
rn = float(res.residual_norm); iters = int(res.iterations)
dt = time.perf_counter() - t0
results["cg_solve_121k"] = {
    "solve_ms": round(dt*1e3, 1), "iterations": iters,
    "ms_per_iteration": round(dt*1e3/max(iters,1), 3),
    "residual": rn, "rhs_columns": 8}
print(results["cg_solve_121k"], flush=True)

# ---- PageRank on cop20k-scale graph -----------------------------------
g = cop20k_like(seed=4)
g = dataclasses.replace(g, values=np.abs(np.asarray(g.values)))
norm = _normalize_columns(g).astype(jnp.float32)
op3 = jax.device_put(auto_format(norm, k_nominal=1), jax.devices()[0])
spmm3 = lambda v: spmm_any(op3, v)
@jax.jit
def pr(op):
    return pagerank(lambda v: spmm_any(op, v), norm.shape[0],
                    tol=1e-7, max_iter=100, dtype=jnp.float32)
r, it = pr(op3); float(r[0])
t0 = time.perf_counter()
r, it = pr(op3)
s = float(r.sum()); it = int(it)
dt = time.perf_counter() - t0

# Steady-state per-iteration cost via the two-point slope (the single
# while-loop dispatch above includes dispatch/fetch latency): run
# fixed-iteration variants at two chain lengths; the slope cancels every
# per-dispatch cost.
import functools

@functools.partial(jax.jit, static_argnums=1)
def pr_fixed(op, iters):
    return pagerank(lambda v: spmm_any(op, v), norm.shape[0],
                    tol=0.0, max_iter=iters, dtype=jnp.float32)

def timed_fixed(iters_n):
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        rr, _ = pr_fixed(op3, iters_n)
        float(rr[0])  # value fetch: a true completion barrier
        best = min(best, time.perf_counter() - t0)
    return best

for n_it in (10, 60):
    pr_fixed(op3, n_it)  # compile
t10, t60 = timed_fixed(10), timed_fixed(60)
per_iter_ms = (t60 - t10) / 50 * 1e3

results["pagerank_121k"] = {
    "total_ms": round(dt*1e3, 1), "iterations": it,
    "ms_per_iteration_steady": round(per_iter_ms, 3),
    "dispatch_overhead_ms": round(t10*1e3 - 10*per_iter_ms, 1),
    "rank_sum": round(s, 6)}
print(results["pagerank_121k"], flush=True)

with open("results/models.json", "w") as fo:
    json.dump({"hardware": jax.devices()[0].device_kind, "dtype": "float32",
               **results}, fo, indent=2)
print("wrote results/models.json", flush=True)
