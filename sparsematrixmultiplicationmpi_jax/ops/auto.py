"""Automatic format/kernel selection.

The reference makes the user pick a strategy per run (``./main`` runs all
four and prints a comparison, ``main.cpp:162-280`` — precisely because
none dominates). This framework decides from the matrix's structure with
a cost model of the device (``formats/windowed.py``'s constants and the
gather-class table in ``ops/_gather_calib.py``; both were fitted before
the GPU port, have not been measured on the H200, and wait for ROADMAP
Speed #6):

* **WindowedPairs** — dense (R, C) tiles over every region where tile
  streaming beats the per-row gather cost, RCM-reordered when that
  tightens the tiling; spill to bucketed ELL. Wins on mesh/FEM/banded
  structure (the cop20k_A class) and on clustered hubs.
* **BandedBlocks** — the fixed 3-block diagonal window specialization;
  kept for explicitly banded use (its halo structure also backs the
  multi-chip ``BandedRowWise`` ppermute strategy).
* **BucketedELL** — the gather path for scatter structure with row-length
  skew (power-law graphs), where densification loses everywhere.

Selection is by estimated per-SpMM seconds from the same cost model the
builders use, so "auto" is consistent end-to-end.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.banded import BandedBlocks
from ..formats.matrix import COO, BucketedELL, CSR
from ..formats.windowed import (
    GATHER_S_PER_ROW, HBM_BW, WindowedPairs,
)
from .banded import spmm_banded
from .ell import spmm_bucketed

__all__ = ["auto_format", "spmm_any", "spmm", "gather_class_estimates"]

AutoFormat = Union[WindowedPairs, BandedBlocks, BucketedELL, COO]

#: Best-case per-unit gather costs (fitted before the GPU port, not
#: measured on the H200 — ROADMAP Speed #6). The hub-extraction break-even uses
#: ELL_S_PER_SLOT as the cheapest a gathered slot can ever be; per-SpMM
#: ESTIMATES come from the calibrated table (``_calibrated_gather_
#: seconds``), since at large m these flat constants are optimistic.
COO_S_PER_NNZ = 11.5e-9
ELL_S_PER_SLOT = 2.5e-9


def _calib_model():
    """(per-path power-law coefficients, anchor features, residuals) —
    fit lazily from the embedded hardware table and cached."""
    global _CALIB_CACHE
    try:
        return _CALIB_CACHE
    except NameError:
        pass
    from ._gather_calib import GATHER_CALIB_RECORDS

    model = {}
    for path in ("coo", "ell"):
        rows = [r for r in GATHER_CALIB_RECORDS if r[0] == path]
        X = np.array([[1.0, np.log(w), np.log(m), np.log(k)]
                      for _, m, w, k, _ in rows])
        y = np.array([np.log(s) for *_, s in rows])
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        model[path] = (coef, X[:, 1:], y - X @ coef)
    _CALIB_CACHE = model
    return model


def _calibrated_gather_seconds(path: str, work: int, m: int,
                               k: int) -> float:
    """Measured-table estimate of one gather-path SpMM in seconds.

    Log-space power-law prior + inverse-distance-weighted residual
    correction over the 41-record anchor grid (``ops/_gather_calib.py``,
    fitted before the GPU port, not measured on the H200): exact on the anchors, and
    the power-law tail extrapolates the superlinearity in m instead of a
    flat per-unit cost.
    """
    coef, feats, resid = _calib_model()[path]
    x = np.array([1.0, np.log(max(work, 1)), np.log(max(m, 1)),
                  np.log(max(k, 1))])
    dist = np.linalg.norm(feats - x[1:], axis=1)
    w = 1.0 / (dist * dist + 1e-3)
    return float(np.exp(x @ coef + np.sum(w * resid) / np.sum(w)))


def gather_class_estimates(csr: CSR, k_nominal: int = 32):
    """Estimated per-SpMM seconds for the two gather-path formats,
    from the calibrated table (``_calibrated_gather_seconds``).

    The class choice the table encodes: COO+segment-sum wins on heavy
    slot inflation (power-law rows), bucketed ELL on mild skew. The
    windowed tiling gate takes this estimate as ``gather_baseline_s``.
    """
    bell = BucketedELL.from_csr(csr)
    padded_rows = sum(b.m_padded * b.width for b in bell.buckets)
    m = csr.shape[0]
    # The legacy linear model acts as a FLOOR under the calibrated
    # surface: below the table's smallest anchor (m = 20k) the fitted
    # power-law (m^0.5-0.8) extrapolates optimistically past the
    # per-unit costs the old fit measured at small scale, which flipped
    # fem3d-class routing away from windowed tiles. max() keeps the
    # calibrated values wherever the table dominates (every sweep
    # family) and the measured per-unit floor everywhere smaller.
    row_bytes = k_nominal * 4
    out_bytes = m * row_bytes / HBM_BW
    floor_bell = (padded_rows * ELL_S_PER_SLOT
                  + (padded_rows + m) * row_bytes / HBM_BW + out_bytes)
    floor_coo = (csr.nnz * COO_S_PER_NNZ
                 + 2 * csr.nnz * row_bytes / HBM_BW + out_bytes)
    est_bell = max(_calibrated_gather_seconds(
        "ell", padded_rows, m, k_nominal), floor_bell)
    est_coo = max(_calibrated_gather_seconds(
        "coo", csr.nnz, m, k_nominal), floor_coo)
    return {"bucketed_ell": (est_bell, bell),
            "coo": (est_coo, None)}


def auto_format(csr: CSR, *, reorder: str | None = "auto",
                allow_hub: bool = False, **format_kwargs) -> AutoFormat:
    """Pick the fastest storage for this matrix's structure by estimated
    per-SpMM cost under the cost model's constants.

    Windowed tiles when enough nonzeros cluster into dense tiles (after an
    optional RCM reorder); otherwise the cheaper of the two gather-path
    formats (bucketed ELL vs COO+segment-sum); band-dense remains for
    explicitly banded use. ``format_kwargs`` are forwarded to
    ``WindowedPairs.from_csr`` (e.g. ``block_rows``, ``candidates``).

    ``allow_hub=True`` opts into hub-column extraction (dense rank-h
    correction + auto-formatted remainder, the dc1 circuit class). It is
    OFF by default: it lost on the very class it targets when measured
    before the GPU port, because the gather class is ROW-bound, so removing hub
    *slots* barely cheapens the remainder while the rank-h correction
    adds dispatch and stream cost. Not measured on the H200.
    """
    op, _ = _auto_with_est(csr, reorder, format_kwargs,
                           allow_hub=allow_hub)
    return op


def _auto_with_est(csr: CSR, reorder, format_kwargs,
                   allow_hub: bool):
    """(operand, estimated seconds) — the recursive candidate search
    behind :func:`auto_format` (one level of hub recursion)."""
    import inspect

    def _route(fn):
        sig = inspect.signature(fn).parameters
        return {k: v for k, v in format_kwargs.items() if k in sig}

    k_nominal = format_kwargs.get("k_nominal", 32)
    ests = gather_class_estimates(csr, k_nominal=k_nominal)
    best_gather = min(ests.values(), key=lambda t: t[0])[0]

    def gather_op():
        name = min(ests, key=lambda nm: ests[nm][0])
        if name == "coo":
            return csr.to_coo()
        return ests["bucketed_ell"][1]

    candidates = [(best_gather, gather_op)]

    # Dense-tile candidates, both carrying the same est_seconds metric:
    # the general windowed tiles and the 3-block band specialization
    # (strictly cheaper per byte when the band alone covers the matrix —
    # auto picking windowed over banded on a pure-band SPD system ran
    # slower CG iterations). The windowed build gate compares against
    # THIS caller's real gather alternative, not its legacy
    # nnz*GATHER_S_PER_ROW baseline, which on diffuse high-m matrices
    # (roadnet class) refused tilings that beat every real gather path.
    wp_kwargs = _route(WindowedPairs.from_csr)
    wp_kwargs.setdefault("gather_baseline_s", best_gather)
    wp = WindowedPairs.from_csr(csr, reorder=reorder, **wp_kwargs)
    bb = BandedBlocks.from_csr(csr, **_route(BandedBlocks.from_csr))
    dense_candidates = [f for f in (wp, bb) if f is not None]
    if dense_candidates:
        best_dense = min(dense_candidates, key=lambda f: f.est_seconds)
        candidates.append((best_dense.est_seconds, lambda: best_dense))

    if allow_hub:
        # Hub-column extraction (the dc1 circuit class): a column with
        # c_j nonzeros costs ~c_j gather slots on every multiply but
        # only m*4 B of dense streaming as a rank-1 term — break-even
        # at c_j ~ m*4B / HBM_BW / ELL_S_PER_SLOT. One recursion level
        # formats the remainder.
        from ..formats.hub import HubExtracted, split_hub_columns

        m, _ = csr.shape
        threshold = max(int(m * 4 / HBM_BW / ELL_S_PER_SLOT), 32)
        split = split_hub_columns(csr, threshold=threshold)
        if split is not None:
            hub_ids, dense_cols, rem = split
            rem_op, rem_est = _auto_with_est(
                rem, reorder, format_kwargs, allow_hub=False)
            h = len(hub_ids)
            hub_cost = (m * h + h * k_nominal) * 4 / HBM_BW
            est = rem_est + hub_cost

            def hub_op():
                return HubExtracted(
                    dense_cols=dense_cols, hub_ids=hub_ids,
                    remainder=rem_op, shape=csr.shape,
                    est_seconds=est)

            candidates.append((est, hub_op))

    best_est, builder = min(candidates, key=lambda t: t[0])
    return builder(), best_est


def spmm_any(operand: AutoFormat, v: jax.Array,
             use_pallas: bool | None = None) -> jax.Array:
    """Dispatch SpMM on the operand's format (trace-time, zero overhead).

    ``use_pallas`` applies to ``WindowedPairs`` operands
    (``ops/windowed.py::spmm_windowed_core``): ``None`` takes the fused
    Triton kernel on the GPU where it applies and the XLA path
    elsewhere. Every other format runs its XLA path. Iterative consumers should use the operand's
    ``encode``/``iterate``/``decode`` protocol where available instead of
    paying any boundary transforms per call.
    """
    from ..formats.hub import HubExtracted

    if isinstance(operand, HubExtracted):
        # Rank-h dense correction: one (m, h) @ (h, k) matmul over the
        # hub columns' values plus the remainder's own path. f32 needs
        # HIGHEST (the GPU default may run f32 inputs as TF32).
        base = spmm_any(operand.remainder, v, use_pallas=use_pallas)
        vh = jnp.take(v, operand.hub_ids, axis=0)
        dc = operand.dense_cols
        if dc.dtype != v.dtype:
            vh = vh.astype(dc.dtype)
        prec = (jax.lax.Precision.HIGHEST
                if dc.dtype == jnp.float32 else
                jax.lax.Precision.DEFAULT)
        corr = jax.lax.dot_general(
            jnp.asarray(dc), vh,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=base.dtype, precision=prec)
        return base + corr
    if isinstance(operand, WindowedPairs):
        from .windowed import spmm_windowed

        return spmm_windowed(operand, v, use_pallas=use_pallas)
    if isinstance(operand, BandedBlocks):
        return spmm_banded(operand, v)
    if isinstance(operand, BucketedELL):
        return spmm_bucketed(operand, v)
    if isinstance(operand, COO):
        from .oracle import spmm_coo

        return spmm_coo(operand, v)
    try:
        from jax.experimental import sparse as jsparse

        if isinstance(operand, jsparse.BCOO):
            from .library import spmm_bcoo

            return spmm_bcoo(operand, v)
    except ImportError:  # pragma: no cover
        pass
    raise TypeError(f"unsupported operand format: {type(operand)}")


def spmm(csr: CSR, v: jax.Array) -> jax.Array:
    """One-shot convenience: auto-format then multiply."""
    return spmm_any(auto_format(csr), v)
