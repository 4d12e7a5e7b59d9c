"""Band-dense hybrid storage — the dense-matmul SpMM format.

XLA's row gather is per-row-overhead bound rather than bandwidth bound, so
every gather-based sparse format (ELL/COO/CSR) pays per row. Dense matmuls
run at the device's streaming rate, so for matrices with diagonal locality
(FEM meshes, banded systems — the reference's headline cop20k_A class)
this format *densifies the band* and turns SpMM into batched dense
matmuls:

    out[b] = band[b] @ window[b]        # (R, 3R) @ (3R, k)

where row-block ``b`` covers rows ``[bR, (b+1)R)`` and its window covers
fat-vector rows ``[(b-1)R, (b+2)R)`` — the block and its two neighbors.
Zero gathers, zero scatters, static shapes; the window structure is exactly
a halo exchange, so the row-sharded multi-device version maps onto
neighbor ``ppermute``s.

Off-band entries spill into a ``BucketedELL`` (gather path) — the classic
HYB/DIA split, re-derived for this framework's cost model. ``from_csr`` picks the
block size from the matrix's band-coverage profile and refuses (returns
``None``) when densification would waste more than it saves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import BucketedELL, CSR, _register, _static_field

__all__ = ["BandedBlocks", "band_coverage"]


def band_coverage(csr: CSR, block_rows: int) -> float:
    """Fraction of nnz that fall inside the 3-block halo window."""
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    b = i // block_rows
    w = j - (b - 1) * block_rows
    in_band = (w >= 0) & (w < 3 * block_rows)
    return float(in_band.mean()) if len(i) else 0.0


@_register
@dataclasses.dataclass(frozen=True)
class BandedBlocks:
    """Dense banded row-blocks plus sparse spill.

    ``band[nb, R, 3R]``: dense values; ``band[b, r, w]`` holds the entry at
    global ``(b*R + r, (b-1)*R + w)``. ``spill`` carries off-band nonzeros
    (``None`` when the matrix is purely banded).
    """

    band: jax.Array
    spill: Optional[BucketedELL]
    shape: Tuple[int, int] = _static_field()
    block_rows: int = _static_field()
    #: Cost-model per-SpMM estimate (same metric as
    #: ``WindowedPairs.est_seconds`` — ``auto_format`` compares them).
    est_seconds: float = _static_field(default=float("inf"))

    @property
    def dtype(self):
        return self.band.dtype

    @property
    def n_blocks(self) -> int:
        return int(self.band.shape[0])

    def astype(self, dtype) -> "BandedBlocks":
        return dataclasses.replace(
            self,
            band=self.band.astype(dtype),
            spill=None if self.spill is None else self.spill.astype(dtype),
        )

    @property
    def dense_bytes(self) -> int:
        return int(self.band.size) * self.band.dtype.itemsize

    @classmethod
    def from_csr(cls, csr: CSR, block_rows: Optional[int] = None, *,
                 candidates=(128, 256, 512), min_coverage: float = 0.5,
                 max_inflation: float = 64.0,
                 hbm_bw: float = 819e9,
                 gather_ns_per_row: float = 1.6,
                 k_nominal: int = 32) -> Optional["BandedBlocks"]:
        """Build band-dense storage, choosing ``block_rows`` by a cost
        model: estimated time = dense-band streaming traffic at memory
        bandwidth + spilled rows at the per-row gather cost (gathers are
        row-overhead-bound, not bandwidth-bound). The default constants
        were fitted before the GPU port and are not measured on the H200
        (ROADMAP Speed #6). Returns ``None`` when every candidate loses to
        the pure gather path or violates ``min_coverage``/``max_inflation``
        (caller falls back to a gather format)."""
        m, n = csr.shape
        itemsize = np.asarray(csr.values).dtype.itemsize
        nnz = max(csr.nnz, 1)
        if block_rows is None:
            from .windowed import SPILL_RESTORE_S_PER_ROW

            gather_time = nnz * gather_ns_per_row * 1e-9  # pure-ELL estimate
            best = None
            vb = nnz * itemsize
            for r in candidates:
                if r > max(m, 8):
                    continue
                cov = band_coverage(csr, r)
                nb = -(-m // r)
                dense_bytes = nb * r * 3 * r * itemsize
                # Any nonzero spill pays the fixed m-row restore take —
                # a wider spill-free window often beats a tighter one
                # with stragglers (fem_banded: r=256 at 1.0 coverage
                # estimates 0.42 ms vs r=128 at 0.987 costing 0.67 ms).
                spill_nnz = (1.0 - cov) * nnz
                spill_s = spill_nnz * gather_ns_per_row * 1e-9
                if spill_nnz > 0.05 * nnz:
                    # Same round-5 ladder lesson as WindowedPairs: the
                    # linear per-entry constant underprices a bucketed-
                    # ELL spill several-fold on mixed structure; price
                    # a nontrivial spill with the calibrated surface
                    # (1.6x = scattered-spill slot inflation,
                    # results/gather_calib3.json).
                    from ..ops.auto import _calibrated_gather_seconds

                    spill_s = max(spill_s, _calibrated_gather_seconds(
                        "ell", int(spill_nnz * 1.6), m, k_nominal))
                est = (dense_bytes / hbm_bw
                       + spill_s
                       + (m * SPILL_RESTORE_S_PER_ROW if cov < 1.0
                          else 0.0))
                if (cov >= min_coverage and dense_bytes <= max_inflation * vb
                        and est < gather_time):
                    if best is None or est < best[0]:
                        best = (est, r)
            if best is None:
                return None
            block_rows = best[1]
        r = int(block_rows)
        if r % 8:
            raise ValueError(f"block_rows must be a multiple of 8, got {r}")
        nb = max(-(-m // r), 1)

        coo = csr.to_coo()
        i = np.asarray(coo.row_indices).astype(np.int64)
        j = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        from .matrix import coalesce_coo

        # The band scatter below assigns — duplicate coordinates must be
        # summed first to match the oracle/gather semantics.
        i, j, vals = coalesce_coo(i, j, vals, n)
        b = i // r
        w = j - (b - 1) * r
        in_band = (w >= 0) & (w < 3 * r)

        band = np.zeros((nb, r, 3 * r), dtype=vals.dtype)
        band[b[in_band], i[in_band] % r, w[in_band]] = vals[in_band]

        spill = None
        n_out = int((~in_band).sum())
        if n_out:
            from .matrix import COO

            spill_coo = COO.from_arrays(
                vals[~in_band], i[~in_band], j[~in_band], (m, n)
            )
            # Spill rows are short (off-band stragglers): fine-grained
            # bucket widths cut padded gather rows by ~30 % — and the
            # gather is per-row-cost-bound, so that is a direct speedup.
            spill = BucketedELL.from_csr(
                spill_coo.to_csr(), width_align=4, max_buckets=12
            )
        # Comparable-to-WindowedPairs per-SpMM estimate (k-aware): band
        # bytes + three shifted fat-vector views + output at HBM rate,
        # spilled nnz at the measured gather cost, plus the fixed m-row
        # spill-restore take when any spill exists.
        from .windowed import (
            GATHER_S_PER_ROW, HBM_BW, SPILL_RESTORE_S_PER_ROW,
        )

        row_bytes = k_nominal * 4
        spill_s = n_out * GATHER_S_PER_ROW
        if n_out > 0.05 * nnz:
            # Calibrated spill pricing (round-5 ladder; see the shape
            # search above).
            from ..ops.auto import _calibrated_gather_seconds

            spill_s = max(spill_s, _calibrated_gather_seconds(
                "ell", int(n_out * 1.6), m, k_nominal))
        est = (band.nbytes / HBM_BW
               + 4 * m * row_bytes / HBM_BW
               + spill_s
               + (m * SPILL_RESTORE_S_PER_ROW if n_out else 0.0))
        return cls(band=band, spill=spill, shape=(m, n), block_rows=r,
                   est_seconds=float(est))

    def __matmul__(self, v):
        from ..ops.banded import spmm_banded

        return spmm_banded(self, v)

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        r = self.block_rows
        nb = self.n_blocks
        out = np.zeros((m, n), dtype=np.asarray(self.band).dtype)
        band = np.asarray(self.band)
        for b in range(nb):
            for w_start in range(3):
                cols = (b - 1 + w_start) * r
                if cols < 0 or cols >= n:
                    lo = max(cols, 0)
                    hi = min(cols + r, n)
                    if lo >= hi:
                        continue
                else:
                    lo, hi = cols, min(cols + r, n)
                rows_hi = min((b + 1) * r, m)
                out[b * r: rows_hi, lo:hi] += band[
                    b, : rows_hi - b * r,
                    w_start * r + (lo - cols): w_start * r + (hi - cols),
                ]
        if self.spill is not None:
            out = out + np.asarray(self.spill.to_dense())
        return jnp.asarray(out)
