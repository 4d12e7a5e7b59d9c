"""Hub-column extraction — rank-k dense correction over a sparse rest.

Circuit matrices (the reference's dc1 family, ``results/analysis.csv``)
have a few rail-net COLUMNS touching a large fraction of all nodes.
Every gather-path kernel pays per nonzero/slot for those columns, yet
their contribution to the product is a handful of rank-1 terms:

    out += A[:, j] (x) v[j, :]       for each hub column j

which batch into ONE dense ``(m, h) @ (h, k)`` matmul — dense work at
HBM-streaming cost (m*h*4 bytes read), orders of magnitude cheaper than
gathering the same nonzeros. The remainder (device stamps) goes to
whatever format the auto cost model picks for it. VERDICT r4 next #5:
the last family with no structure-exploiting path.

The extraction criterion is cost-based: column j is extracted when its
nonzero count exceeds the break-even ``m * 4 B / HBM_BW /
ELL_S_PER_SLOT`` (the dense column's stream cost vs the gather slots it
removes), capped at ``MAX_HUB_COLS`` columns to bound the dense bytes.

Replaces no single reference component — the reference runs dc1 through
the same four kernels as everything else (``main.cpp:162-280``) and its
data shows the family barely scales; exploiting the structure is the
point of this redesign.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import CSR, _register, _static_field

__all__ = ["HubExtracted", "split_hub_columns", "MAX_HUB_COLS"]

#: Dense-correction width cap: bounds the dense plane at m * 64 * 4 B
#: (~30 MB on the dc1 class) and keeps the matmul k-slab-sized.
MAX_HUB_COLS = 64


def split_hub_columns(csr: CSR, *, threshold: int, max_cols: int =
                      MAX_HUB_COLS):
    """Split ``csr`` into (hub_ids, dense_cols, remainder_csr).

    Returns ``None`` when no column's nonzero count reaches
    ``threshold``. ``dense_cols`` is the host-side ``(m, h)`` dense
    plane of the extracted columns (kept numpy — format constructors
    stay host-side); ``remainder_csr`` holds every other entry.
    """
    m, n = csr.shape
    if csr.nnz == 0:
        return None
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    vals = np.asarray(coo.values)
    from .matrix import coalesce_coo

    # The dense-column scatter below ASSIGNS — duplicate coordinates
    # must be summed first (same rule as the windowed densifier).
    i, j, vals = coalesce_coo(i, j, vals, n)
    counts = np.bincount(j, minlength=n)
    hub_ids = np.nonzero(counts >= max(int(threshold), 1))[0]
    if len(hub_ids) == 0:
        return None
    if len(hub_ids) > max_cols:
        order = np.argsort(-counts[hub_ids], kind="stable")
        hub_ids = np.sort(hub_ids[order[:max_cols]])
    sel = np.isin(j, hub_ids)
    dense = np.zeros((m, len(hub_ids)), dtype=vals.dtype)
    col_pos = np.searchsorted(hub_ids, j[sel])
    dense[i[sel], col_pos] = vals[sel]
    from .matrix import COO

    rem = COO.from_arrays(vals[~sel], i[~sel], j[~sel], (m, n)).to_csr()
    return hub_ids.astype(np.int32), dense, rem


@_register
@dataclasses.dataclass(frozen=True)
class HubExtracted:
    """Dense hub-column correction over an arbitrary remainder operand.

    ``remainder`` is any ``ops/auto.py::spmm_any``-dispatchable operand
    (built by the auto cost model on the post-extraction matrix);
    ``dense_cols[i, p]`` holds the entry at ``(i, hub_ids[p])``.
    """

    dense_cols: jax.Array           # (m, h)
    hub_ids: jax.Array              # (h,) int32
    remainder: Any
    shape: Tuple[int, int] = _static_field()
    est_seconds: float = _static_field(default=float("inf"))

    @property
    def n_hubs(self) -> int:
        return int(self.dense_cols.shape[1])

    def astype(self, dtype) -> "HubExtracted":
        rem = self.remainder
        if hasattr(rem, "astype"):
            rem = rem.astype(dtype)
        return dataclasses.replace(
            self, dense_cols=self.dense_cols.astype(dtype),
            remainder=rem)

    def to_dense(self) -> jax.Array:
        base = np.zeros(self.shape,
                        dtype=np.asarray(self.dense_cols).dtype)
        if hasattr(self.remainder, "to_dense"):
            base = base + np.asarray(self.remainder.to_dense())
        dc = np.asarray(self.dense_cols)
        ids = np.asarray(self.hub_ids)
        base[:, ids] += dc
        return jnp.asarray(base)

    def __matmul__(self, v):
        from ..ops.auto import spmm_any

        return spmm_any(self, v)
