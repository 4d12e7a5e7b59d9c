"""Sparse matrix containers as JAX pytrees.

Re-design of the reference's CSR container
(``Source Code/MatrixDefinitions.h:14-22``): the reference stores CSR as three
``std::vector``s and (in its shipped header) *forgets* the matrix dimensions —
``utils.cpp:180-181`` writes ``numRows``/``numCols`` fields that the committed
struct lacks. Here every container carries an explicit static ``shape`` so the
arrays can live inside ``jit``/``shard_map`` as pytree leaves while the shape
stays trace-time static (XLA needs static shapes).

Containers
----------
``CSR``   — compressed sparse row: ``values[nnz]``, ``col_indices[nnz]``,
            ``row_ptr[m+1]``. Canonical storage; mirrors the reference layout.
``COO``   — coordinate triplets sorted by row; the natural layout for the
            non-zero-element-parallel strategy
            (``SparseMatrixFatVectorMultiplyNonZeroElement.cpp:42-51`` builds
            exactly this row-index expansion from CSR on every call — here it
            is a first-class format built once).
``ELL``   — ELLPACK: row-padded ``(m, width)`` column/value planes. The
            gather-class compute layout: SpMM over ELL is gather + multiply +
            dense reduction over the width axis — *no scatter at all*, which
            is what XLA's fusion model wants.
``BucketedELL`` — SELL-style row bucketing: rows grouped by nnz into a few
            ELL buckets with different widths, plus a row permutation. Bounds
            padding waste on skewed matrices (power-law graphs) while keeping
            every shape static.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CSR", "COO", "ELL", "BucketedELL", "coalesce_coo"]


def coalesce_coo(i, j, vals, n: int):
    """Sum duplicate (row, col) coordinates — required before any
    DENSIFYING build (windowed tiles, banded blocks), whose scatter is an
    assignment: a duplicate entry would silently overwrite instead of
    accumulate, diverging from the oracle and every gather path (which
    sum duplicates naturally, matching ``CSR.to_dense``). No-op (and
    cheap: one uniqueness check) on canonical inputs."""
    key = i.astype(np.int64) * n + j
    uniq, first, inverse = np.unique(key, return_index=True,
                                     return_inverse=True)
    if len(uniq) == len(key):
        return i, j, vals
    summed = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(summed, inverse, vals.astype(np.float64))
    return (i[first], j[first], summed.astype(vals.dtype))


def _static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _host_array(x, dtype=None):
    """Keep format construction on the host: numpy arrays are valid pytree
    leaves and transfer to device lazily (at device_put/jit call time).
    Eager ``jnp.asarray`` here would round-trip every preprocessing step
    through the accelerator. Device
    arrays passed in are left where they are."""
    if isinstance(x, jax.Array):
        return x.astype(dtype) if dtype is not None and x.dtype != dtype else x
    return np.asarray(x, dtype=dtype)


def _register(cls):
    data_fields = [
        f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")
    ]
    meta_fields = [
        f.name for f in dataclasses.fields(cls) if f.metadata.get("static")
    ]
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    ``values[nnz]`` float, ``col_indices[nnz]`` int32, ``row_ptr[m+1]`` int32,
    plus a static ``shape=(m, n)`` (fixing the reference's stale-struct defect,
    ``MatrixDefinitions.h:14-19`` vs ``utils.cpp:180-181``).
    """

    values: jax.Array
    col_indices: jax.Array
    row_ptr: jax.Array
    shape: Tuple[int, int] = _static_field()

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, values=self.values.astype(dtype))

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_arrays(cls, values, col_indices, row_ptr, shape) -> "CSR":
        return cls(
            values=_host_array(values),
            col_indices=_host_array(col_indices, np.int32),
            row_ptr=_host_array(row_ptr, np.int32),
            shape=(int(shape[0]), int(shape[1])),
        )

    @classmethod
    def from_dense(cls, dense) -> "CSR":
        dense = np.asarray(dense)
        m, n = dense.shape
        rows, cols = np.nonzero(dense)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        values = dense[rows, cols]
        row_ptr = np.zeros(m + 1, dtype=np.int32)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr, dtype=np.int32)
        return cls.from_arrays(values, cols, row_ptr, (m, n))

    # ---- conversions --------------------------------------------------
    def to_dense(self) -> jax.Array:
        coo = self.to_coo()
        return coo.to_dense()

    def to_coo(self) -> "COO":
        m, _ = self.shape
        row_ptr = np.asarray(self.row_ptr)
        counts = np.diff(row_ptr)
        rows = np.repeat(np.arange(m, dtype=np.int32), counts)
        return COO(
            values=self.values,
            row_indices=_host_array(rows, np.int32),
            col_indices=self.col_indices,
            shape=self.shape,
        )

    def __matmul__(self, v):
        """``csr @ v`` — auto-formatted SpMM (``ops/auto.py``)."""
        from ..ops.auto import spmm

        return spmm(self, v)

    def row_lengths(self) -> np.ndarray:
        return np.diff(np.asarray(self.row_ptr))


@_register
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix, canonically sorted by (row, col).

    This is the layout the reference's non-zero-element kernel expands CSR
    into on every rank, every call
    (``SparseMatrixFatVectorMultiplyNonZeroElement.cpp:42-51``); here it is
    built once and reused.
    """

    values: jax.Array
    row_indices: jax.Array
    col_indices: jax.Array
    shape: Tuple[int, int] = _static_field()

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "COO":
        return dataclasses.replace(self, values=self.values.astype(dtype))

    @classmethod
    def from_arrays(cls, values, row_indices, col_indices, shape) -> "COO":
        return cls(
            values=_host_array(values),
            row_indices=_host_array(row_indices, np.int32),
            col_indices=_host_array(col_indices, np.int32),
            shape=(int(shape[0]), int(shape[1])),
        )

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((m, n), dtype=self.values.dtype)
        return out.at[self.row_indices, self.col_indices].add(self.values)

    def to_csr(self) -> CSR:
        m, _ = self.shape
        rows = np.asarray(self.row_indices)
        cols = np.asarray(self.col_indices)
        vals = np.asarray(self.values)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)
        return CSR.from_arrays(vals, cols, row_ptr, self.shape)

    def pad_to(self, nnz_padded: int) -> "COO":
        """Pad with explicit zeros at (0, 0) so nnz is shard/tile friendly."""
        pad = int(nnz_padded) - self.nnz
        if pad < 0:
            raise ValueError(f"nnz_padded={nnz_padded} < nnz={self.nnz}")
        if pad == 0:
            return self
        xp = np if isinstance(self.values, np.ndarray) else jnp
        z = xp.zeros((pad,), dtype=self.values.dtype)
        zi = xp.zeros((pad,), dtype=np.int32)
        return COO(
            values=xp.concatenate([self.values, z]),
            row_indices=xp.concatenate([self.row_indices, zi]),
            col_indices=xp.concatenate([self.col_indices, zi]),
            shape=self.shape,
        )


@_register
@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: each row padded to a common ``width``.

    ``cols[m_padded, width]`` (padding entries point at column 0),
    ``vals[m_padded, width]`` (padding entries are 0.0). ``num_rows`` rows are
    real; ``m_padded`` may exceed ``shape[0]`` for tile alignment.

    SpMM over this layout is ``sum_w vals[:, w, None] * v[cols[:, w], :]`` —
    one device-memory gather plus a dense reduction. No scatter, no
    dynamic shapes: exactly what XLA fuses well.
    """

    cols: jax.Array  # (m_padded, width) int32
    vals: jax.Array  # (m_padded, width) float
    shape: Tuple[int, int] = _static_field()

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def m_padded(self) -> int:
        return int(self.cols.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "ELL":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    @classmethod
    def from_csr(cls, csr: CSR, width: int | None = None,
                 row_align: int = 8, width_align: int = 1) -> "ELL":
        m, n = csr.shape
        lengths = csr.row_lengths()
        max_len = int(lengths.max()) if m else 0
        if width is None:
            width = max_len
        if width < max_len:
            raise ValueError(f"width={width} < max row nnz={max_len}")
        width = max(1, -(-width // width_align) * width_align)
        m_padded = max(row_align, -(-m // row_align) * row_align)

        cols = np.zeros((m_padded, width), dtype=np.int32)
        vals = np.zeros((m_padded, width), dtype=np.asarray(csr.values).dtype)
        row_ptr = np.asarray(csr.row_ptr)
        src_cols = np.asarray(csr.col_indices)
        src_vals = np.asarray(csr.values)
        # Vectorized scatter into the padded planes.
        rows = np.repeat(np.arange(m), lengths)
        offsets = np.arange(len(src_cols)) - np.repeat(row_ptr[:-1], lengths)
        cols[rows, offsets] = src_cols
        vals[rows, offsets] = src_vals
        return cls(cols=cols, vals=vals, shape=(m, n))

    def __matmul__(self, v):
        from ..ops.ell import spmm_ell

        return spmm_ell(self, v)

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((self.m_padded, n), dtype=self.vals.dtype)
        out = out.at[
            jnp.arange(self.m_padded)[:, None], self.cols
        ].add(self.vals)
        return out[:m]


@_register
@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """SELL-style bucketed ELLPACK.

    Rows are permuted so that rows of similar nnz land in the same bucket;
    each bucket is an independent dense ``ELL`` problem with its own width.
    ``row_perm[m_padded_total]`` maps concatenated bucket-row order back to
    original row ids (padding rows map to ``m``, one past the end, and are
    dropped on unpermute). Bounds the ELL padding blow-up on skewed
    (power-law) matrices — the static-shape answer to the reference's "non-zero
    element" load-balancing strategy's motivation.
    """

    buckets: Tuple[ELL, ...]
    row_perm: jax.Array  # (sum m_padded_b,) int32, value m == padding row
    inv_row_perm: jax.Array  # (m,) int32: original row -> concatenated slot
    shape: Tuple[int, int] = _static_field()

    @property
    def dtype(self):
        return self.buckets[0].dtype

    def astype(self, dtype) -> "BucketedELL":
        return dataclasses.replace(
            self, buckets=tuple(b.astype(dtype) for b in self.buckets)
        )

    @classmethod
    def from_csr(cls, csr: CSR, max_buckets: int = 10, row_align: int = 8,
                 width_align: int = 8) -> "BucketedELL":
        m, n = csr.shape
        lengths = csr.row_lengths()
        if m == 0:
            raise ValueError("empty matrix")
        # Bucket edges: geometric (x2) in row length. Rows with nnz in
        # (edge[i-1], edge[i]] go to bucket i. Finer buckets bound the ELL
        # padding blow-up (pad factor <= 2 within a bucket), which directly
        # bounds wasted gather traffic — the dominant cost of the gather path.
        max_len = max(int(lengths.max()), 1)
        edges = []
        w = width_align
        while w < max_len and len(edges) < max_buckets - 1:
            edges.append(w)
            w *= 2
        edges.append(max(-(-max_len // width_align) * width_align, width_align))

        order = np.argsort(lengths, kind="stable")
        sorted_lengths = lengths[order]
        buckets = []
        perms = []
        # Empty rows never enter a bucket: when this format stores a
        # spill remnant (most rows untouched — formats/windowed.py), they
        # would otherwise pad the narrowest bucket to m rows x width_align
        # slots and dominate the gather bill (measured 15.5x slot
        # inflation on the cop20k stand-in spill). ``inv_row_perm`` routes
        # them to a zero row appended by the consumer (ops/ell.py).
        start = int(np.searchsorted(sorted_lengths, 0, side="right"))
        if start >= m:  # all-empty matrix: keep one all-zero bucket
            start = m - 1
        for edge in edges:
            stop = int(np.searchsorted(sorted_lengths, edge, side="right"))
            if stop <= start:
                continue
            rows = order[start:stop]
            start = stop
            bucket_csr = _csr_take_rows(csr, rows)
            ell = ELL.from_csr(
                bucket_csr, width=edge, row_align=row_align,
                width_align=width_align,
            )
            # ELL.from_csr's shape[0] is the bucket row count; patch the
            # logical column count through and record the permutation.
            ell = dataclasses.replace(ell, shape=(len(rows), n))
            pad = ell.m_padded - len(rows)
            perms.append(
                np.concatenate([rows, np.full(pad, m)]).astype(np.int32)
            )
            buckets.append(ell)
        row_perm = np.concatenate(perms)
        # Rows absent from every bucket (empty rows) index one past the
        # concatenated bucket rows — consumers append a zero row there.
        inv_row_perm = np.full(m, len(row_perm), dtype=np.int32)
        real = row_perm < m
        inv_row_perm[row_perm[real]] = np.nonzero(real)[0].astype(np.int32)
        return cls(
            buckets=tuple(buckets),
            row_perm=row_perm,
            inv_row_perm=inv_row_perm,
            shape=(m, n),
        )

    def __matmul__(self, v):
        from ..ops.ell import spmm_bucketed

        return spmm_bucketed(self, v)

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        parts = []
        for b in self.buckets:
            d = jnp.zeros((b.m_padded, n), dtype=b.vals.dtype)
            d = d.at[jnp.arange(b.m_padded)[:, None], b.cols].add(b.vals)
            parts.append(d)
        stacked = jnp.concatenate(parts, axis=0)
        out = jnp.zeros((m + 1, n), dtype=stacked.dtype)
        out = out.at[self.row_perm].add(stacked)
        return out[:m]


def split_csr_by_width(csr: CSR, max_width: int):
    """Split into (head CSR with <= max_width nnz/row, tail COO of the
    overflow) — the HYB/hybrid decomposition. Prevents the single-width
    ELL padding blow-up on skewed (power-law) matrices, where one dense
    row would otherwise inflate the planes to m x max_row_nnz.

    Returns ``(head_csr, tail_coo_or_None)``. Host-side (build time).
    """
    m, n = csr.shape
    lengths = csr.row_lengths().astype(np.int64)
    if not len(lengths) or lengths.max() <= max_width:
        return csr, None
    row_ptr = np.asarray(csr.row_ptr).astype(np.int64)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values)
    pos_in_row = np.arange(csr.nnz) - np.repeat(row_ptr[:-1], lengths)
    head = pos_in_row < max_width
    head_lengths = np.minimum(lengths, max_width)
    head_ptr = np.concatenate([[0], np.cumsum(head_lengths)]).astype(np.int32)
    head_csr = CSR.from_arrays(vals[head], cols[head], head_ptr, (m, n))
    tail_rows = np.repeat(np.arange(m, dtype=np.int64), lengths)[~head]
    tail = COO.from_arrays(vals[~head], tail_rows, cols[~head], (m, n))
    return head_csr, tail


def _csr_take_rows(csr: CSR, rows: np.ndarray) -> CSR:
    """Host-side row-subset CSR (used at format-build time only)."""
    row_ptr = np.asarray(csr.row_ptr)
    src_cols = np.asarray(csr.col_indices)
    src_vals = np.asarray(csr.values)
    lengths = (row_ptr[1:] - row_ptr[:-1])[rows].astype(np.int64)
    starts = row_ptr[:-1][rows].astype(np.int64)
    total = int(lengths.sum())
    cum = np.concatenate([[0], np.cumsum(lengths)[:-1]]) if len(rows) else []
    within = np.arange(total) - np.repeat(cum, lengths)
    idx = np.repeat(starts, lengths) + within
    new_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return CSR.from_arrays(
        src_vals[idx], src_cols[idx], new_ptr, (len(rows), csr.shape[1])
    )
