"""Windowed tile-pair storage — the general dense-tile sparse format.

Round 1's ``BandedBlocks`` (``formats/banded.py``) densifies a fixed
3-block diagonal window, which works only for matrices whose nonzeros hug
the diagonal. Real FEM matrices — the reference's headline cop20k_A class
(``report/425500_Report.tex:687``) — have a *hollow* band after
bandwidth-reducing reordering: each row couples to a near-diagonal cluster
plus clusters at ± one mesh plane (O(m^(2/3)) away), so a contiguous
window either misses most nonzeros or explodes in size.

This format generalizes the idea: the matrix is cut into ``R x C`` tiles
(``R`` = block_rows, ``C`` = chunk_cols), and every tile that holds enough
nonzeros to beat the cost of gathering them row by row is stored *dense*
as one ``(R, C)`` tile in a flat pair list:

    tiles[p]       : (R, C) dense values
    pair_block[p]  : which row block  (sorted ascending)
    pair_chunk[p]  : which column chunk

SpMM is then ``out[pair_block[p]] += tiles[p] @ v[pair_chunk[p]*C :][:C]``
— dense matmuls over contiguous fat-vector slabs, zero per-nonzero
gathers, zero scatters, static shapes. Tiles below the cost threshold
spill to the bucketed-ELL gather path, which the cost model keeps tiny on
mesh-structured matrices (<1 % of nnz on the cop20k stand-in).

The flat pair list (instead of per-block window arrays) means **no
padding at all** across the skewed per-block window counts, and maps
directly onto the fused kernel (``ops/pallas_windowed.py``), whose
program for row block ``b`` walks the contiguous pair run
``block_ptr[b]:block_ptr[b+1]``.

An optional symmetric permutation (RCM by default for square matrices —
``formats/reorder.py``) is applied at build time and carried in the
operand; ``encode``/``iterate``/``decode`` expose the permuted-space
multiply so iterative consumers (solvers, PageRank, the amortized
benchmark) pay the boundary permutes once, exactly as the reference's
PETSc yardstick "wins because it never regathers"
(``report/425500_Report.tex:1092-1095``).

Replaces the reference's row-wise/non-zero-element hot loops
(``SparseMatrixFatVectorMultiplyRowWise.cpp:36-50``,
``...NonZeroElement.cpp:54-67``) with a dense-tile design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matrix import BucketedELL, CSR, _register, _static_field

__all__ = ["WindowedPairs", "windowed_cost_estimate", "windowed_wins",
           "DEFAULT_CANDIDATES"]

#: Default (R, C) tile-shape candidates for the build-time cost search.
DEFAULT_CANDIDATES = ((64, 256), (128, 256), (256, 256),
                      (128, 512), (256, 512), (512, 512),
                      (64, 128), (128, 128), (256, 128),
                      (8, 128), (16, 128), (32, 128))

# Cost-model constants. They were fitted before the GPU port, have not
# been measured on the H200, and are provisional inputs to the tile-shape search and to
# Auto's routing until they are refit on the GPU (ROADMAP Speed #6).
HBM_BW = 819e9                   # streaming bytes/s
GATHER_S_PER_ROW = 1.6e-9        # one gathered fat-vector row
TILE_OVERHEAD_S = 191e-9         # per step, two-pair schedule
TILE_STREAM_BW = 758e9           # tile + slab bytes/s
#: Pairs per step the cost model and the build's padding assume.
PRODUCTION_PAIRS_PER_STEP = 16
TMULTI_STEP_S = 77e-9            # per step, U-pair schedule
TMULTI_PAIR_S = 29e-9            # per pair, U-pair schedule
SPILL_RESTORE_S_PER_ROW = 3.5e-9  # spill restore take, per output row
#: Auto-search refuses tilings whose optimal split spills more than this
#: fraction of nnz: windowed is then the wrong class and the linear spill
#: term misses several-fold. Callers pinning ``block_rows`` bypass the
#: guard (explicit spill-path tests).
SPILL_FRAC_REFUSE = 0.65
#: Densification memory guards on the CPU, where the device reports no
#: memory limit. Below the allowance the DEFAULT ``max_inflation`` ratio
#: is not enforced (the cost model already prices the streamed bytes; a
#: diffuse small-nnz matrix may densify 100x into a harmless few GB); a
#: caller-SUPPLIED ``max_inflation`` is strict. The hard cap always binds.
DENSE_BYTES_ALLOWANCE = 2_000_000_000
DENSE_BYTES_HARD_CAP = 6_000_000_000


def dense_bytes_limits() -> Tuple[int, int]:
    """``(allowance, hard_cap)`` for the dense tile array: the CPU values
    above, or an eighth and three eighths of the device's memory limit
    (``memory_stats()["bytes_limit"]``) on a device that reports one."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return DENSE_BYTES_ALLOWANCE, DENSE_BYTES_HARD_CAP
    return int(limit) // 8, 3 * int(limit) // 8


def _pair_cost_s(R: int, C: int, itemsize: int, k_nominal: int,
                 pairs_per_step: int = 2) -> float:
    """Cost of one dense tile: fixed overheads plus tile and
    fat-vector-slab bytes at the streaming rate.

    U <= 2: per-step fixed cost ``2*TILE_OVERHEAD_S`` split across the
    step's two pairs. U > 2: per-step ``TMULTI_STEP_S`` divided by U plus
    a per-pair cost ``TMULTI_PAIR_S`` (the binding constant for fine
    tiles)."""
    stream = (R * C + C * k_nominal) * itemsize / TILE_STREAM_BW
    if pairs_per_step > 2:
        return (TMULTI_STEP_S / pairs_per_step + TMULTI_PAIR_S
                + stream)
    return TILE_OVERHEAD_S * 2 / pairs_per_step + stream


def _pair_counts(i, j, R: int, C: int, n_chunks: int):
    """Unique (row-block, column-chunk) pairs with nnz counts."""
    key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
    uniq, inverse, counts = np.unique(
        key, return_inverse=True, return_counts=True
    )
    return key, uniq, inverse, counts


def windowed_cost_estimate(i, j, m: int, n: int, R: int, C: int,
                           itemsize: int, k_nominal: int = 32,
                           pairs_per_step: int = 2,
                           allow_spill: bool = True):
    """Estimated per-SpMM seconds for tile size (R, C) with the GLOBAL
    optimal dense/spill split, plus the count threshold and tile stats.
    ``allow_spill=False`` forces every nonempty tile dense (spill-free
    builds).

    Tiles are sorted by nnz count; the exact total-cost curve over "top
    t tiles dense, rest spills" is minimized:

        total(t) = t * pair_stream_cost + spill_nnz(t) * gather_cost
                   + [spill_nnz(t) > 0] * m * restore_cost + output write

    The fixed m-row spill-restore term means the optimum sometimes lands
    at zero spill (every nonempty tile dense) — a per-tile marginal rule
    can never choose that. Pure host-side numpy (build-time only).
    """
    n_chunks = -(-n // C)
    _, uniq, _, counts = _pair_counts(i, j, R, C, n_chunks)
    pair_cost = _pair_cost_s(R, C, itemsize, k_nominal, pairs_per_step)
    order = np.argsort(-counts, kind="stable")
    cs = counts[order]
    spill_after = np.concatenate([cs[::-1].cumsum()[::-1], [0]])
    t_axis = np.arange(len(cs) + 1)
    totals = (t_axis * pair_cost
              + spill_after * GATHER_S_PER_ROW
              + (spill_after > 0) * m * SPILL_RESTORE_S_PER_ROW)
    best_t = int(np.argmin(totals)) if allow_spill else len(cs)
    est = float(totals[best_t]) + m * k_nominal * 4 / HBM_BW
    dense = np.zeros(len(counts), dtype=bool)
    dense[order[:best_t]] = True
    threshold = float(cs[best_t - 1]) if best_t else np.inf
    return est, threshold, dense, uniq, counts


def build_dense_pairs(i, j, vals, m: int, n: int, R: int, C: int,
                      itemsize: int, k_nominal: int = 32,
                      pairs_per_step: int = 2):
    """Identify above-threshold (row-block, column-chunk) tiles and
    materialize them, block-sorted.

    Returns ``(pb_raw, pc_raw, tiles_raw, spill_idx)`` where ``pb_raw``/
    ``pc_raw``/``tiles_raw`` are the P_raw dense tiles in ascending
    (block, chunk) order and ``spill_idx`` indexes the entries of
    ``(i, j, vals)`` that fall below the dense threshold. Shared by
    ``WindowedPairs.from_csr`` (block-run pointers on top) and the
    row-sharded distributed strategy (device-range splitting on top).

    ``(i, j)`` must be duplicate-free (``coalesce_coo``): the dense-tile
    scatter assigns, so a duplicate coordinate would overwrite instead
    of accumulate.
    """
    n_chunks = -(-n // C)
    _, _, dense, uniq, counts = windowed_cost_estimate(
        i, j, m, n, R, C, itemsize, k_nominal, pairs_per_step)

    key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
    pair_of_entry = np.searchsorted(uniq, key)
    dense_ids = np.nonzero(dense)[0]
    remap = np.full(len(uniq), -1, dtype=np.int64)
    remap[dense_ids] = np.arange(len(dense_ids))
    p_entry = remap[pair_of_entry]
    in_dense = p_entry >= 0

    P_raw = len(dense_ids)
    tiles_raw = np.zeros((P_raw, R, C), dtype=vals.dtype)
    tiles_raw[p_entry[in_dense], i[in_dense] % R, j[in_dense] % C] = \
        vals[in_dense]
    pb_raw = (uniq[dense_ids] // n_chunks).astype(np.int64)
    pc_raw = (uniq[dense_ids] % n_chunks).astype(np.int64)
    return pb_raw, pc_raw, tiles_raw, np.nonzero(~in_dense)[0]


def _search_tilings(csr: "CSR", i0, j0, *, block_rows=None,
                    chunk_cols=None, reorder="auto",
                    candidates=DEFAULT_CANDIDATES, k_nominal: int = 32,
                    max_inflation: Optional[float] = None,
                    beat_gather_margin: float = 0.8,
                    pairs_per_step: int = 2,
                    gather_baseline_s: Optional[float] = None,
                    allow_spill: bool = True):
    """Cost-model search over tile shapes x orderings (host-side numpy).

    Returns the winning ``(est, R, C, perm, i, j, dense, uniq, counts)``
    tuple, or ``None`` when no configuration beats the gather-path
    baseline by ``beat_gather_margin`` (or no tile clears the dense
    threshold) — the caller then falls back to a gather format.

    ``gather_baseline_s`` is the seconds-per-SpMM the caller's actual
    gather alternative would cost (``ops/auto.py::
    gather_class_estimates``); default is the legacy optimistic
    ``nnz * GATHER_S_PER_ROW``. The distinction matters on diffuse
    high-m matrices (roadnet class): the legacy baseline is ~4-10x
    rosier than any real gather path there, so the gate refused tilings
    that beat every real alternative.
    """
    m, n = csr.shape
    itemsize = np.asarray(csr.values).dtype.itemsize
    # None = default ratio with the small-matrix byte allowance; an
    # explicit caller value is a strict memory bound.
    allowance, hard_cap = dense_bytes_limits()
    ratio_cap = 96.0 if max_inflation is None else float(max_inflation)
    if max_inflation is not None:
        allowance = 0

    tile_shapes = []
    for cand in candidates:
        r_c = (cand, 128) if isinstance(cand, int) else tuple(cand)
        r_cand, c_cand = r_c
        if block_rows is not None:
            r_cand = int(block_rows)
        if chunk_cols is not None:
            c_cand = int(chunk_cols)
        if r_cand < 1 or c_cand < 1:
            raise ValueError(f"tile shape must be positive, got {r_c}")
        if r_cand > max(m, 8):
            continue
        if (r_cand, c_cand) not in tile_shapes:
            tile_shapes.append((r_cand, c_cand))
    if not tile_shapes and block_rows is not None:
        tile_shapes = [(int(block_rows), int(chunk_cols or 128))]

    # Candidate orderings: as-given, plus RCM for square matrices.
    orderings = [(None, i0, j0)]
    if reorder == "auto" and m == n:
        from .reorder import rcm_ordering

        perm = rcm_ordering(csr)
        inv = np.empty(m, dtype=np.int64)
        inv[perm] = np.arange(m)
        orderings.append((perm, inv[i0], inv[j0]))

    gather_est = (gather_baseline_s if gather_baseline_s is not None
                  else csr.nnz * GATHER_S_PER_ROW)
    best = None
    for perm, i, j in orderings:
        for R, C_cand in tile_shapes:
            est, _, dense, uniq, counts = windowed_cost_estimate(
                i, j, m, n, R, C_cand, itemsize, k_nominal,
                pairs_per_step, allow_spill=allow_spill,
            )
            # Re-price a NONTRIVIAL spill with the calibrated gather
            # surface: the linear per-entry cost inside the split is a
            # best-case constant that underestimates the spill's
            # bucketed-ELL cost several-fold on mixed band+scatter
            # structure. The split itself stays linear (its optimum is
            # insensitive at small spill); only the accept/route
            # estimate pays the calibrated price. 1.6x is the
            # scattered-spill slot inflation under width_align=2.
            spill_nnz = int(counts[~dense].sum())
            if spill_nnz > 0.05 * max(csr.nnz, 1):
                from ..ops.auto import _calibrated_gather_seconds

                est += (_calibrated_gather_seconds(
                    "ell", int(spill_nnz * 1.6), m, k_nominal)
                    - spill_nnz * GATHER_S_PER_ROW)
            # Spill-majority guard (see SPILL_FRAC_REFUSE): when the
            # optimal split spills most of the matrix, windowed is the
            # wrong CLASS and the linear spill term misses several-fold.
            # Auto-search only — a caller pinning block_rows (spill-path
            # tests) builds what it asks.
            if (block_rows is None
                    and spill_nnz > SPILL_FRAC_REFUSE * max(csr.nnz, 1)):
                continue
            tile_bytes = int(dense.sum()) * R * C_cand * itemsize
            if tile_bytes > hard_cap:
                continue
            if (tile_bytes > ratio_cap * csr.nnz * itemsize
                    and tile_bytes > allowance):
                continue
            if best is None or est < best[0]:
                best = (est, R, C_cand, perm, i, j, dense, uniq, counts)
    if best is None:
        return None
    if best[0] > beat_gather_margin * gather_est or not best[6].any():
        return None
    return best


def windowed_wins(csr: "CSR", **search_kwargs) -> bool:
    """Cheap build-time probe: would ``WindowedPairs.from_csr`` return a
    format (i.e. some tiling beats the pure gather path)? Used by the
    Auto strategy's mesh routing to decide windowed vs gather sharding
    without materializing tiles."""
    m, _ = csr.shape
    if m == 0 or csr.nnz == 0:
        return False
    coo = csr.to_coo()
    i0 = np.asarray(coo.row_indices).astype(np.int64)
    j0 = np.asarray(coo.col_indices).astype(np.int64)
    return _search_tilings(csr, i0, j0, **search_kwargs) is not None


@_register
@dataclasses.dataclass(frozen=True)
class WindowedPairs:
    """Flat block-ascending list of dense (R, C) tiles plus bucketed-ELL
    spill.

    ``tiles[p, r, c]`` holds the entry at permuted coordinates
    ``(pair_block[p]*R + r, pair_chunk[p]*C + c)``. Pairs are sorted by
    (block, chunk), so each row block's tiles are one contiguous run
    ``tiles[block_ptr[b]:block_ptr[b+1]]``; every block's run is
    non-empty (build inserts a dummy zero tile into empty blocks).
    ``perm`` is the optional symmetric permutation
    applied at build time (``perm[k]`` = original index at permuted
    position ``k``).

    The iterate protocol works in *padded permuted* space: ``encode``
    returns a ``(pad_rows, k)`` fat vector (zero tail), ``iterate`` maps
    ``(pad_rows, k) -> (pad_rows, k)``, and ``decode`` slices off the tail
    and undoes the permutation — so a chained consumer pays no per-step
    layout transforms at all.
    """

    tiles: jax.Array                # (P, R, C)
    pair_chunk: jax.Array           # (P,) int32
    pair_block: jax.Array           # (P,) int32, ascending
    block_ptr: jax.Array            # (nb + 1,) int32 pair run bounds
    spill: Optional[BucketedELL]
    perm: Optional[jax.Array]       # (m,) int32 or None
    inv_perm: Optional[jax.Array]   # (m,) int32 or None
    shape: Tuple[int, int] = _static_field()
    block_rows: int = _static_field()
    chunk_cols: int = _static_field()
    est_seconds: float = _static_field()  # cost-model estimate (k=32)
    #: Pairs per step the build padded for (and the cost model priced):
    #: 2 = even per-block runs; >2 = a global tail pad to a multiple.
    pairs_per_step: int = _static_field(default=2)

    @property
    def dtype(self):
        return self.tiles.dtype

    @property
    def n_pairs(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_blocks(self) -> int:
        return -(-self.shape[0] // self.block_rows)

    @property
    def n_chunks(self) -> int:
        return -(-self.shape[1] // self.chunk_cols)

    @property
    def pad_rows(self) -> int:
        """Row count of the padded permuted space the iterate protocol
        lives in: covers both the chunk grid (inputs) and the block grid
        (outputs) and is a chunk multiple (every slab is a whole chunk
        of rows), so square chained iterations are copy-free."""
        C = self.chunk_cols
        raw = max(self.n_chunks * C, self.n_blocks * self.block_rows)
        return -(-raw // C) * C

    @property
    def dense_bytes(self) -> int:
        return int(self.tiles.size) * self.tiles.dtype.itemsize

    def astype(self, dtype) -> "WindowedPairs":
        return dataclasses.replace(
            self,
            tiles=self.tiles.astype(dtype),
            spill=None if self.spill is None else self.spill.astype(dtype),
        )

    # ---- padded-permuted-space iteration protocol --------------------
    # encode once -> iterate many -> decode once: an iterative consumer
    # pays the boundary permute/pad once, not per multiply.
    def encode(self, v: jax.Array) -> jax.Array:
        """Map a fat vector into the operand's padded permuted column
        space: ``(n, k) -> (pad_rows, k)`` with a zero tail."""
        if self.perm is not None:
            v = jnp.take(v, self.perm, axis=0)
        pad = self.pad_rows - v.shape[0]
        if pad > 0:
            v = jnp.concatenate(
                [v, jnp.zeros((pad, v.shape[1]), v.dtype)], axis=0)
        return v

    def decode(self, out_p: jax.Array) -> jax.Array:
        """Map a padded permuted-space result back to original row
        order: slice the pad tail, undo the permutation."""
        out_p = out_p[: self.shape[0]]
        if self.inv_perm is None:
            return out_p
        return jnp.take(out_p, self.inv_perm, axis=0)

    def iterate(self, v_p: jax.Array) -> jax.Array:
        """Permuted-space SpMM (the chainable hot body)."""
        from ..ops.windowed import spmm_windowed_core

        return spmm_windowed_core(self, v_p)

    def __matmul__(self, v):
        from ..ops.windowed import spmm_windowed

        return spmm_windowed(self, v)

    # ---- construction -------------------------------------------------
    @classmethod
    def from_csr(cls, csr: CSR, *, block_rows: Optional[int] = None,
                 chunk_cols: Optional[int] = None,
                 reorder: str | None = "auto",
                 candidates=DEFAULT_CANDIDATES,
                 k_nominal: int = 32,
                 max_inflation: Optional[float] = None,
                 beat_gather_margin: float = 0.8,
                 pairs_per_step: Optional[int] = None,
                 gather_baseline_s: Optional[float] = None,
                 allow_spill: bool = True,
                 ) -> Optional["WindowedPairs"]:
        """Build windowed storage; returns ``None`` when no tile
        configuration beats the pure gather path by ``beat_gather_margin``
        (caller falls back to a gather format).

        ``candidates`` are (R, C) tile shapes (ints mean R with C=128);
        ``block_rows``/``chunk_cols`` pin one or both dimensions.
        ``reorder="auto"`` applies RCM when the matrix is square and the
        reordered tiling estimates cheaper; ``None`` disables.
        ``max_inflation`` (dense bytes / nnz bytes ratio): ``None`` =
        default 96x with the small-matrix ``DENSE_BYTES_ALLOWANCE``; an
        explicit value binds strictly.
        ``pairs_per_step`` (default ``PRODUCTION_PAIRS_PER_STEP``) selects
        the padding and the per-pair cost constants: 2 = even per-block
        runs, >2 = global tail pad only.
        """
        if pairs_per_step is None:
            pairs_per_step = PRODUCTION_PAIRS_PER_STEP
        if not isinstance(pairs_per_step, int) or pairs_per_step < 2:
            raise ValueError(
                f"pairs_per_step must be an int >= 2, got "
                f"{pairs_per_step!r}")
        m, n = csr.shape
        if m == 0 or csr.nnz == 0:
            return None
        itemsize = np.asarray(csr.values).dtype.itemsize

        coo = csr.to_coo()
        i0 = np.asarray(coo.row_indices).astype(np.int64)
        j0 = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        from .matrix import coalesce_coo

        i0, j0, vals = coalesce_coo(i0, j0, vals, n)

        best = _search_tilings(
            csr, i0, j0, block_rows=block_rows, chunk_cols=chunk_cols,
            reorder=reorder, candidates=candidates, k_nominal=k_nominal,
            max_inflation=max_inflation,
            beat_gather_margin=beat_gather_margin,
            pairs_per_step=pairs_per_step,
            gather_baseline_s=gather_baseline_s,
            allow_spill=allow_spill,
        )
        if best is None:
            return None
        est, R, C, perm, i, j, dense, uniq, counts = best

        n_chunks = -(-n // C)
        key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
        # Map each nnz to its pair id (position in the sorted unique keys).
        pair_of_entry = np.searchsorted(uniq, key)
        dense_ids = np.nonzero(dense)[0]
        remap = np.full(len(uniq), -1, dtype=np.int64)
        remap[dense_ids] = np.arange(len(dense_ids))
        p_entry = remap[pair_of_entry]
        in_dense = p_entry >= 0

        # Pairs ascending by (block, chunk) — uniq is sorted.
        pb_raw = (uniq[dense_ids] // n_chunks).astype(np.int64)
        pc_raw = (uniq[dense_ids] % n_chunks).astype(np.int64)
        nb = max(-(-m // R), 1)

        # Final padded layout computed UP FRONT so the (potentially
        # multi-GB) tile array is allocated once and scattered into once.
        # Per block b the final run length f_b adds: a dummy zero tile
        # when the block is empty, an even-run pad at pairs_per_step ==
        # 2, and at pairs_per_step > 2 only a global tail pad on the
        # last block.
        c_b = np.bincount(pb_raw, minlength=nb)
        f_b = np.where(c_b == 0, 1, c_b)
        if pairs_per_step == 2:
            f_b = f_b + f_b % 2
        tail_pad = int((-f_b.sum()) % pairs_per_step) \
            if pairs_per_step > 2 else 0
        P_final = int(f_b.sum()) + tail_pad
        O_b = np.concatenate([[0], np.cumsum(c_b)[:-1]])
        F_b = np.concatenate([[0], np.cumsum(f_b)[:-1]])
        # Real pair at sorted position q (block b, k-th in block) lands
        # at F_b + k; pads fill [F_b + c_b, F_b + f_b) with zero tiles
        # referencing chunk 0.
        final_of_pair = np.arange(len(pb_raw)) + (F_b - O_b)[pb_raw]
        pair_block = np.repeat(np.arange(nb, dtype=np.int32),
                               f_b.astype(np.int64))
        if tail_pad:
            pair_block = np.concatenate(
                [pair_block, np.full(tail_pad, nb - 1, np.int32)])
        pair_chunk = np.zeros(P_final, dtype=np.int32)
        pair_chunk[final_of_pair] = pc_raw
        tiles = np.zeros((P_final, R, C), dtype=vals.dtype)
        tiles[final_of_pair[p_entry[in_dense]], i[in_dense] % R,
              j[in_dense] % C] = vals[in_dense]

        block_ptr = np.searchsorted(
            pair_block, np.arange(nb + 1)).astype(np.int32)

        spill = None
        if (~in_dense).any():
            from .matrix import COO

            spill_coo = COO.from_arrays(
                vals[~in_dense], i[~in_dense], j[~in_dense], (m, n)
            )
            # Off-tile stragglers are short rows: fine-grained bucket
            # widths cut padded gather rows (gather is per-row-bound).
            spill = BucketedELL.from_csr(
                spill_coo.to_csr(), width_align=2, max_buckets=16
            )

        inv_perm = None
        if perm is not None:
            inv_perm = np.empty(m, dtype=np.int32)
            inv_perm[perm] = np.arange(m, dtype=np.int32)
            perm = perm.astype(np.int32)
        return cls(
            tiles=tiles, pair_chunk=pair_chunk, pair_block=pair_block,
            block_ptr=block_ptr, spill=spill, perm=perm, inv_perm=inv_perm,
            shape=(m, n), block_rows=R, chunk_cols=C,
            est_seconds=float(est), pairs_per_step=pairs_per_step,
        )

    def to_dense(self) -> jax.Array:
        """Dense (original-order) reconstruction — test/debug only."""
        m, n = self.shape
        R, C = self.block_rows, self.chunk_cols
        tiles = np.asarray(self.tiles)
        pb = np.asarray(self.pair_block).astype(np.int64)
        pc = np.asarray(self.pair_chunk).astype(np.int64)
        nb = self.n_blocks
        n_chunks = -(-n // C)
        out = np.zeros((nb * R, n_chunks * C), dtype=tiles.dtype)
        for p in range(len(pb)):
            out[pb[p] * R:(pb[p] + 1) * R,
                pc[p] * C:(pc[p] + 1) * C] += tiles[p]
        out = out[:m, :n]
        if self.spill is not None:
            out = out + np.asarray(self.spill.to_dense())
        if self.perm is not None:
            perm = np.asarray(self.perm).astype(np.int64)
            unperm = np.zeros_like(out)
            unperm[np.ix_(perm, perm)] = out
            out = unperm
        return jnp.asarray(out)
