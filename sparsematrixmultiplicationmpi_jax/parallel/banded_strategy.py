"""Row-sharded band-dense SpMM with halo exchange — the flagship
multi-chip strategy.

The reference replicates every operand on every rank (``main.cpp:106-146``)
and pays a full result gather per call — which is why its strong-scaling
efficiency collapses to 6-12 % at 60-96 cores (BASELINE.md). This strategy
shards *everything*: band blocks, fat vector, and output all live
row-sharded on the mesh. Per SpMM, the only communication is each device
exchanging ONE r-row edge block with each neighbor (``ppermute``, NVLink between GPUs)
— O(r*k) per link, independent of matrix size — plus, when the matrix has
off-band spill, one ``all_gather`` of the fat vector (the halo-all-gather
configuration of BASELINE.json). Compute is the same batched einsum as
the single-chip band kernel.

Weak scaling: per-device work is (nb/p) * r * 3r MACs + constant halo
traffic => efficiency stays flat as chips are added, versus the
reference's replicate-and-gather collapse.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.banded import BandedBlocks
from ..formats.matrix import ELL, _register, _static_field
from .strategies import Strategy, _axis

__all__ = ["BandedRowWise", "BandedRowOperand"]


@_register
@dataclasses.dataclass(frozen=True)
class BandedRowOperand:
    """Sharded operand: band blocks (P(axis) on the block dim), an
    optional row-aligned ELL spill sharded the same way, and an optional
    nnz-sharded COO tail for spill rows beyond the ELL width cap (without
    the cap, one power-law hub row would inflate the spill planes to
    m x max_row_nnz — observed 7 GB on a 600k-nnz matrix)."""

    band: jax.Array                       # (nb_padded, r, 3r)
    spill_cols: Optional[jax.Array]       # (nb_padded*r, W) int32
    spill_vals: Optional[jax.Array]       # (nb_padded*r, W)
    tail_values: Optional[jax.Array]      # (t,) nnz-sharded
    tail_rows: Optional[jax.Array]        # (t,) int32
    tail_cols: Optional[jax.Array]        # (t,) int32
    shape: Tuple[int, int] = _static_field()
    block_rows: int = _static_field()


class BandedRowWise(Strategy):
    """Row-sharded banded SpMM (halo ppermute + optional spill all-gather)."""

    name = "banded_row_wise"

    def __init__(self, block_rows: Optional[int] = None, **format_kwargs):
        self.block_rows = block_rows
        self.format_kwargs = format_kwargs

    def prepare(self, csr, mesh: Mesh) -> BandedRowOperand:
        m, n = csr.shape
        if m != n:
            raise ValueError(
                "banded_row_wise needs a square matrix (band structure is "
                "defined relative to the diagonal)"
            )
        kwargs = dict(self.format_kwargs)
        if self.block_rows is not None:
            kwargs.setdefault("block_rows", self.block_rows)
        else:
            # Always build a band (this strategy IS the band path); the
            # cost-model rejection is for the Auto chooser.
            kwargs.setdefault("min_coverage", 0.0)
        bb = BandedBlocks.from_csr(csr, **kwargs)
        if bb is None:
            bb = BandedBlocks.from_csr(csr, block_rows=128)
        p = int(mesh.devices.size)
        r = bb.block_rows
        nb = bb.n_blocks
        nb_padded = -(-nb // p) * p
        band = np.asarray(bb.band)
        if nb_padded != nb:
            band = np.concatenate(
                [band, np.zeros((nb_padded - nb, r, 3 * r), band.dtype)]
            )

        spill_cols = spill_vals = None
        tail_values = tail_rows = tail_cols = None
        if bb.spill is not None:
            # Rebuild the spill as a single row-aligned ELL (no row
            # permutation) so it row-shards identically to the band —
            # width-capped so a skewed spill cannot inflate the planes
            # (reference-class defect analog: one hub row => m x max_nnz);
            # overflow rides an nnz-sharded COO tail.
            from .strategies import _ell_width_cap
            from ..formats.matrix import split_csr_by_width

            spill_csr = _bucketed_to_csr(bb.spill)
            head, tail = split_csr_by_width(
                spill_csr, _ell_width_cap(spill_csr, 8)
            )
            ell = ELL.from_csr(head, row_align=nb_padded * r)
            spill_cols = np.asarray(ell.cols)
            spill_vals = np.asarray(ell.vals)
            if tail is not None:
                p_sz = int(mesh.devices.size)
                tail = tail.pad_to(-(-tail.nnz // p_sz) * p_sz)
                tail_values = np.asarray(tail.values)
                tail_rows = np.asarray(tail.row_indices)
                tail_cols = np.asarray(tail.col_indices)

        ax = _axis(mesh)
        shard3 = NamedSharding(mesh, P(ax, None, None))
        shard2 = NamedSharding(mesh, P(ax, None))
        shard1 = NamedSharding(mesh, P(ax))

        def put(x, sharding):
            return None if x is None else jax.device_put(
                jnp.asarray(x), sharding
            )

        return BandedRowOperand(
            band=jax.device_put(jnp.asarray(band), shard3),
            spill_cols=put(spill_cols, shard2),
            spill_vals=put(spill_vals, shard2),
            tail_values=put(tail_values, shard1),
            tail_rows=put(tail_rows, shard1),
            tail_cols=put(tail_cols, shard1),
            shape=(m, n),
            block_rows=r,
        )

    def spmm(self, operand: BandedRowOperand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        ax = _axis(mesh)
        m, n = operand.shape
        r = operand.block_rows
        nb_padded = int(operand.band.shape[0])
        k = v.shape[1]
        # Row-shard the fat vector, padded to the band's row extent.
        v_pad = jnp.zeros((nb_padded * r, k), dtype=v.dtype)
        v_pad = jax.lax.dynamic_update_slice(v_pad, v[: nb_padded * r], (0, 0))
        v_pad = jax.device_put(v_pad, NamedSharding(mesh, P(ax, None)))
        has_spill = operand.spill_cols is not None
        has_tail = operand.tail_values is not None
        zi = jnp.zeros((0,), jnp.int32)
        zv = jnp.zeros((0,), v.dtype)
        out = _banded_row_spmm(
            mesh, ax, gather_result, has_spill, has_tail, r,
            operand.band,
            operand.spill_cols if has_spill else jnp.zeros((0, 0), jnp.int32),
            operand.spill_vals if has_spill else jnp.zeros((0, 0), v.dtype),
            operand.tail_values if has_tail else zv,
            operand.tail_rows if has_tail else zi,
            operand.tail_cols if has_tail else zi,
            v_pad,
        )
        return out[:m]


def _bucketed_to_csr(bell):
    """Host-side: flatten a BucketedELL back to CSR (prepare-time only)."""
    from ..formats.matrix import COO

    m, n = bell.shape
    rows_l, cols_l, vals_l = [], [], []
    perm = np.asarray(bell.row_perm)
    offset = 0
    for b in bell.buckets:
        rows = perm[offset: offset + b.m_padded]
        offset += b.m_padded
        cols = np.asarray(b.cols)
        vals = np.asarray(b.vals)
        rr = np.repeat(rows, b.width)
        cc = cols.reshape(-1)
        vv = vals.reshape(-1)
        keep = (vv != 0) & (rr < m)
        rows_l.append(rr[keep])
        cols_l.append(cc[keep])
        vals_l.append(vv[keep])
    return COO.from_arrays(
        np.concatenate(vals_l), np.concatenate(rows_l),
        np.concatenate(cols_l), (m, n),
    ).to_csr()


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _banded_row_spmm(mesh, ax, gather, has_spill, has_tail, r, band,
                     spill_cols, spill_vals, tv, tr, tc, v_pad):
    p = mesh.shape[ax]
    m_padded = int(band.shape[0]) * r

    def body(band_blk, scols_blk, svals_blk, tv_blk, tr_blk, tc_blk,
             v_blk):
        nb_loc = band_blk.shape[0]
        k = v_blk.shape[1]
        v_blocks = v_blk.reshape(nb_loc, r, k)
        idx = jax.lax.axis_index(ax)

        # Halo exchange: receive the left neighbor's last block and the
        # right neighbor's first block (one r x k tile per link).
        # Mesh boundaries get zeros - the band's windows beyond the matrix
        # edge are zero-padded by construction.
        prev_blk = jax.lax.ppermute(
            v_blocks[-1], ax, [(i, (i + 1) % p) for i in range(p)]
        )
        next_blk = jax.lax.ppermute(
            v_blocks[0], ax, [(i, (i - 1) % p) for i in range(p)]
        )
        prev_blk = jnp.where(idx == 0, 0.0, prev_blk)
        next_blk = jnp.where(idx == p - 1, 0.0, next_blk)
        v_ext = jnp.concatenate(
            [prev_blk[None], v_blocks, next_blk[None]], axis=0
        )

        precision = (
            jax.lax.Precision.HIGHEST
            if v_blk.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT
        )
        out = jnp.zeros((nb_loc, r, k), dtype=v_blk.dtype)
        for s in range(3):
            out = out + jnp.einsum(
                "brc,bck->brk",
                band_blk[:, :, s * r: (s + 1) * r],
                jax.lax.dynamic_slice_in_dim(v_ext, s, nb_loc, axis=0),
                preferred_element_type=v_blk.dtype,
                precision=precision,
            )
        out = out.reshape(nb_loc * r, k)

        if has_spill:
            # Off-band entries may reference any fat-vector row: gather the
            # full vector once (the halo-all-gather configuration), then run
            # the local ELL rows against it.
            v_full = jax.lax.all_gather(v_blk, ax, tiled=True)
            gathered = jnp.take(v_full, scols_blk.reshape(-1), axis=0)
            gathered = gathered.reshape(*scols_blk.shape, k)
            out = out + jnp.sum(
                svals_blk[:, :, None].astype(v_blk.dtype) * gathered, axis=1
            )
            if has_tail:
                # Width-cap overflow: nnz-sharded COO, segment-summed into
                # a full-height partial, reduce-scattered onto row shards
                # (same skew-robust pattern as RowWise's hybrid tail).
                from ..ops.ell import take_rows

                prods = tv_blk[:, None].astype(v_blk.dtype) * take_rows(
                    v_full, tc_blk
                )
                partial_out = jax.ops.segment_sum(
                    prods, tr_blk, num_segments=m_padded
                )
                out = out + jax.lax.psum_scatter(
                    partial_out, ax, tiled=True
                )

        if gather:
            out = jax.lax.all_gather(out, ax, tiled=True)
        return out

    out_specs = P(None, None) if gather else P(ax, None)
    if not has_spill:
        return jax.shard_map(
            lambda band_blk, v_blk: body(
                band_blk,
                jnp.zeros((v_blk.shape[0], 0), jnp.int32),
                jnp.zeros((v_blk.shape[0], 0), v_blk.dtype),
                jnp.zeros((0,), v_blk.dtype),
                jnp.zeros((0,), jnp.int32),
                jnp.zeros((0,), jnp.int32),
                v_blk,
            ),
            mesh=mesh,
            in_specs=(P(ax, None, None), P(ax, None)),
            out_specs=out_specs,
            check_vma=False,
        )(band, v_pad)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ax, None, None), P(ax, None), P(ax, None),
                  P(ax), P(ax), P(ax), P(ax, None)),
        out_specs=out_specs,
        check_vma=False,
    )(band, spill_cols, spill_vals, tv, tr, tc, v_pad)


# Register with the strategy name table (import-cycle-free: this module
# already depends on .strategies).
from .strategies import STRATEGIES  # noqa: E402

STRATEGIES["banded_row"] = BandedRowWise
STRATEGIES["banded_row_wise"] = BandedRowWise
