"""2-D (rows x k) sharded SpMM — composing the reference's row-wise and
column-wise decompositions on a 2-D device mesh.

The reference treats row-partitioning and k-partitioning as mutually
exclusive strategies (its report's conclusion weighs one against the
other). On a device mesh they compose: shard output rows over one mesh axis
and fat-vector columns over the other. Each device owns an
(m/p_r) x (k/p_c) output tile, the matrix is replicated only along the
column axis (not globally), and gathers run along separate mesh axes — the
layout that keeps both the replication footprint and the per-link gather
volume at 1/p of the reference's design.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.matrix import CSR, ELL, split_csr_by_width
from .strategies import (
    STRATEGIES, HybridRowOperand, Strategy, _ell_width_cap, _pad_axis,
)

__all__ = ["Grid2D"]


class Grid2D(Strategy):
    """Rows x k 2-D sharding over a 2-axis mesh (``make_mesh_2d``)."""

    name = "grid2d"

    def __init__(self, width_align: int = 8):
        self.width_align = width_align

    @staticmethod
    def _axes(mesh: Mesh):
        if len(mesh.axis_names) != 2:
            raise ValueError(
                f"grid2d needs a 2-D mesh, got axes {mesh.axis_names}"
            )
        return mesh.axis_names

    def prepare(self, csr: CSR, mesh: Mesh):
        import numpy as np

        rows_ax, cols_ax = self._axes(mesh)
        p_r = mesh.shape[rows_ax]
        cap = _ell_width_cap(csr, self.width_align)
        head, tail = split_csr_by_width(csr, cap)
        ell = ELL.from_csr(
            head, row_align=8 * p_r, width_align=self.width_align
        )
        # Rows sharded over the row axis; replicated along the col axis;
        # tail nnz sharded over the row axis (HYB split, as in RowWise).
        sharded = NamedSharding(mesh, P(rows_ax, None))
        nnz_sharded = NamedSharding(mesh, P(rows_ax))
        if tail is None:
            tv = np.zeros((0,), np.asarray(ell.vals).dtype)
            tr = tc = np.zeros((0,), np.int32)
        else:
            tail = tail.pad_to(-(-tail.nnz // p_r) * p_r)
            tv, tr, tc = tail.values, tail.row_indices, tail.col_indices
        return HybridRowOperand(
            cols=jax.device_put(ell.cols, sharded),
            vals=jax.device_put(ell.vals, sharded),
            tail_values=jax.device_put(tv, nnz_sharded),
            tail_rows=jax.device_put(tr, nnz_sharded),
            tail_cols=jax.device_put(tc, nnz_sharded),
            shape=csr.shape,
            m_padded=ell.m_padded,
        )

    def spmm(self, operand: HybridRowOperand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        rows_ax, cols_ax = self._axes(mesh)
        p_c = mesh.shape[cols_ax]
        k = v.shape[1]
        v = _pad_axis(v, 1, p_c)
        v = jax.device_put(v, NamedSharding(mesh, P(None, cols_ax)))
        has_tail = int(operand.tail_values.shape[0]) > 0
        out = _grid2d_spmm(
            mesh, rows_ax, cols_ax, gather_result, has_tail,
            operand.m_padded,
            operand.cols, operand.vals,
            operand.tail_values, operand.tail_rows, operand.tail_cols, v,
        )
        return out[: operand.shape[0], :k]


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _grid2d_spmm(mesh, rows_ax, cols_ax, gather, has_tail, m_padded,
                 cols, vals, tv, tr, tc, v):
    def body(cols_blk, vals_blk, tv_blk, tr_blk, tc_blk, v_blk):
        # cols_blk/vals_blk: local row block (full width); v_blk: local
        # k-slice (full n rows). Output tile: (rows_local, k_local).
        from ..ops.ell import take_rows

        gathered = take_rows(v_blk, cols_blk.reshape(-1))
        gathered = gathered.reshape(*cols_blk.shape, v_blk.shape[1])
        out = jnp.sum(
            vals_blk[:, :, None].astype(v_blk.dtype) * gathered, axis=1
        )
        if has_tail:
            from ..ops.ell import take_rows as _tr

            prods = tv_blk[:, None].astype(v_blk.dtype) * _tr(v_blk, tc_blk)
            partial_out = jax.ops.segment_sum(
                prods, tr_blk, num_segments=m_padded
            )
            out = out + jax.lax.psum_scatter(
                partial_out, rows_ax, tiled=True
            )
        if gather:
            out = jax.lax.all_gather(out, cols_ax, axis=1, tiled=True)
            out = jax.lax.all_gather(out, rows_ax, tiled=True)
        return out

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(rows_ax, None), P(rows_ax, None),
            P(rows_ax), P(rows_ax), P(rows_ax), P(None, cols_ax),
        ),
        out_specs=(
            P(None, None) if gather else P(rows_ax, cols_ax)
        ),
        check_vma=False,
    )(cols, vals, tv, tr, tc, v)


STRATEGIES["grid2d"] = Grid2D
