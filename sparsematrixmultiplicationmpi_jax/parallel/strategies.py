"""The reference's parallel decompositions as mesh sharding strategies.

Reference -> mesh mapping (SURVEY.md §2 strategy inventory):

=================  ==========================================  =====================
Strategy           Reference realization                       Here
=================  ==========================================  =====================
Sequential         ``SparseMatrixFatVectorMultiply.cpp:11-31``  single-device oracle
Row-wise           block rows + ``MPI_Gatherv``                 ELL rows sharded on
                   (``...RowWise.cpp:26-50,85-87``)             the mesh axis; fat
                                                                vector replicated;
                                                                optional ``all_gather``
Column-wise        block k-columns + ``MPI_Gatherv``            fat-vector k-columns
                   (``...ColumnWise.cpp:25-48,82-84``)          sharded; matrix
                                                                replicated
Non-zero element   flat nnz ranges + ``MPI_Reduce(SUM)``        COO nnz sharded;
                   (``...NonZeroElement.cpp:24-39,88``)         per-device segment
                                                                sum; ``psum`` or
                                                                ``psum_scatter``
Library            PETSc ``MatMatMult`` (``main.cpp:345-348``)  ``jax.experimental
                                                                .sparse`` BCOO
=================  ==========================================  =====================

Design notes
------------
* Operand replication, done by rank-0 ``MPI_Bcast`` in the reference
  (``main.cpp:106-146``), is here a **sharding annotation**: ``device_put``
  with a replicated ``NamedSharding``. There is no hand-written transport.
* The reference's inconsistent remainder policies (row-wise gives extras to
  the *first* ranks, ``RowWise.cpp:28-29``; column-wise to the *last* rank,
  ``ColumnWise.cpp:28``) are replaced by padding to a multiple of the mesh
  size — static shapes, perfect balance, one policy.
* ``gather_result=True`` mirrors the reference's gather-to-root;
  ``False`` leaves the result sharded — the PETSc lesson
  (``report/425500_Report.tex:1092-1095``: PETSc wins *because* it never
  regathers).
"""

from __future__ import annotations

import abc
import dataclasses
from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.matrix import (
    COO, CSR, ELL, _register, _static_field, split_csr_by_width,
)
from ..ops.library import spmm_bcoo, to_bcoo
from ..ops.oracle import spmm_coo

__all__ = [
    "Strategy", "Sequential", "Auto", "RowWise", "ColumnWise",
    "NonZeroElement", "Library", "STRATEGIES", "get_strategy",
]


def _axis(mesh: Mesh) -> str:
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"strategies expect a 1-D mesh, got axes {mesh.axis_names}"
        )
    return mesh.axis_names[0]


def _pad_axis(x: jax.Array, axis: int, multiple: int) -> jax.Array:
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - size)
    return jnp.pad(x, pads)


class Strategy(abc.ABC):
    """A parallel SpMM execution strategy over a 1-D device mesh.

    Usage::

        strategy = RowWise()
        operand = strategy.prepare(csr, mesh)   # shard/replicate the matrix
        out = strategy.spmm(operand, v, mesh)   # jitted distributed SpMM
    """

    name: str = "abstract"

    @abc.abstractmethod
    def prepare(self, csr: CSR, mesh: Mesh):
        """Place the matrix on the mesh (the MPI_Bcast/scatter analog)."""

    @abc.abstractmethod
    def spmm(self, operand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        """Distributed SpMM. ``v`` is an ``(n, k)`` dense fat vector."""

    def chain_parts(self, operand, mesh: Mesh, *,
                    gather_result: bool = True):
        """(encode, body, decode) for iterated use: ``encode`` once, chain
        ``body``, ``decode`` once. Each takes ``(x, operand)``.

        Default: identity boundaries around ``spmm``. Strategies whose
        operand carries a one-time transform (e.g. the RCM permutation of
        ``WindowedPairs``) override so iterative consumers — and the
        amortized benchmark, which measures exactly the marginal cost of
        one more multiply — pay the boundary transforms once, the
        never-regather lesson of the reference's PETSc path
        (``report/425500_Report.tex:1092-1095``).
        """
        def enc(v, op):
            return v

        def body(vv, op):
            return self.spmm(op, vv, mesh, gather_result=gather_result)

        def dec(out, op):
            return out

        return enc, body, dec


class Sequential(Strategy):
    """Single-device oracle (reference sequential kernel,
    ``SparseMatrixFatVectorMultiply.cpp:11-31``). Also the correctness
    baseline every other strategy is validated against
    (``main.cpp:184,227,270`` pattern)."""

    name = "sequential"

    def prepare(self, csr: CSR, mesh: Mesh):
        coo = csr.to_coo()
        dev = mesh.devices.flat[0]
        return jax.device_put(coo, dev)

    def spmm(self, operand: COO, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        return _jit_sequential(operand, v)


@jax.jit
def _jit_sequential(coo: COO, v: jax.Array) -> jax.Array:
    return spmm_coo(coo, v)


def _ell_width_cap(csr: CSR, width_align: int) -> int:
    """Padded-plane width cap: p99 of row lengths (or 2x mean), aligned.

    A single dense row must not inflate the ELL planes to
    ``m x max_row_nnz`` (a 100k-row power-law matrix with one 500k-nnz row
    would allocate 230 GB); overflow entries go to a COO tail instead.
    """
    lengths = csr.row_lengths()
    if not len(lengths) or csr.nnz == 0:
        return width_align
    p99 = float(np.percentile(lengths, 99))
    mean2 = 2.0 * csr.nnz / max(csr.shape[0], 1)
    cap = int(max(width_align, p99, mean2))
    return -(-cap // width_align) * width_align


@_register
@dataclasses.dataclass(frozen=True)
class HybridRowOperand:
    """Row-sharded ELL head + nnz-sharded COO tail (HYB split)."""

    cols: jax.Array                 # (m_padded, W)
    vals: jax.Array                 # (m_padded, W)
    tail_values: jax.Array          # (t,) — zero-length when no tail
    tail_rows: jax.Array            # (t,)
    tail_cols: jax.Array            # (t,)
    shape: tuple = _static_field()
    m_padded: int = _static_field()


class RowWise(Strategy):
    """Output rows sharded over the mesh (reference
    ``...RowWise.cpp:26-50``): each device owns an ELL row block, the fat
    vector is replicated, and the result is optionally ``all_gather``-ed
    (the ``MPI_Gatherv`` analog, ``RowWise.cpp:85-87``). Rows beyond the
    ELL width cap spill into an nnz-sharded COO tail combined by
    ``psum_scatter`` onto the row shards (skew robustness the reference's
    block-row scheme lacks)."""

    name = "row_wise"

    def __init__(self, width_align: int = 8, max_width: int | None = None):
        self.width_align = width_align
        self.max_width = max_width

    def prepare(self, csr: CSR, mesh: Mesh):
        p = mesh.devices.size
        cap = self.max_width or _ell_width_cap(csr, self.width_align)
        head, tail = split_csr_by_width(csr, cap)
        ell = ELL.from_csr(
            head, row_align=8 * p, width_align=self.width_align
        )
        ax = _axis(mesh)
        sharded = NamedSharding(mesh, P(ax, None))
        nnz_sharded = NamedSharding(mesh, P(ax))
        if tail is None:
            dtype = np.asarray(ell.vals).dtype
            tv = np.zeros((0,), dtype)
            tr = tc = np.zeros((0,), np.int32)
        else:
            tail = tail.pad_to(-(-tail.nnz // p) * p)
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
        ax = _axis(mesh)
        v = jax.device_put(v, NamedSharding(mesh, P(None, None)))
        has_tail = int(operand.tail_values.shape[0]) > 0
        out = _rowwise_spmm(
            mesh, ax, gather_result, has_tail, operand.m_padded,
            operand.cols, operand.vals,
            operand.tail_values, operand.tail_rows, operand.tail_cols, v,
        )
        return out[: operand.shape[0]]


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _rowwise_spmm(mesh, ax, gather, has_tail, m_padded,
                  cols, vals, tv, tr, tc, v):
    def body(cols_blk, vals_blk, tv_blk, tr_blk, tc_blk, v_full):
        from ..ops.ell import take_rows

        gathered = take_rows(v_full, cols_blk.reshape(-1))
        gathered = gathered.reshape(*cols_blk.shape, v_full.shape[1])
        out = jnp.sum(
            vals_blk[:, :, None].astype(v_full.dtype) * gathered, axis=1
        )
        if has_tail:
            # Overflow entries: local partial over the full height, then
            # reduce-scatter back onto the row shards.
            from ..ops.ell import take_rows as _tr

            prods = tv_blk[:, None].astype(v_full.dtype) * _tr(
                v_full, tc_blk
            )
            partial_out = jax.ops.segment_sum(
                prods, tr_blk, num_segments=m_padded
            )
            out = out + jax.lax.psum_scatter(partial_out, ax, tiled=True)
        if gather:
            out = jax.lax.all_gather(out, ax, tiled=True)
        return out

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax, None), P(ax, None), P(ax), P(ax), P(ax),
                  P(None, None)),
        out_specs=P(None, None) if gather else P(ax, None),
        check_vma=False,
    )(cols, vals, tv, tr, tc, v)


class ColumnWise(Strategy):
    """Fat-vector k-columns sharded (reference ``...ColumnWise.cpp:25-48``
    — note it partitions the *output* columns, not matrix columns): every
    device traverses the full matrix for its k-slice. Degenerates when
    ``p > k`` exactly as the reference observes
    (``report/425500_Report.tex:1036``); the matrix is replicated."""

    name = "column_wise"

    def __init__(self, **format_kwargs):
        self.format_kwargs = format_kwargs

    def prepare(self, csr: CSR, mesh: Mesh):
        # The matrix is replicated per device (as the reference replicates
        # it per rank), so each device runs the best single-device format
        # for its k-slice — band-dense where the structure allows.
        from ..ops.auto import auto_format

        operand = auto_format(csr, **self.format_kwargs)
        return jax.tree.map(
            lambda x: jax.device_put(
                x, NamedSharding(mesh, P(*([None] * np.ndim(x))))
            ),
            operand,
        )

    def spmm(self, operand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        ax = _axis(mesh)
        p = mesh.devices.size
        k = v.shape[1]
        v = _pad_axis(v, 1, p)
        v = jax.device_put(v, NamedSharding(mesh, P(None, ax)))
        out = _colwise_spmm(mesh, ax, gather_result, operand, v)
        return out[: operand.shape[0], :k]


@partial(jax.jit, static_argnums=(0, 1, 2))
def _colwise_spmm(mesh, ax, gather, operand, v):
    from ..ops.auto import spmm_any

    def body(operand_full, v_blk):
        # XLA path inside shard_map: each device holds a k-slice.
        out = spmm_any(operand_full, v_blk, use_pallas=False)
        if gather:
            out = jax.lax.all_gather(out, ax, axis=1, tiled=True)
        return out

    operand_specs = jax.tree.map(
        lambda x: P(*([None] * np.ndim(x))), operand
    )
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(operand_specs, P(None, ax)),
        out_specs=P(None, None) if gather else P(None, ax),
        check_vma=False,
    )(operand, v)


class NonZeroElement(Strategy):
    """Flat nnz-range sharding (reference ``...NonZeroElement.cpp:24-39``):
    perfectly balanced work regardless of row-length skew. Each device
    segment-sums its COO chunk into a full-height partial, then partials are
    combined with ``psum`` (the ``MPI_Reduce(SUM)`` analog,
    ``NonZeroElement.cpp:88``) or — fixing the reference's O(m*k)-regardless-
    of-p communication defect — ``psum_scatter`` so the result lands
    row-sharded with 1/p the traffic per link."""

    name = "nnz"

    def __init__(self, reduce: Literal["psum", "scatter"] = "psum"):
        self.reduce = reduce

    def prepare(self, csr: CSR, mesh: Mesh):
        p = mesh.devices.size
        coo = csr.to_coo()
        coo = coo.pad_to(-(-max(coo.nnz, 1) // p) * p)
        ax = _axis(mesh)
        sharded = NamedSharding(mesh, P(ax))
        return dataclasses.replace(
            coo,
            values=jax.device_put(coo.values, sharded),
            row_indices=jax.device_put(coo.row_indices, sharded),
            col_indices=jax.device_put(coo.col_indices, sharded),
        )

    def spmm(self, operand: COO, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        ax = _axis(mesh)
        p = mesh.devices.size
        m = operand.shape[0]
        m_padded = -(-m // p) * p
        v = jax.device_put(v, NamedSharding(mesh, P(None, None)))
        scatter = self.reduce == "scatter" and not gather_result
        out = _nnz_spmm(
            mesh, ax, m_padded, scatter,
            operand.values, operand.row_indices, operand.col_indices, v,
        )
        return out[:m]


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _nnz_spmm(mesh, ax, m_padded, scatter, values, rows, cols, v):
    def body(values_blk, rows_blk, cols_blk, v_full):
        from ..ops.ell import take_rows

        gathered = take_rows(v_full, cols_blk)
        prods = values_blk[:, None].astype(v_full.dtype) * gathered
        partial_out = jax.ops.segment_sum(
            prods, rows_blk, num_segments=m_padded, indices_are_sorted=False
        )
        if scatter:
            return jax.lax.psum_scatter(partial_out, ax, tiled=True)
        return jax.lax.psum(partial_out, ax)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(None, None)),
        out_specs=P(ax, None) if scatter else P(None, None),
        check_vma=False,
    )(values, rows, cols, v)


class Library(Strategy):
    """Vendor-library yardstick — ``jax.experimental.sparse`` BCOO under
    plain ``jit``, the PETSc ``MatMatMult`` analog (``main.cpp:345-348``).
    XLA chooses the partitioning; like PETSc, the result stays wherever the
    library puts it."""

    name = "library"

    def prepare(self, csr: CSR, mesh: Mesh):
        return to_bcoo(csr)

    def spmm(self, operand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        return _jit_library(operand, v)


@jax.jit
def _jit_library(bcoo, v):
    return spmm_bcoo(bcoo, v)


class Auto(Strategy):
    """Structure- and mesh-adaptive path — the framework's "just make it
    fast" strategy (the path ``bench.py`` reports).

    Single device: windowed dense tiles where clustering supports them,
    else the cheaper of bucketed ELL and COO+segment-sum by the k-aware
    gather-class estimate (``ops/auto.py``; pass ``k_nominal=<fat-vector
    width>`` — the sweep harness does). Multi-device mesh: the
    halo-exchange row-sharded band strategy for square matrices with
    band structure, the row-sharded windowed strategy where tiles win,
    the hybrid row-wise strategy otherwise. Dispatch is on the *prepared
    operand's* type, so prepare-once/multiply-many works across all
    cases."""

    name = "auto"

    def __init__(self, **format_kwargs):
        self.format_kwargs = format_kwargs

    def prepare(self, csr: CSR, mesh: Mesh):
        from ..ops.auto import auto_format

        p = int(mesh.devices.size)
        if p > 1:
            return self._mesh_route(csr).prepare(csr, mesh)
        operand = auto_format(csr, **self.format_kwargs)
        return jax.device_put(operand, mesh.devices.flat[0])

    def _mesh_route(self, csr: CSR) -> Strategy:
        """Pick the row-sharded strategy by the measured single-chip
        cost model — the same estimates that route single-device
        operands. Every candidate's compute estimate divides
        ~uniformly by the device count (all three shard output rows),
        so the argmin is p-invariant; the communication ordering only
        reinforces it (the banded and windowed strategies move O(halo)
        bytes by ``ppermute`` while the hybrid row strategy's
        ``psum_scatter`` moves O(m*k) — the gather-class pick never
        loses comm it would have won on compute).

        CPU wall clocks cannot resolve this boundary (without tensor
        cores the gather hybrid wins at every band coverage), so the
        model, not a CPU timing, carries the decision. Its constants
        are provisional until they are refit on the GPU (ROADMAP
        Speed #6).
        """
        from ..formats.banded import BandedBlocks
        from ..formats.windowed import _search_tilings
        from ..ops.auto import gather_class_estimates

        k_nominal = self.format_kwargs.get("k_nominal", 32)
        gests = gather_class_estimates(csr, k_nominal=k_nominal)
        best_gather = min(e for e, _ in gests.values())
        m, n = csr.shape
        banded_est = float("inf")
        if m == n:  # the halo-exchange band strategy assumes square
            bb = BandedBlocks.from_csr(csr, k_nominal=k_nominal)
            if bb is not None:
                banded_est = bb.est_seconds
        windowed_est = float("inf")
        coo = csr.to_coo()
        found = _search_tilings(
            csr, np.asarray(coo.row_indices).astype(np.int64),
            np.asarray(coo.col_indices).astype(np.int64),
            k_nominal=k_nominal, gather_baseline_s=best_gather)
        if found is not None:
            windowed_est = found[0]
        if banded_est <= min(windowed_est, best_gather):
            from .banded_strategy import BandedRowWise

            return BandedRowWise()
        if windowed_est < best_gather:
            from .windowed_strategy import WindowedRowWise

            return WindowedRowWise()
        return RowWise()

    def spmm(self, operand, v: jax.Array, mesh: Mesh, *,
             gather_result: bool = True) -> jax.Array:
        from .banded_strategy import BandedRowOperand, BandedRowWise
        from .windowed_strategy import WindowedRowOperand, WindowedRowWise

        if isinstance(operand, BandedRowOperand):
            return BandedRowWise().spmm(
                operand, v, mesh, gather_result=gather_result
            )
        if isinstance(operand, WindowedRowOperand):
            return WindowedRowWise().spmm(
                operand, v, mesh, gather_result=gather_result
            )
        if isinstance(operand, HybridRowOperand):
            return RowWise().spmm(
                operand, v, mesh, gather_result=gather_result
            )
        return _jit_auto(operand, v)

    def chain_parts(self, operand, mesh: Mesh, *,
                    gather_result: bool = True):
        from ..formats.windowed import WindowedPairs
        from .banded_strategy import BandedRowOperand, BandedRowWise
        from .windowed_strategy import WindowedRowOperand, WindowedRowWise

        if isinstance(operand, WindowedPairs):
            # Permute/pad once, chain the permuted-space multiply.
            return (lambda v, op: op.encode(v),
                    lambda x, op: op.iterate(x),
                    lambda x, op: op.decode(x))
        if isinstance(operand, BandedRowOperand):
            return BandedRowWise().chain_parts(
                operand, mesh, gather_result=gather_result)
        if isinstance(operand, WindowedRowOperand):
            return WindowedRowWise().chain_parts(
                operand, mesh, gather_result=gather_result)
        return super().chain_parts(
            operand, mesh, gather_result=gather_result
        )


@jax.jit
def _jit_auto(operand, v):
    from ..ops.auto import spmm_any

    return spmm_any(operand, v)


STRATEGIES = {
    "sequential": Sequential,
    "auto": Auto,
    "row": RowWise,
    "row_wise": RowWise,
    "column": ColumnWise,
    "column_wise": ColumnWise,
    "nnz": NonZeroElement,
    "non_zero_element": NonZeroElement,
    "library": Library,
}


def get_strategy(name: str, **kwargs) -> Strategy:
    try:
        return STRATEGIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(set(STRATEGIES))}"
        ) from None
