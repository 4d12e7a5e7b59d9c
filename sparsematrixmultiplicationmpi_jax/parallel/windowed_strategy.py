"""Row-sharded windowed tile-pair SpMM — the flagship format on a mesh.

The single-device flagship format (``formats/windowed.py``) distributed
the way the reference distributes rows (``...RowWise.cpp:26-50``): row
blocks are range-partitioned over the mesh axis, every device owns the
dense tiles of its block range (sharded, not replicated — unlike the
reference's replicate-everything model, ``main.cpp:106-146``), and each
device runs the same fused block-run kernel the single-device path uses
(``ops/pallas_windowed.py``, inside ``shard_map``). The output lands
row-sharded (``gather_result=False``) or is ``all_gather``-ed (the
``MPI_Gatherv`` analog, ``RowWise.cpp:85-87``).

Fat-vector distribution: two input modes, chosen at prepare time from
the operand's actual column footprint.

* ``halo`` — the fat vector is CHUNK-SHARDED over the mesh (device ``d``
  owns rows ``[d*s_loc, (d+1)*s_loc)`` of the padded permuted space) and
  each device ``ppermute``s in only the halo chunks its tiles/spill
  actually reference beyond its owned range (RCM clusters windows near
  the diagonal, so halos are narrow on FEM-class matrices). Per-iteration
  communication is O((h_l+h_r)*C*k) per link — independent of matrix
  size, the ``BandedRowWise`` discipline — and a chained consumer never
  materializes the full vector anywhere.
* ``replicate`` — the full fat vector on every device, kept for matrices
  whose windows span most chunks (powerlaw hubs) where a halo would
  degenerate into an all-gather anyway.

Padding: ``prepare`` pads every device's pair list to a common
``P_max`` under the same contract ``WindowedPairs.from_csr`` applies —
even per-block runs at ``pairs_per_step == 2``, a multiple of
``pairs_per_step`` otherwise — so every device runs one static shape.

Load balance: FEM-class matrices have near-uniform tiles-per-block after
RCM, so equal block ranges are within ~20 % of equal work; the spill ELL
is width-capped with a COO tail exactly as in ``banded_strategy.py``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.matrix import ELL, _register, _static_field, \
    split_csr_by_width
from ..formats.windowed import (
    PRODUCTION_PAIRS_PER_STEP, build_dense_pairs, windowed_cost_estimate,
)
from .strategies import Strategy, _axis, _ell_width_cap

__all__ = ["WindowedRowWise", "WindowedRowOperand"]


@_register
@dataclasses.dataclass(frozen=True)
class WindowedRowOperand:
    """Device-range-partitioned windowed tiles plus sharded spill.

    Per device ``d``: rows ``[d*s_loc, (d+1)*s_loc)`` (padded permuted
    space, ``s_loc = nb_loc*R = ch_loc*C``), tiles
    ``tiles[d*P_max:(d+1)*P_max]``, local pair runs ``block_ptr[d]``.
    Padding pairs (zero tiles) keep every device at exactly ``P_max``
    pairs under the pad contract for ``pairs_per_step`` (even per-block
    runs at 2; ``P_max % pairs_per_step == 0`` ascending-tail at >2).

    ``input_mode`` records how the fat vector travels: ``replicate``
    keeps GLOBAL chunk/column indices; ``halo`` keeps indices REBASED
    into each device's ``[h_l + ch_loc + h_r]``-chunk local window and
    the COO tail row-sharded by owner (local row ids).
    """

    tiles: jax.Array                 # (p*P_max, R, C) sharded on axis
    pair_chunk: jax.Array            # (p*P_max,) sharded
    pair_pos: jax.Array              # (p*P_max,) local block idx, sharded
    block_ptr: jax.Array             # (p, nb_loc+1) sharded
    spill_cols: Optional[jax.Array]  # (p*s_loc, W) sharded
    spill_vals: Optional[jax.Array]
    tail_values: Optional[jax.Array]  # COO overflow (see input_mode)
    tail_rows: Optional[jax.Array]
    tail_cols: Optional[jax.Array]
    perm: Optional[jax.Array]        # (m,) int32 or None
    inv_perm: Optional[jax.Array]
    shape: Tuple[int, int] = _static_field()
    block_rows: int = _static_field()
    chunk_cols: int = _static_field()
    pairs_per_step: int = _static_field(default=2)
    input_mode: str = _static_field(default="replicate")
    halo_left: int = _static_field(default=0)    # chunks
    halo_right: int = _static_field(default=0)   # chunks
    s_loc: int = _static_field(default=0)        # padded rows per device

    def encode(self, v: jax.Array) -> jax.Array:
        if self.perm is not None:
            v = jnp.take(v, self.perm, axis=0)
        return v

    def decode(self, out_p: jax.Array) -> jax.Array:
        out_p = out_p[: self.shape[0]]
        if self.inv_perm is None:
            return out_p
        return jnp.take(out_p, self.inv_perm, axis=0)


def _pad_device_pairs(tl, pcd, pbd, nb_loc: int, P_max: int, U: int,
                      pad_chunk: int = 0):
    """Pad ONE device's (tiles, chunks, local-blocks) to the pad
    contract at ``P_max`` total pairs (mirrors
    ``WindowedPairs.from_csr``'s padding branches).

    Requires ``pbd`` to cover every local block (callers insert dummy
    zero tiles for missing blocks first) and ``P_max`` to be a multiple
    of ``U`` (and >= the even-padded count for U == 2). Padding pairs
    reference ``pad_chunk`` (an owned chunk in halo mode, so the pad
    never widens the halo window). Returns block-sorted arrays of
    length exactly ``P_max``.
    """
    R, C = tl.shape[1], tl.shape[2]
    if U == 2:
        counts = np.bincount(pbd, minlength=nb_loc)
        odd = np.nonzero(counts % 2)[0].astype(pbd.dtype)
        if len(odd):
            pbd = np.concatenate([pbd, odd])
            pcd = np.concatenate(
                [pcd, np.full(len(odd), pad_chunk, pcd.dtype)])
            tl = np.concatenate(
                [tl, np.zeros((len(odd), R, C), tl.dtype)])
    tail = P_max - len(pbd)
    if tail < 0:
        raise ValueError(
            f"P_max {P_max} below padded device count {len(pbd)}")
    if tail:
        # Tail pairs land on the LAST local block: keeps ascending order
        # and, for U == 2, keeps that block's run even (tail is even
        # because both P_max and every padded count are even).
        pbd = np.concatenate(
            [pbd, np.full(tail, nb_loc - 1, pbd.dtype)])
        pcd = np.concatenate(
            [pcd, np.full(tail, pad_chunk, pcd.dtype)])
        tl = np.concatenate([tl, np.zeros((tail, R, C), tl.dtype)])
    order = np.argsort(pbd, kind="stable")
    return tl[order], pcd[order], pbd[order]


class WindowedRowWise(Strategy):
    """Row-sharded windowed tiles over a 1-D mesh.

    ``kernel`` picks each device's contraction: ``"auto"`` runs the fused
    Triton kernel on the GPU where it supports the tile shape and dtype
    and the XLA einsum otherwise (always on the CPU); ``"pallas"`` asks
    for the kernel explicitly — compiled on the GPU, through the Pallas
    interpreter on the CPU (tests); ``"xla"`` forces the einsum."""

    name = "windowed_row_wise"

    def __init__(self, block_rows: Optional[int] = None,
                 chunk_cols: Optional[int] = None,
                 reorder: str | None = "auto",
                 pairs_per_step: Optional[int] = None,
                 input_mode: str = "auto",
                 kernel: str = "auto"):
        self.block_rows = block_rows
        self.chunk_cols = chunk_cols
        self.reorder = reorder
        if pairs_per_step is None:
            pairs_per_step = PRODUCTION_PAIRS_PER_STEP
        if not isinstance(pairs_per_step, int) or pairs_per_step < 2:
            raise ValueError(
                f"pairs_per_step must be an int >= 2, got {pairs_per_step}")
        self.pairs_per_step = pairs_per_step
        if input_mode not in ("auto", "halo", "replicate"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.input_mode = input_mode
        if kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel

    def prepare(self, csr, mesh: Mesh) -> WindowedRowOperand:
        m, n = csr.shape
        p = int(mesh.devices.size)
        U = self.pairs_per_step
        itemsize = np.asarray(csr.values).dtype.itemsize

        coo = csr.to_coo()
        i = np.asarray(coo.row_indices).astype(np.int64)
        j = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        from ..formats.matrix import coalesce_coo

        # Densifying scatter below assigns — duplicates must be summed
        # first (gather paths and the oracle sum them naturally).
        i, j, vals = coalesce_coo(i, j, vals, n)

        perm = inv_perm = None
        if self.reorder == "auto" and m == n:
            from ..formats.reorder import rcm_ordering

            perm = rcm_ordering(csr).astype(np.int32)
            inv = np.empty(m, dtype=np.int64)
            inv[perm] = np.arange(m)
            i, j = inv[i], inv[j]
            inv_perm = inv.astype(np.int32)

        # Tile shape: pinned or chosen by the single-chip cost model.
        if self.block_rows is not None:
            R, C = int(self.block_rows), int(self.chunk_cols or 128)
        else:
            shapes = [(64, 256), (128, 256), (256, 256), (128, 512),
                      (256, 512), (8, 128), (32, 128), (128, 128)]
            best = None
            for R_c, C_c in shapes:
                if R_c > max(m, 8):
                    continue
                est, _, _, _, _ = windowed_cost_estimate(
                    i, j, m, n, R_c, C_c, itemsize,
                    pairs_per_step=U)
                if best is None or est < best[0]:
                    best = (est, R_c, C_c)
            _, R, C = best

        # Same economics as the shape search above: the dense/spill
        # threshold is priced at the same pairs_per_step.
        pb, pc, tiles_raw, spill_idx = build_dense_pairs(
            i, j, vals, m, n, R, C, itemsize, pairs_per_step=U)

        # Unified padded geometry: one per-device row extent s_loc that
        # is a multiple of BOTH R and C, so the block grid (outputs) and
        # the chunk grid (inputs) shard identically — a chained iterate
        # feeds the row-sharded output straight back as the chunk-
        # sharded input with zero relayout.
        L = math.lcm(R, C)
        s_loc = max(-(-m // (p * L)), 1) * L
        nb_loc = s_loc // R
        ch_loc = s_loc // C
        S = p * s_loc
        n_chunks_global = -(-n // C)

        # Per-device pair slices. Uncovered local blocks — including the
        # phantom blocks past m on the last device — get a dummy zero
        # tile referencing an OWNED chunk (so dummies never widen the
        # halo), as WindowedPairs.from_csr does; then every device is
        # padded to a COMMON P_max under the pad contract
        # (_pad_device_pairs).
        dev_of_pair = pb // nb_loc
        counts = np.bincount(dev_of_pair, minlength=p)
        dev_starts = np.concatenate([[0], np.cumsum(counts)])
        per_dev = []
        for d in range(p):
            lo, hi = dev_starts[d], dev_starts[d + 1]
            local_pb = (pb[lo:hi] - d * nb_loc).astype(np.int32)
            present = np.zeros(nb_loc, dtype=bool)
            present[local_pb] = True
            missing = np.nonzero(~present)[0].astype(np.int32)
            cnt = hi - lo
            own_chunk = min(d * ch_loc, n_chunks_global - 1)
            tl = np.zeros((cnt + len(missing), R, C), dtype=vals.dtype)
            tl[:cnt] = tiles_raw[lo:hi]
            pcd = np.concatenate(
                [pc[lo:hi].astype(np.int32),
                 np.full(len(missing), own_chunk, np.int32)])
            pbd = np.concatenate([local_pb, missing])
            per_dev.append((tl, pcd, pbd, own_chunk, int(cnt)))

        # Spill structures in GLOBAL index space first (the halo window
        # must account for their columns before any rebasing).
        spill_cols = spill_vals = None
        tail_values = tail_rows = tail_cols = None
        if len(spill_idx):
            from ..formats.matrix import COO

            spill_csr = COO.from_arrays(
                vals[spill_idx], i[spill_idx], j[spill_idx], (m, n)
            ).to_csr()
            head, tail = split_csr_by_width(
                spill_csr, _ell_width_cap(spill_csr, 8))
            ell = ELL.from_csr(head, row_align=S)
            spill_cols = np.asarray(ell.cols)
            spill_vals = np.asarray(ell.vals)
            if tail is not None:
                tail_values = np.asarray(tail.values)
                tail_rows = np.asarray(tail.row_indices)
                tail_cols = np.asarray(tail.col_indices)

        # ---- input-mode decision: halo windows from the REAL column
        # footprint of every device (tiles + spill + tail).
        h_l = h_r = 0
        use_halo = self.input_mode in ("auto", "halo") and m == n
        if use_halo:
            need_l = need_r = 0
            for d in range(p):
                _, pcd, _, _, n_real = per_dev[d]
                # Only REAL pairs shape the window: dummy/pad pairs are
                # zero tiles that get clipped into the window at rebase,
                # so phantom blocks past the data never widen the halo.
                real = pcd[:n_real]
                lo_chunks = [int(real.min())] if n_real else []
                hi_chunks = [int(real.max())] if n_real else []
                if spill_cols is not None:
                    sc = spill_cols[d * s_loc:(d + 1) * s_loc]
                    sv = spill_vals[d * s_loc:(d + 1) * s_loc]
                    nz = sv != 0
                    if nz.any():
                        lo_chunks.append(int(sc[nz].min()) // C)
                        hi_chunks.append(int(sc[nz].max()) // C)
                if tail_values is not None:
                    owned = (tail_rows >= d * s_loc) & \
                        (tail_rows < (d + 1) * s_loc)
                    if owned.any():
                        lo_chunks.append(int(tail_cols[owned].min()) // C)
                        hi_chunks.append(int(tail_cols[owned].max()) // C)
                if lo_chunks:
                    need_l = max(need_l, d * ch_loc - min(lo_chunks))
                    need_r = max(need_r,
                                 max(hi_chunks) - ((d + 1) * ch_loc - 1))
            h_l, h_r = max(need_l, 0), max(need_r, 0)
            if self.input_mode == "auto":
                # Halo only when it actually beats replication: the
                # window must be narrower than the full chunk grid.
                use_halo = (h_l + h_r) < (p - 1) * ch_loc
            if p == 1:
                h_l = h_r = 0

        if use_halo:
            tiles, pair_chunk, pair_pos, block_ptr, P_max = \
                self._assemble_pairs(per_dev, nb_loc, U, p, R, C,
                                     rebase=(ch_loc, h_l, h_r))
            if spill_cols is not None:
                dev_row = np.arange(S) // s_loc
                off = (dev_row * s_loc - h_l * C)[:, None]
                spill_cols = np.where(
                    spill_vals != 0, spill_cols - off, h_l * C
                ).astype(np.int32)
            if tail_values is not None:
                tail_values, tail_rows, tail_cols = _shard_tail_by_owner(
                    tail_values, tail_rows, tail_cols, p, s_loc, h_l * C)
        else:
            h_l = h_r = 0
            tiles, pair_chunk, pair_pos, block_ptr, P_max = \
                self._assemble_pairs(per_dev, nb_loc, U, p, R, C,
                                     rebase=None)
            if tail_values is not None:
                from ..formats.matrix import COO

                tail_coo = COO.from_arrays(
                    tail_values, tail_rows, tail_cols, (m, n)
                ).pad_to(-(-len(tail_values) // p) * p)
                tail_values = np.asarray(tail_coo.values)
                tail_rows = np.asarray(tail_coo.row_indices)
                tail_cols = np.asarray(tail_coo.col_indices)

        ax = _axis(mesh)

        def put(x, spec):
            return None if x is None else jax.device_put(
                jnp.asarray(x), NamedSharding(mesh, spec))

        return WindowedRowOperand(
            tiles=put(tiles, P(ax, None, None)),
            pair_chunk=put(pair_chunk, P(ax)),
            pair_pos=put(pair_pos, P(ax)),
            block_ptr=put(block_ptr, P(ax, None)),
            spill_cols=put(spill_cols, P(ax, None)),
            spill_vals=put(spill_vals, P(ax, None)),
            tail_values=put(tail_values, P(ax)),
            tail_rows=put(tail_rows, P(ax)),
            tail_cols=put(tail_cols, P(ax)),
            perm=None if perm is None else np.asarray(perm),
            inv_perm=None if inv_perm is None else np.asarray(inv_perm),
            shape=(m, n), block_rows=R, chunk_cols=C,
            pairs_per_step=U,
            input_mode="halo" if use_halo else "replicate",
            halo_left=int(h_l), halo_right=int(h_r), s_loc=int(s_loc),
        )

    @staticmethod
    def _assemble_pairs(per_dev, nb_loc, U, p, R, C, rebase):
        """Stack per-device pair lists under the pad contract.
        ``rebase=(ch_loc, h_l)`` maps global chunk ids into each
        device's local halo window."""
        if U == 2:
            raw_max = max(
                len(pbd) + int((np.bincount(pbd, minlength=nb_loc) % 2)
                               .sum())
                for _, _, pbd, _, _ in per_dev)
        else:
            raw_max = max(len(pbd) for _, _, pbd, _, _ in per_dev)
        P_max = max(-(-raw_max // U) * U, U)
        vals_dtype = per_dev[0][0].dtype
        tiles = np.zeros((p * P_max, R, C), dtype=vals_dtype)
        pair_chunk = np.zeros(p * P_max, dtype=np.int32)
        pair_pos = np.zeros(p * P_max, dtype=np.int32)
        block_ptr = np.zeros((p, nb_loc + 1), dtype=np.int32)
        for d, (tl, pcd, pbd, own_chunk, _) in enumerate(per_dev):
            if rebase is not None:
                ch_loc, h_l, h_r = rebase
                hi_bound = h_l + ch_loc + h_r - 1
                # Real pairs rebase in-window by construction of the
                # halo; dummy/pad pairs (zero tiles) are merely clipped
                # into it.
                pcd = np.clip(pcd - d * ch_loc + h_l, 0, hi_bound) \
                    .astype(np.int32)
                own_chunk = int(np.clip(own_chunk - d * ch_loc + h_l,
                                        0, hi_bound))
            tl, pcd, pbd = _pad_device_pairs(
                tl, pcd, pbd, nb_loc, P_max, U, pad_chunk=own_chunk)
            sl = slice(d * P_max, (d + 1) * P_max)
            tiles[sl] = tl
            pair_chunk[sl] = pcd
            pair_pos[sl] = pbd
            block_ptr[d] = np.searchsorted(pbd, np.arange(nb_loc + 1))
        return tiles, pair_chunk, pair_pos, block_ptr, P_max

    def spmm(self, operand: WindowedRowOperand, v: jax.Array, mesh: Mesh,
             *, gather_result: bool = True) -> jax.Array:
        """Full-semantics SpMM: encode -> sharded multiply -> decode.

        ``gather_result=False`` leaves the (permuted-space) result
        row-sharded; callers chaining iterations should use
        ``chain_parts`` (boundary permutes once)."""
        out_p = self.spmm_permuted(operand, operand.encode(v), mesh,
                                   gather_result=gather_result)
        if gather_result:
            return operand.decode(out_p)
        return out_p  # sharded, permuted row order (decode after gather)

    def spmm_permuted(self, operand: WindowedRowOperand, v_p: jax.Array,
                      mesh: Mesh, *, gather_result: bool = True
                      ) -> jax.Array:
        ax = _axis(mesh)
        m, n = operand.shape
        R, C = operand.block_rows, operand.chunk_cols
        nb_loc = int(operand.block_ptr.shape[1]) - 1
        k = v_p.shape[1]
        p = int(mesh.devices.size)
        S = p * operand.s_loc
        halo = operand.input_mode == "halo"
        if halo:
            pad_rows = S
            v_spec = P(ax, None)
        else:
            pad_rows = max(-(-n // C) * C, 0)
            v_spec = P(None, None)
        if v_p.shape[0] > pad_rows:
            # Chained ungathered outputs arrive padded to the block grid;
            # the excess rows are structural zeros.
            v_p = v_p[:pad_rows]
        if v_p.shape[0] < pad_rows:
            v_pad = jnp.zeros((pad_rows, k), dtype=v_p.dtype)
            v_pad = jax.lax.dynamic_update_slice(v_pad, v_p, (0, 0))
        else:
            v_pad = v_p
        v_pad = jax.device_put(v_pad, NamedSharding(mesh, v_spec))
        has_spill = operand.spill_cols is not None
        has_tail = operand.tail_values is not None
        zi = jnp.zeros((0,), jnp.int32)
        zv = jnp.zeros((0,), v_p.dtype)
        out = _windowed_row_spmm(
            mesh, ax, gather_result, has_spill, has_tail, R,
            nb_loc, m, halo, operand.halo_left, operand.halo_right, C,
            self.kernel,
            operand.tiles,
            operand.pair_chunk, operand.pair_pos,
            operand.block_ptr,
            operand.spill_cols if has_spill else jnp.zeros((0, 0),
                                                           jnp.int32),
            operand.spill_vals if has_spill else jnp.zeros((0, 0),
                                                           v_p.dtype),
            operand.tail_values if has_tail else zv,
            operand.tail_rows if has_tail else zi,
            operand.tail_cols if has_tail else zi,
            v_pad,
        )
        return out[:m] if gather_result else out

    def chain_parts(self, operand, mesh: Mesh, *,
                    gather_result: bool = True):
        m = operand.shape[0]

        def body(vv, op):
            # With gather_result=False the output stays row-sharded and
            # padded to the block grid (comm-split benchmarking). A
            # chained consumer stays correct either way: in halo mode the row-sharded output IS the next iteration's
            # chunk-sharded input (same s_loc granularity, zero
            # relayout); in replicate mode jit re-gathers it.
            return self.spmm_permuted(op, vv, mesh,
                                      gather_result=gather_result)

        def dec(out, op):
            return op.decode(out[:m] if not gather_result else out)

        return (lambda v, op: op.encode(v), body, dec)


def _shard_tail_by_owner(tv, tr, tc, p: int, s_loc: int, safe_col: int):
    """Row-shard the COO tail by owning device (halo mode): entries land
    on the device that owns their output row, with LOCAL row ids and
    halo-window-local column ids; devices pad to a common count with
    zero-value entries pointing at an owned slot."""
    dev = (tr // s_loc).astype(np.int64)
    t_loc = max(int(np.bincount(dev, minlength=p).max()), 1)
    out_v = np.zeros(p * t_loc, dtype=tv.dtype)
    out_r = np.zeros(p * t_loc, dtype=np.int32)
    out_c = np.full(p * t_loc, safe_col, dtype=np.int32)
    for d in range(p):
        sel = dev == d
        cnt = int(sel.sum())
        base = d * t_loc
        out_v[base: base + cnt] = tv[sel]
        out_r[base: base + cnt] = (tr[sel] - d * s_loc).astype(np.int32)
        out_c[base: base + cnt] = (
            tc[sel] - d * s_loc + safe_col).astype(np.int32)
    return out_v, out_r, out_c


def _halo_window(v_blk, ax, p: int, h_l_rows: int, h_r_rows: int):
    """Assemble each device's extended fat-vector window
    ``[left halo | owned | right halo]`` with one ``ppermute`` per hop
    distance (direct source->dest perms, so multi-hop halos cost
    T_l + T_r collectives of only the needed rows, not chained
    full-block relays). Mesh-boundary positions receive zeros — no
    real pair/spill entry references them (windows are computed from
    the data, which never crosses chunk 0 / n_chunks)."""
    s_loc = v_blk.shape[0]
    idx = jax.lax.axis_index(ax)
    parts = []
    if h_l_rows:
        T = -(-h_l_rows // s_loc)
        for t in range(T, 0, -1):  # farthest block first
            need = h_l_rows - (t - 1) * s_loc if t == T else s_loc
            send = v_blk[s_loc - need:]
            recv = jax.lax.ppermute(
                send, ax, [(d_, (d_ + t) % p) for d_ in range(p)])
            parts.append(jnp.where(idx < t, jnp.zeros_like(recv), recv))
    parts.append(v_blk)
    if h_r_rows:
        T = -(-h_r_rows // s_loc)
        for t in range(1, T + 1):  # nearest block first
            need = h_r_rows - (t - 1) * s_loc if t == T else s_loc
            send = v_blk[:need]
            recv = jax.lax.ppermute(
                send, ax, [(d_, (d_ - t) % p) for d_ in range(p)])
            parts.append(
                jnp.where(idx >= p - t, jnp.zeros_like(recv), recv))
    if len(parts) == 1:
        return v_blk
    return jnp.concatenate(parts, axis=0)


def _local_windowed(tiles_blk, pc_blk, pos_blk, ptr_blk, v_full,
                    nb_loc, R, k, kernel):
    """Per-device contraction: the fused Triton kernel or the XLA
    einsum + segment-sum, as ``WindowedRowWise``'s ``kernel`` says.
    ``v_full`` is whatever chunk-indexed window ``pc_blk`` lives in (the
    replicated padded vector, or the device's halo window)."""
    from ..ops.pallas_windowed import (
        kernel_supports, padded_width, windowed_matmul_pallas,
    )
    from ..utils.backend import platform

    on_gpu = platform() == "gpu"
    C = tiles_blk.shape[2]
    if kernel == "auto":
        use_kernel = on_gpu and kernel_supports(R, C, tiles_blk.dtype)
    else:
        use_kernel = kernel == "pallas"
    if use_kernel:
        kp = padded_width(k)
        v_k = v_full.astype(tiles_blk.dtype)
        if kp != k:
            v_k = jnp.pad(v_k, ((0, 0), (0, kp - k)))
        out = windowed_matmul_pallas(ptr_blk[0], pc_blk, tiles_blk, v_k,
                                     interpret=not on_gpu)
        return out[:, :k]
    n_chunks = v_full.shape[0] // C
    out_dtype = jnp.promote_types(
        jnp.float32, jnp.promote_types(tiles_blk.dtype, v_full.dtype))
    slabs = jnp.take(
        v_full.reshape(n_chunks, C * k), pc_blk, axis=0
    ).reshape(-1, C, k)
    prods = jnp.einsum(
        "prc,pck->prk", tiles_blk, slabs,
        preferred_element_type=out_dtype,
        precision=(jax.lax.Precision.HIGHEST
                   if tiles_blk.dtype == jnp.float32 else
                   jax.lax.Precision.DEFAULT))
    out = jax.ops.segment_sum(prods, pos_blk, num_segments=nb_loc,
                              indices_are_sorted=True)
    return out.reshape(nb_loc * R, k)


@partial(jax.jit, static_argnums=tuple(range(13)))
def _windowed_row_spmm(mesh, ax, gather, has_spill, has_tail,
                       R, nb_loc, m, halo, h_l, h_r, C, kernel,
                       tiles, pair_chunk, pair_pos,
                       block_ptr, spill_cols, spill_vals, tv, tr, tc,
                       v_pad):
    p = mesh.shape[ax]
    m_padded = nb_loc * p * R
    s_loc = nb_loc * R

    def body(tiles_blk, pc_blk, pos_blk, ptr_blk, scols_blk,
             svals_blk, tv_blk, tr_blk, tc_blk, v_in):
        from ..ops.ell import take_rows

        k = v_in.shape[1]
        if halo:
            v_full = _halo_window(v_in, ax, p, h_l * C, h_r * C)
        else:
            v_full = v_in
        out = _local_windowed(
            tiles_blk, pc_blk, pos_blk, ptr_blk, v_full, nb_loc, R, k,
            kernel).astype(v_in.dtype)
        if has_spill:
            gathered = take_rows(v_full, scols_blk.reshape(-1))
            gathered = gathered.reshape(*scols_blk.shape, k)
            out = out + jnp.sum(
                svals_blk[:, :, None].astype(v_in.dtype) * gathered,
                axis=1)
        if has_tail:
            prods = tv_blk[:, None].astype(v_in.dtype) * take_rows(
                v_full, tc_blk)
            if halo:
                # Tail entries are row-owned (local ids): pure local
                # segment-sum, no cross-device reduction at all.
                out = out + jax.ops.segment_sum(
                    prods, tr_blk, num_segments=s_loc)
            else:
                partial_out = jax.ops.segment_sum(
                    prods, tr_blk, num_segments=m_padded)
                out = out + jax.lax.psum_scatter(partial_out, ax,
                                                 tiled=True)
        if gather:
            out = jax.lax.all_gather(out, ax, tiled=True)
        return out

    in_specs = (P(ax, None, None), P(ax), P(ax), P(ax, None))
    args = [tiles, pair_chunk, pair_pos, block_ptr]
    if has_spill:
        in_specs += (P(ax, None), P(ax, None))
        args += [spill_cols, spill_vals]
    else:
        body_full = body
        body = lambda t, pc_, pos_, ptr_, *rest: body_full(
            t, pc_, pos_, ptr_,
            jnp.zeros((nb_loc * R, 0), jnp.int32),
            jnp.zeros((nb_loc * R, 0), rest[-1].dtype),
            *rest)
    if has_tail:
        in_specs += (P(ax), P(ax), P(ax))
        args += [tv, tr, tc]
    else:
        body_sp = body
        body = lambda *a: body_sp(
            *a[:-1],
            jnp.zeros((0,), a[-1].dtype),
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((0,), jnp.int32),
            a[-1])
    in_specs += ((P(ax, None) if halo else P(None, None)),)
    args += [v_pad]
    return jax.shard_map(
        body, mesh=mesh, in_specs=in_specs,
        out_specs=P(None, None) if gather else P(ax, None),
        check_vma=False,
    )(*args)


# Register with the strategy name table.
from .strategies import STRATEGIES  # noqa: E402

STRATEGIES["windowed_row"] = WindowedRowWise
STRATEGIES["windowed_row_wise"] = WindowedRowWise
