"""Segment sums via a bucketed (and optionally column-tiled) ELL layout.

The E-step needs, for every table row, the sum of phi over that row's
nonzeros.  Written as a scatter-add over (nnz, k) rows
(``cython_loops.pxi:594-621``), the sum order on a GPU is set by atomics
and changes from run to run.  Here rows are instead grouped by degree
into width buckets (ELL packing):

    bucket w: rows with (padded) degree w, stored as
      rows:  (m, )   table row id per packed row segment
      cols:  (m, w)  opposite-side ids (padding: 0)
      vals:  (m, w)  counts (padding: 0 -- inert in every sum)

The per-row phi sums are then *dense* reductions over the w axis (gather,
multiply, reduce, which XLA fuses), and the per-bucket outputs are
reassembled into table order by one inverse-permutation gather.  Every
sum has a fixed order, so a fit is bit-identical from run to run.

Rows with degree > ``max_width`` are split into several segments; the
extra segments of such rows are summed by a fixed-shape reduction tree
(``split_seg_pos``) and added to each row once.

Column tiling (``col_chunk_rows``) partitions each row's sorted cols by
fixed-size chunks of the opposite table, producing per-(row, chunk)
segments whose cols are stored chunk-LOCAL; each bucket then gathers
from a statically sliced table chunk.  Rows spanning several chunks
become multi-segment rows.  :func:`plan_col_tiling` decides when a fit
uses it; the table-sharded engine always sub-tiles its shards.

Both sides (user and item) get their own ELL packing (CSR- and CSC-like);
phi is recomputed in each pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from . import PRECISION

# Per-op slot target for the unrolled dense reductions: each op gathers,
# multiplies and reduces about this many (row, col) slots in one fusion,
# and its (c, w, k) temporary is ~TARGET_SLOTS * k * 4 bytes (1.6 GB at
# k=50).  Larger ops raise peak memory; a lax.scan over chunks instead
# serializes the chain.
TARGET_SLOTS = 8 * 1024 * 1024

# Column-tile size: a tiled bucket gathers from a table chunk of at most
# this many bytes (also the table-sharded engine's sub-tile size).
FAST_GATHER_BYTES = 40 * 1024 * 1024
# Opposite tables whose gather copy exceeds this get column-tiled; None:
# never.  On an H100 (400 W limit) at the TasteProfile shape, untiled
# layouts ran 6% (bfloat16 tables) and 11% (float32) faster per iteration
# than tiled ones, with fewer slots and half the compile time (PERF.md,
# scripts/ell_variants.py), so no table size turns tiling on.
TILE_THRESHOLD_BYTES = None


class EllBucket(NamedTuple):
    rows: np.ndarray  # (m,) int32 — table row id of each packed segment
    cols: np.ndarray  # (m, w) int32 — opposite ids (chunk-LOCAL when tiled)
    vals: np.ndarray  # (m, w) real


@dataclass
class EllLayout:
    """Host- or device-side bucketed layout for one side (users or items).

    Registered as a JAX pytree: the bucket/reassembly arrays are leaves;
    ``n_rows`` and ``col_spans`` are static aux data (so per-bucket table
    slicing bounds are compile-time constants when the layout is passed as
    a jit argument).
    """

    buckets: List[EllBucket]
    # order of concat(bucket.rows) is "segment order"; for non-split rows the
    # inverse permutation maps table row -> its (single) segment position.
    inv_perm: np.ndarray  # (n_rows,) int64 -- position of each row's 1st seg
    split_rows: np.ndarray  # (n_split,) int64 -- rows with >1 segment, unique
    # reduction tree over each split row's remaining segments: level 0
    # indexes segment positions, level l > 0 the rows of level l-1's
    # output; every level is (n_l, SPLIT_FANIN), -1 -> a zero row, and the
    # last level has exactly one output row per ``split_rows`` entry
    split_seg_pos: Tuple[np.ndarray, ...]
    n_rows: int
    # per-bucket (start, end) row span of the opposite table the bucket's
    # cols index into, or None per bucket for whole-table; None overall
    # when the layout is untiled
    col_spans: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None

    def tree_flatten(self):
        children = (self.buckets, self.inv_perm, self.split_rows,
                    self.split_seg_pos)
        aux = (self.n_rows, self.col_spans)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        buckets, inv_perm, split_rows, split_seg_pos = children
        n_rows, col_spans = aux
        return cls(buckets=buckets, inv_perm=inv_perm, split_rows=split_rows,
                   split_seg_pos=split_seg_pos, n_rows=n_rows,
                   col_spans=col_spans)


def _register_pytree():
    import jax

    jax.tree_util.register_pytree_node(
        EllLayout,
        lambda l: l.tree_flatten(),
        EllLayout.tree_unflatten,
    )


try:  # defer-safe: numpy-only users never touch jax
    _register_pytree()
except Exception:  # pragma: no cover
    pass


def plan_col_tiling(n_opposite_rows: int, k: int, gather_itemsize: int = 4
                    ) -> Optional[int]:
    """Chunk row count for column tiling, or None when the opposite table's
    gather copy is at or under ``TILE_THRESHOLD_BYTES`` (always, when that
    is None)."""
    table_bytes = n_opposite_rows * k * gather_itemsize
    if TILE_THRESHOLD_BYTES is None or table_bytes <= TILE_THRESHOLD_BYTES:
        return None
    return max(1, FAST_GATHER_BYTES // (k * gather_itemsize))


_LADDER_FRACS = {
    "half": (1.0, 0.75),               # round-1/2 ladder (pow2 + 3/4)
    "quarter": (1.0, 7 / 8, 0.75, 5 / 8),
    "eighth": tuple(x / 16 for x in range(9, 17)),
}
_ladder_cache = {}


def _width_ladder() -> np.ndarray:
    """Sorted rung widths for degree bucketing (see the fill table at the
    bucketing step in :func:`build_ell`).  Env-tunable:
    ``HPFREC_ELL_LADDER`` = half | quarter (default) | eighth."""
    import os

    name = os.environ.get("HPFREC_ELL_LADDER", "quarter")
    if name not in _ladder_cache:
        fracs = _LADDER_FRACS.get(name, _LADDER_FRACS["quarter"])
        rungs = {int(np.ceil((1 << e) * f))
                 for e in range(0, 15) for f in fracs}
        _ladder_cache[name] = np.array(sorted(rungs), dtype=np.int64)
    return _ladder_cache[name]


def _ragged_fill(seg_start, seg_len, indices, data, cols, vals, dtype):
    """Fill pre-zeroed (m, w) cols/vals from CSR runs (native or numpy)."""
    try:
        from .._native import ell_fill  # parallel C++ fill

        ell_fill(seg_start, seg_len, indices, data.astype(dtype, copy=False),
                 cols, vals)
    except Exception:
        m = len(seg_start)
        flat_rows = np.repeat(np.arange(m, dtype=np.int64), seg_len)
        total = int(seg_len.sum())
        flat_cols = (np.arange(total, dtype=np.int64)
                     - np.repeat(np.cumsum(seg_len) - seg_len, seg_len))
        src = np.repeat(seg_start, seg_len) + flat_cols
        cols[flat_rows, flat_cols] = indices[src]
        vals[flat_rows, flat_cols] = data[src]


# Fan-in of each level of the split-row reduction tree.  Segment counts
# are heavily skewed (a catalog-head row can have hundreds of max_width
# splits while most split rows have a handful), so a dense
# (n_split, max_segs) matrix would be mostly padding; a tree of narrow
# levels keeps every level small and sums in a fixed order.
SPLIT_FANIN = 4


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """concat(arange(c) for c in counts)."""
    counts = counts.astype(np.int64, copy=False)
    total = int(counts.sum())
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))


def split_tree(pos: np.ndarray, counts: np.ndarray,
               fanin: int = SPLIT_FANIN) -> Tuple[np.ndarray, ...]:
    """Levels of a fixed-order reduction over ragged groups.

    ``pos`` holds the group members' positions, group after group, and
    ``counts`` (all >= 1) the group sizes.  Level 0 chunks each group into
    ``fanin``-wide rows of positions; each further level chunks the
    previous level's output rows of one group the same way, until every
    group has one output row.  Returns the tuple of (n_l, fanin) int64
    index matrices (-1 = nothing); empty when there are no groups."""
    levels = []
    counts = counts.astype(np.int64, copy=False)
    if not len(counts):
        return ()
    while True:
        j = _ragged_arange(counts)
        nchunk = -(-counts // fanin)
        first = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(nchunk, out=first[1:])
        mat = np.full((int(first[-1]), fanin), -1, dtype=np.int64)
        grp = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        mat[first[grp] + j // fanin, j % fanin] = pos
        levels.append(mat)
        if int(nchunk.max()) == 1:
            return tuple(levels)
        # each group's chunk outputs are contiguous rows of this level
        pos, counts = np.arange(int(first[-1]), dtype=np.int64), nchunk


def reduce_split_tree(seg, levels):
    """Sum each group of ``seg`` rows through the :func:`split_tree`
    levels; returns one (k,) row per group, in group order."""
    import jax.numpy as jnp

    x = seg
    for lvl in levels:
        xz = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)], axis=0)
        x = jnp.sum(xz[lvl], axis=1)
    return x


def build_ell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              n_rows: int, min_width: int = 8, max_width: int = 8192,
              dtype=np.float32, pad_shards: int = 1,
              col_chunk_rows: Optional[int] = None,
              n_cols: Optional[int] = None) -> EllLayout:
    """Pack a CSR side into degree buckets (host, O(nnz)).

    ``pad_shards`` pads every bucket's segment count to a multiple of the
    mesh size with inert dummy segments (row 0, zero vals) so the m axis
    shards evenly; segment positions (inv_perm etc.) account for the
    padding.

    ``col_chunk_rows`` (with ``n_cols``) enables column tiling: each row's
    sorted cols are partitioned at chunk boundaries into per-(row, chunk)
    segments whose cols are stored chunk-local, and each bucket carries the
    (start, end) span of the opposite table it gathers from.
    """
    deg = np.diff(indptr).astype(np.int64)
    nnz = int(indices.shape[0])

    if col_chunk_rows is not None:
        assert n_cols is not None, "col tiling needs n_cols"
        # runs of (row, chunk) require cols sorted within each row, which
        # the CSR builders do NOT guarantee (counting sort preserves input
        # order).  Unsorted rows fragment into per-nonzero runs — measured
        # at MillionSong scale: 24.5M segments / 20% bucket fill instead of
        # ~1M / 86% — so sort here (one-time host cost amortized over the
        # fit).  The native per-row parallel sort replaces the full-key
        # stable argsort, which measured ~18 s at 38.7M nonzeros.
        row_of = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
        sorted_done = False
        if (nnz and indices.dtype == np.int32
                and data.dtype in (np.float32, np.float64)):
            try:
                from .._native import sort_csr_cols

                # copy: sort is in place, callers keep their order.  Called
                # unconditionally — the kernel's per-row sorted check is a
                # 0.1 s scan at 38.7M nnz, vs 3.4 s (and two 310 MB temps)
                # for the numpy combined-key check it replaces.
                indices = np.ascontiguousarray(indices).copy()
                data = np.ascontiguousarray(data).copy()
                sort_csr_cols(indptr, indices, data)
                sorted_done = True
            except Exception as e:
                # a broken native build silently degrading to the ~18 s
                # numpy argsort path would be undiagnosable — warn once
                import warnings

                warnings.warn(
                    "native sort_csr_cols unavailable (%s); falling back to "
                    "the slower numpy per-row sort for ELL packing" % (e,))
        if nnz and not sorted_done:
            key_rc = row_of * np.int64(n_cols) + indices.astype(np.int64)
            if np.any(np.diff(key_rc) < 0):
                order = np.argsort(key_rc, kind="stable")
                indices, data = indices[order], data[order]
        chunk_of = indices.astype(np.int64) // col_chunk_rows
        key = row_of * ((n_cols // col_chunk_rows) + 1) + chunk_of
        boundaries = np.flatnonzero(np.diff(key) != 0) + 1
        run_start = np.concatenate([[0], boundaries]) if nnz else np.zeros(0, np.int64)
        run_len = np.diff(np.concatenate([run_start, [nnz]]))
        run_row = row_of[run_start] if nnz else np.zeros(0, np.int64)
        run_chunk = chunk_of[run_start] if nnz else np.zeros(0, np.int64)
        # rows with zero degree still need one (empty -> width-min) segment
        empty = np.flatnonzero(deg == 0)
        if len(empty):
            run_start = np.concatenate([run_start, indptr[empty]])
            run_len = np.concatenate([run_len, np.zeros(len(empty), np.int64)])
            run_row = np.concatenate([run_row, empty])
            run_chunk = np.concatenate([run_chunk, np.zeros(len(empty), np.int64)])
            order = np.argsort(run_row, kind="stable")
            run_start, run_len = run_start[order], run_len[order]
            run_row, run_chunk = run_row[order], run_chunk[order]
    else:
        run_start = indptr[:-1].astype(np.int64)
        run_len = deg
        run_row = np.arange(n_rows, dtype=np.int64)
        run_chunk = np.zeros(n_rows, dtype=np.int64)

    # split runs longer than max_width into bounded segments
    nseg_per_run = np.maximum(1, -(-run_len // max_width))
    rep = np.repeat(np.arange(len(run_row), dtype=np.int64), nseg_per_run)
    first_of_run = np.zeros(len(run_row) + 1, dtype=np.int64)
    np.cumsum(nseg_per_run, out=first_of_run[1:])
    idx_in_run = np.arange(len(rep), dtype=np.int64) - first_of_run[rep]
    seg_row = run_row[rep]
    seg_chunk = run_chunk[rep]
    seg_start = run_start[rep] + idx_in_run * max_width
    seg_len = np.minimum(run_len[rep] - idx_in_run * max_width, max_width)

    # per-row segment counts/offsets (segments are row-contiguous by
    # construction: runs are row-major, splits stay adjacent)
    nseg_per_row = np.bincount(seg_row, minlength=n_rows).astype(np.int64)
    first_seg = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(nseg_per_row, out=first_seg[1:])

    # bucket by (chunk, width >= min_width) on a dense width ladder.  The
    # engine is gather-slot bound, so padded slots are pure waste; w sits
    # in the MIDDLE axis of the (m, w, k) compute, so odd widths lose no
    # lane alignment.  Measured at the MillionSong shape (38.7M nnz, both
    # sides): pow2-only rungs reach 70.5% fill, pow2 + the 3/4
    # intermediates 83.9%, the quarter-octave ladder (x{1, 7/8, 3/4, 5/8},
    # default) 90.5% at 53 distinct widths, eighth-octave 93.8% at 103.
    # Denser rungs double the bucket count each step — compile time and
    # per-op overhead grow — so the rung set is env-tunable
    # (HPFREC_ELL_LADDER = half | quarter | eighth).
    width = _width_ladder()[
        np.searchsorted(_width_ladder(), np.maximum(seg_len, 1))]
    width = np.minimum(np.maximum(width, min_width), max_width)
    tiled = col_chunk_rows is not None
    # merge small width-buckets (within a chunk, for tiled layouts) into
    # the NEXT rung; each hop is gated at 1.5x so one merge can cost at
    # most a third of the merged bucket's slots.  NOTE the gate is per
    # hop, not global: a merged bucket is re-considered at the next rung,
    # so merges can CASCADE (w -> ws[j+1] -> ws[j+2]) and a segment's
    # final width may exceed 1.5x its original rung — intentional, since
    # a bucket that is still tiny after one merge is still op-overhead-
    # bound.  Threshold trade-off counted at the MillionSong shape with
    # the quarter ladder: 2^20 -> 94.1M slots / ~46 ops, 2^17 -> 85.9M /
    # ~120 ops, no merge -> 85.5M / ~138 ops.  The default leans to fill
    # (2^17); HPFREC_ELL_MERGE_LOG2 overrides.  Merging applies to
    # untiled layouts too.
    import os

    MERGE_SLOTS = 1 << int(os.environ.get("HPFREC_ELL_MERGE_LOG2", "17"))
    for c in np.unique(seg_chunk):
        in_c = seg_chunk == c
        ws = np.unique(width[in_c])
        for j, w in enumerate(ws[:-1]):
            sel = in_c & (width == w)
            if sel.sum() * w < MERGE_SLOTS and 2 * ws[j + 1] <= 3 * w:
                width[sel] = ws[j + 1]

    bucket_key = seg_chunk * (2 * max_width) + width if tiled else width

    buckets: List[EllBucket] = []
    spans: List[Optional[Tuple[int, int]]] = []
    seg_positions = np.empty(len(seg_row), dtype=np.int64)
    pos = 0
    for key_val in np.unique(bucket_key):
        sel = np.flatnonzero(bucket_key == key_val)
        if tiled:
            c = int(key_val) // (2 * max_width)
            w = int(key_val) % (2 * max_width)
            off = c * col_chunk_rows
            span = (off, min(off + col_chunk_rows, int(n_cols)))
        else:
            w = int(key_val)
            span = None
            off = 0
        m = len(sel)
        m_pad = ((m + pad_shards - 1) // pad_shards) * pad_shards
        cols = np.zeros((m_pad, w), dtype=np.int32)
        vals = np.zeros((m_pad, w), dtype=dtype)
        rows_arr = np.zeros(m_pad, dtype=np.int32)
        rows_arr[:m] = seg_row[sel]
        lens = seg_len[sel]
        _ragged_fill(seg_start[sel], lens, indices, data, cols[:m], vals[:m],
                     dtype)
        if off:
            # store chunk-local ids; padding slots (cols 0) stay in-bounds
            np.subtract(cols[:m], np.int32(off), out=cols[:m],
                        where=vals[:m] != 0)
        buckets.append(EllBucket(rows=rows_arr, cols=cols, vals=vals))
        spans.append(span)
        seg_positions[sel] = pos + np.arange(m, dtype=np.int64)
        pos += m_pad

    # inverse permutation: first segment of every row
    inv_perm = seg_positions[first_seg[:-1]]

    split = np.flatnonzero(nseg_per_row > 1)
    counts = nseg_per_row[split] - 1
    src = np.repeat(first_seg[split] + 1, counts) + _ragged_arange(counts)
    split_seg_pos = split_tree(seg_positions[src], counts)
    return EllLayout(buckets=buckets, inv_perm=inv_perm,
                     split_rows=split.astype(np.int64),
                     split_seg_pos=split_seg_pos, n_rows=n_rows,
                     col_spans=tuple(spans) if tiled else None)


def layout_slots(layout) -> int:
    """Total gather slots of a layout's buckets, pad segments included —
    the engine's unit of work.  One E-step side costs exactly this many
    fused gather+multiply+reduce slots, so ``sum(layout_slots(side) for
    side in (user, item)) / t_iter`` is the sustained slot rate.  Works
    for both :class:`EllLayout` ((m, w) buckets)
    and the table-sharded ``ShardedEll`` ((ndev, m, w) buckets — the
    common frame is gathered on every device, so all-device slots are the
    honest total)."""
    return int(sum(int(np.prod(b.cols.shape)) for b in layout.buckets))


def device_ell(layout: EllLayout) -> EllLayout:
    """Move bucket arrays to device (jnp) preserving structure."""
    import jax.numpy as jnp

    return EllLayout(
        buckets=[EllBucket(jnp.asarray(b.rows), jnp.asarray(b.cols),
                           jnp.asarray(b.vals)) for b in layout.buckets],
        inv_perm=jnp.asarray(layout.inv_perm),
        split_rows=jnp.asarray(layout.split_rows),
        split_seg_pos=tuple(jnp.asarray(l) for l in layout.split_seg_pos),
        n_rows=layout.n_rows,
        col_spans=layout.col_spans,
    )


def _dep_stride(value=None, acc_dtype=None) -> int:
    """Resolve the barrier stride: every chunk op barriers on the op
    ``stride`` back, so up to ``stride`` (c, w, k) temporaries
    (~``TARGET_SLOTS`` · k · acc-itemsize bytes each, ~1.6 GB at k=50
    f32) are live at once and adjacent gathers can overlap.

    Default 2: two adjacent ops may overlap, while peak memory stays at
    two temporaries; without any chain XLA fuses all ops horizontally
    and plans every temporary live at once.  1 is the strict chain
    (env ``HPFREC_ELL_DEP_STRIDE`` or the ``dep_stride`` parameter).

    With an ``acc_dtype`` of float64 the default is 1: float64 doubles
    every temporary's bytes.  The env var / parameter still override."""
    import os

    if value is not None:
        return max(1, int(value))
    env = os.environ.get("HPFREC_ELL_DEP_STRIDE")
    if env is not None:
        return max(1, int(env))
    if acc_dtype is not None and np.dtype(acc_dtype) == np.float64:
        return 1
    return 2


def _bucket_phi_sums(t_self, t_other, rows, cols, vals,
                     target_slots: int = TARGET_SLOTS, deps=None,
                     dep_stride: int = 1, minirow=None):
    """Per-segment phi sums for one bucket: (m, k) dense reduction.

    phi[r, j, :] = vals[r, j] * (t_self[rows[r]] * t_other[cols[r, j]]) / <t_self[rows[r]], t_other[cols[r, j]]>
    returns (sum_j phi[r, j, :], deps).

    Large buckets are processed as an UNROLLED sequence of single fused
    ops of ~``target_slots`` slots each (see ``TARGET_SLOTS``).  ``deps`` is the rolling history of recent chunk outputs
    (shared across buckets by the caller): each chunk takes an
    ``optimization_barrier`` on the output ``dep_stride`` ops back, so at
    most ``dep_stride`` (c, w, k) temporaries are live — without any
    chain XLA horizontally fuses ALL chunks and plans every temporary
    live at once (observed: a 27 GB allocation at 48M-nnz scale).

    ``t_self``/``t_other`` may arrive in a reduced gather dtype (bfloat16 —
    see :func:`gather_table_dtype`); arithmetic promotes to the
    accumulation dtype right after the gather.
    """
    import os

    import jax.numpy as jnp
    from jax import lax

    m, w = cols.shape
    acc_dt = jnp.float32 if t_self.dtype in (jnp.bfloat16, jnp.float32) else t_self.dtype
    if deps is None:
        deps = []
    # Mini-row reshape (experimental, OFF by default): each /8-divisible
    # (c, w) block is viewed as (c, w/8, 8) mini-rows.  Value-identical to
    # the plain form; it has not been measured faster on any cell.
    if minirow is None:
        minirow = os.environ.get("HPFREC_ELL_MINIROW", "0") == "1"
    minirow = minirow and w > 8 and w % 8 == 0

    def chunk_sums(rows_c, cols_c, vals_c):
        if len(deps) >= dep_stride:
            # order this chunk after the op `dep_stride` back so only
            # that many temporaries are ever live
            rows_c, _ = lax.optimization_barrier(
                (rows_c, deps[-dep_stride]))
        c = rows_c.shape[0]
        if minirow:
            # 4D form: one self gather per original row
            b = w // 8
            cols_m = cols_c.reshape(c, b, 8)
            vals_m = vals_c.reshape(c, b, 8)
            p = (t_self[rows_c].astype(acc_dt)[:, None, None, :]
                 * t_other[cols_m].astype(acc_dt))  # (c, b, 8, k)
            denom = jnp.sum(p, axis=-1)
            scale = jnp.where(denom > 0, vals_m.astype(acc_dt) / denom, 0.0)
            out = jnp.einsum("cbw,cbwk->ck", scale, p,
                             preferred_element_type=acc_dt,
                             precision=PRECISION)
        else:
            # factorized phi: p = t_self[row] * t_other[col];
            # phi = y * p / sum(p)
            p = (t_self[rows_c].astype(acc_dt)[:, None, :]
                 * t_other[cols_c].astype(acc_dt))  # (c, w, k)
            denom = jnp.sum(p, axis=-1)  # (c, w)
            scale = jnp.where(denom > 0, vals_c.astype(acc_dt) / denom, 0.0)
            out = jnp.einsum("cw,cwk->ck", scale, p,
                             preferred_element_type=acc_dt,
                             precision=PRECISION)
        deps.append(out)
        del deps[:-max(dep_stride, 1)]
        return out

    if m * w <= target_slots:
        return chunk_sums(rows, cols, vals), deps

    c = max(1, target_slots // w)
    parts = []
    for st in range(0, m, c):
        parts.append(chunk_sums(rows[st:st + c], cols[st:st + c],
                                vals[st:st + c]))
    return jnp.concatenate(parts, axis=0), deps


def all_bucket_sums(t_self, t_other, buckets, col_spans=None,
                    target_slots: int = TARGET_SLOTS, dep_stride=None,
                    minirow=None):
    """Concatenated per-segment phi sums over all buckets: (m_total, k).

    With ``col_spans``, each tiled bucket gathers from a statically sliced
    chunk of ``t_other`` (the large-table fast path); slices are shared
    across buckets with the same span.  A dependency chain across buckets
    bounds temporary liveness to ``dep_stride`` ops (see
    ``_bucket_phi_sums`` / :func:`_dep_stride`).
    """
    import jax.numpy as jnp
    from jax import lax

    stride = _dep_stride(dep_stride, acc_dtype=t_self.dtype)
    k = t_other.shape[1]
    slices = {}
    parts = []
    deps = []
    for j, b in enumerate(buckets):
        span = col_spans[j] if col_spans is not None else None
        if span is None:
            tab = t_other
        else:
            if span not in slices:
                slices[span] = lax.slice(t_other, (span[0], 0), (span[1], k))
            tab = slices[span]
        out, deps = _bucket_phi_sums(t_self, tab, b.rows, b.cols, b.vals,
                                     target_slots, deps=deps,
                                     dep_stride=stride, minirow=minirow)
        parts.append(out)
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def segment_table_sums(seg, layout: EllLayout):
    """Reassemble per-segment sums (m_total, k) into table order (n_rows, k):
    one inverse-permutation gather (each row's first segment), plus each
    split row's remaining segments summed through its reduction tree and
    added once (``split_rows`` is unique, so every row's sum has one fixed
    order)."""
    out = seg[layout.inv_perm]
    if layout.split_rows.shape[0]:
        extra = reduce_split_tree(seg, layout.split_seg_pos)
        out = out.at[layout.split_rows].add(extra, unique_indices=True,
                                            mode="promise_in_bounds")
    return out


def ell_phi_sums(t_self, t_other, layout: EllLayout,
                 target_slots: int = TARGET_SLOTS, side: str = "user",
                 dep_stride=None, minirow=None):
    """Per-table-row phi sums, shape (n_rows, k).  Scatter-free.

    ``side`` ('user' | 'item') names which layout this call is for; the
    default implementation doesn't need it, but substituted ``phi_sums_fn``
    implementations (the sharded engines) dispatch on it — shape-based
    dispatch is unsound when ``nusers == nitems`` with coincident bucket
    ladders."""
    del side
    return segment_table_sums(
        all_bucket_sums(t_self, t_other, layout.buckets,
                        col_spans=layout.col_spans,
                        target_slots=target_slots, dep_stride=dep_stride,
                        minirow=minirow),
        layout)


def _side_work_items(t_self, t_other, layout: EllLayout):
    """Yield ``(t_self, table_or_slice, bucket)`` work units for one side,
    sharing column-tile slices across same-span buckets (the per-side loop
    body of :func:`all_bucket_sums`, factored for interleaving)."""
    from jax import lax

    k = t_other.shape[1]
    slices = {}
    items = []
    for j, b in enumerate(layout.buckets):
        span = layout.col_spans[j] if layout.col_spans is not None else None
        if span is None:
            tab = t_other
        else:
            if span not in slices:
                slices[span] = lax.slice(t_other, (span[0], 0), (span[1], k))
            tab = slices[span]
        items.append((t_self, tab, b))
    return items


def ell_phi_sums_interleaved(t_tab, b_tab, ell_u: EllLayout, ell_i: EllLayout,
                             target_slots: int = TARGET_SLOTS,
                             dep_stride=None):
    """BOTH sides' per-row phi sums with the two bucket-op chains
    interleaved under ONE shared dependency chain.

    The default step runs the user side's ~N ops chained among
    themselves, then the item side's: nothing orders the sides against
    each other, so XLA's scheduler decides whether they overlap.  This
    variant alternates ops from the two sides (proportionally, so both
    chains drain together) on a single ``dep_stride`` chain — adjacent
    ops then gather from DIFFERENT tables, which could overlap memory
    streams.  Legal because both
    sides read the same carried tables; the side updates happen after
    both sums exist (``cavi_step_ell_carried``)."""
    import jax.numpy as jnp

    stride = _dep_stride(dep_stride, acc_dtype=t_tab.dtype)
    items_u = _side_work_items(t_tab, b_tab, ell_u)
    items_i = _side_work_items(b_tab, t_tab, ell_i)
    nu, ni = len(items_u), len(items_i)
    deps = []
    parts_u: list = []
    parts_i: list = []
    iu = ii = 0
    while iu < nu or ii < ni:
        # keep iu/nu ~= ii/ni so neither chain runs dry early
        if iu < nu and (ii >= ni or iu * ni <= ii * nu):
            ts, tab, b = items_u[iu]
            iu += 1
            out, deps = _bucket_phi_sums(ts, tab, b.rows, b.cols, b.vals,
                                         target_slots, deps=deps,
                                         dep_stride=stride)
            parts_u.append(out)
        else:
            ts, tab, b = items_i[ii]
            ii += 1
            out, deps = _bucket_phi_sums(ts, tab, b.rows, b.cols, b.vals,
                                         target_slots, deps=deps,
                                         dep_stride=stride)
            parts_i.append(out)
    su = segment_table_sums(
        jnp.concatenate(parts_u, axis=0) if len(parts_u) > 1 else parts_u[0],
        ell_u)
    si = segment_table_sums(
        jnp.concatenate(parts_i, axis=0) if len(parts_i) > 1 else parts_i[0],
        ell_i)
    return su, si


def gather_table_dtype(mode: str = "auto"):
    """Pick the dtype the expectation tables are *gathered* in: bfloat16
    when ``mode`` is 'bfloat16', otherwise None (the compute dtype).

    bfloat16 tables halve the bytes each gather moves while all arithmetic
    stays float32 (cast-up straight after the gather).  'auto' keeps
    float32: on an H100 (400 W limit) at the TasteProfile shape bfloat16
    tables were 8% faster per iteration, too little to give up float32
    (PERF.md)."""
    import jax.numpy as jnp

    return jnp.bfloat16 if mode == "bfloat16" else None


def cavi_step_ell(state, ell_u: EllLayout, ell_i: EllLayout, hp,
                  phi_sums_fn=None, gather_dtype=None):
    """Full-batch CAVI iteration on the bucketed layout (same update order
    as ``cavi.cavi_step`` / reference ``cython_loops.pxi:227-259``), with
    both segment sums computed scatter-free.  phi is evaluated twice (once
    per side) — cheap next to any scatter.  ``phi_sums_fn`` lets the
    sharded engine substitute its shard_map variant.  ``gather_dtype``
    (None | jnp.bfloat16): storage dtype of the gathered exp tables; see
    :func:`gather_table_dtype`."""
    import jax.numpy as jnp

    from ..models.state import VariationalState
    from .cavi import exp_elog_tables

    fn = phi_sums_fn if phi_sums_fn is not None else ell_phi_sums
    t_tab = exp_elog_tables(state.G_shp, state.G_rte)
    b_tab = exp_elog_tables(state.L_shp, state.L_rte)
    if gather_dtype is not None:
        t_tab = t_tab.astype(gather_dtype)
        b_tab = b_tab.astype(gather_dtype)
    # cast back to the state dtype: with forced bfloat16 gathers under a
    # float64 state the accumulation dtype is float32, and a dtype change
    # would break the fori_loop carry
    su = fn(t_tab, b_tab, ell_u, side="user").astype(state.G_shp.dtype)
    si = fn(b_tab, t_tab, ell_i, side="item").astype(state.L_shp.dtype)

    Beta_old = state.L_shp / state.L_rte
    G_rte = hp.k_shp / state.k_rte + jnp.sum(Beta_old, axis=0, keepdims=True)
    G_shp = hp.a + su
    Theta = G_shp / G_rte

    L_rte = hp.t_shp / state.t_rte + jnp.sum(Theta, axis=0, keepdims=True)
    L_shp = hp.c + si
    Beta = L_shp / L_rte

    k_rte = hp.add_k_rte + jnp.sum(Theta, axis=1, keepdims=True)
    t_rte = hp.add_t_rte + jnp.sum(Beta, axis=1, keepdims=True)
    return VariationalState(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte)


def _carry_init(state, gather_dtype):
    """Derive the loop-carried auxiliaries from a state: both sides' exp
    tables and colsum(Beta)."""
    import jax.numpy as jnp

    from .cavi import exp_elog_tables

    t_tab = exp_elog_tables(state.G_shp, state.G_rte)
    b_tab = exp_elog_tables(state.L_shp, state.L_rte)
    if gather_dtype is not None:
        t_tab = t_tab.astype(gather_dtype)
        b_tab = b_tab.astype(gather_dtype)
    beta_colsum = jnp.sum(state.L_shp / state.L_rte, axis=0, keepdims=True)
    return state, t_tab, b_tab, beta_colsum


def cavi_step_ell_carried(carry, ell_u: EllLayout, ell_i: EllLayout, hp,
                          phi_sums_fn=None, gather_dtype=None,
                          phi_pair_fn=None):
    """One CAVI iteration on a ``(state, t_tab, b_tab, colsum(Beta))``
    carry — the multi-iteration form of :func:`cavi_step_ell`.

    Same math, restructured to cut O((nU+nI)·k) table traffic between
    E-step passes: instead of re-deriving ``exp(digamma(shp) - log(rte))``
    for both sides and re-computing ``colsum(L_shp/L_rte)`` from the
    carried state at the top of every iteration (five full passes over
    the tables that XLA cannot fuse across the ``fori_loop`` carry), each
    iteration produces the NEXT iteration's exp table and Beta colsum at
    the point where the side's shp/rte are updated, where XLA fuses them
    with the ``Theta = shp/rte`` division and the colsum/rowsum
    reductions.  Expressions are identical on identical values, so the
    trajectory is unchanged."""
    import jax.numpy as jnp

    from ..models.state import VariationalState
    from .cavi import exp_elog_tables

    state, t_tab, b_tab, beta_colsum = carry
    if phi_pair_fn is not None:
        # joint-sides variant (e.g. ell_phi_sums_interleaved): both sums
        # from one call so the op chains can share a dependency chain
        su, si = phi_pair_fn(t_tab, b_tab, ell_u, ell_i)
        su = su.astype(state.G_shp.dtype)
        si = si.astype(state.L_shp.dtype)
    else:
        fn = phi_sums_fn if phi_sums_fn is not None else ell_phi_sums
        su = fn(t_tab, b_tab, ell_u, side="user").astype(state.G_shp.dtype)
        si = fn(b_tab, t_tab, ell_i, side="item").astype(state.L_shp.dtype)

    G_rte = hp.k_shp / state.k_rte + beta_colsum
    G_shp = hp.a + su
    Theta = G_shp / G_rte
    t_new = exp_elog_tables(G_shp, G_rte)

    L_rte = hp.t_shp / state.t_rte + jnp.sum(Theta, axis=0, keepdims=True)
    L_shp = hp.c + si
    Beta = L_shp / L_rte
    b_new = exp_elog_tables(L_shp, L_rte)
    if gather_dtype is not None:
        t_new = t_new.astype(gather_dtype)
        b_new = b_new.astype(gather_dtype)

    k_rte = hp.add_k_rte + jnp.sum(Theta, axis=1, keepdims=True)
    t_rte = hp.add_t_rte + jnp.sum(Beta, axis=1, keepdims=True)
    new_state = VariationalState(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte)
    return (new_state, t_new, b_new,
            jnp.sum(Beta, axis=0, keepdims=True))


def run_cavi_block_ell(state, ell_u: EllLayout, ell_i: EllLayout, niter, hp,
                       phi_sums_fn=None, gather_dtype=None,
                       phi_pair_fn=None):
    """``niter`` ELL CAVI iterations in one XLA program (jit-cached by the
    caller; layouts are pytrees of arrays).  Uses the carried-tables step
    (:func:`cavi_step_ell_carried`); per-block overhead is one extra
    carry-init table derivation, amortized over the block."""
    import jax

    def body(_, carry):
        return cavi_step_ell_carried(carry, ell_u, ell_i, hp,
                                     phi_sums_fn=phi_sums_fn,
                                     gather_dtype=gather_dtype,
                                     phi_pair_fn=phi_pair_fn)

    carry = jax.lax.fori_loop(0, niter, body, _carry_init(state, gather_dtype))
    return carry[0]
