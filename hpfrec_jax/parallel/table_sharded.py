"""Fully table-sharded CAVI engine (the model-parallel mode).

The data-parallel engine replicates the factor tables and shards nonzeros.
This engine shards BOTH: user-side tables (G_shp, G_rte, k_rte) are
row-sharded by user, item-side tables by item, and each device owns the
ELL-packed nonzeros of exactly its own rows (both the CSR-side and the
CSC-side packing).  This is the distributed analogue SURVEY.md §7.3 calls
the core novel engineering: routing per-nonzero contributions to the owner
shard, here made trivial by partitioning nonzeros BY owner row so
contributions never cross shards.

Ring-streamed opposite-table exchange
-------------------------------------
All-gathering the FULL opposite exp table per iteration would cost
O(n_opposite x k) memory per device, defeating the point of sharding for
catalogs too big to replicate.

This version never materializes the full opposite table.  Each device's
segments are keyed at build time by the ring OFFSET ``o = (d - e) % ndev``
of the opposite shard ``e`` they reference (cols stored shard-local), and
at run time the opposite shard travels a ``ppermute`` ring: at step ``o``
device ``d`` holds shard ``(d - o) % ndev`` and reduces exactly its
offset-``o`` buckets against it.  Total communication equals one tiled
all_gather (each shard visits each device once) but peak memory is TWO
shards instead of the whole table, comm overlaps compute, and shards are
sub-tiled to ``FAST_GATHER_BYTES`` chunks (optionally exchanged in
bfloat16, ``gather_dtype``).

Per iteration the remaining communication is two scalar-vector ``psum``
for the colsum terms of the rate updates; phi, segment sums, and the
Gamma updates are all local.

Padding: user/item counts are padded so each device's row count is an
exact multiple of the opposite side's sub-tile width
(``plan_table_sharding``); padded rows are kept inert MASKLESSLY by an
invariant (``pad_state``): their ``k_rte``/``t_rte`` entries are 0, so
the rate update re-derives ``G_rte = k_shp/0 = +inf`` each iteration and
``Theta = shp/inf`` / ``exp(digamma(shp) - log(inf))`` are exactly +0.0
— every colsum stays clean with no per-iteration (n, k) mask traffic.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..models.state import Hyperparams, VariationalState
from ..ops.ell import (FAST_GATHER_BYTES, SPLIT_FANIN, EllBucket, build_ell,
                       reduce_split_tree)
from .mesh import DATA_AXIS


def plan_table_sharding(n_rows: int, k: int, ndev: int,
                        gather_itemsize: int = 4) -> Tuple[int, int, int, int]:
    """Plan one side's padded row layout as a gather TARGET.

    Returns ``(n_padded, per_dev, n_sub, chunk)``: rows are padded so that
    ``per_dev = n_sub * chunk`` exactly, where ``chunk`` rows of the
    exp table fit in ``FAST_GATHER_BYTES`` (ops/ell.py).  The
    uniform chunk grid then aligns with shard boundaries, so every
    column-tile of the opposite side's ELL packing maps to exactly one
    (shard, sub-tile) pair.
    """
    per0 = -(-n_rows // ndev)
    c0 = max(1, FAST_GATHER_BYTES // (k * gather_itemsize))
    n_sub = max(1, -(-per0 // c0))
    chunk = -(-per0 // n_sub)
    per = n_sub * chunk
    return per * ndev, per, n_sub, chunk


def plan_balanced_rows(deg: np.ndarray, n_padded: int, ndev: int) -> np.ndarray:
    """Degree-aware row->device assignment (row-granular snake).

    Contiguous partitioning puts catalog-head rows on device 0 under the
    usual id-by-popularity orderings, and the common bucket frame then pads
    every device to device 0's per-(sub-tile, width) segment counts
    (round-2 verdict weak #3).  Snaking degree-sorted rows over the devices
    gives each device a statistically identical degree profile; measured
    host-side at the MillionSong shape (38.7M nnz, 8 devices) the
    per-device frame drops 133.4M -> 46.3M slots (2.9x) and per-device
    nonzeros even out from [0.4, 32.7]M to [4.3, 6.7]M.  (Coarser
    block-granular assignments were measured WORSE than contiguous: they
    keep per-device width histograms dissimilar while fragmenting the
    opposite side's runs.)

    Returns ``perm`` (n_padded,) int64: the device ``p // per`` local slot
    ``p % per`` holds virtual row ``perm[p]`` (ids >= len(deg) would be
    padding, but the caller pads ``deg`` to ``n_padded`` with zeros, which
    sort to the tail and spread evenly).  Deterministic (stable sorts).
    """
    per = n_padded // ndev
    assert per * ndev == n_padded
    if len(deg) < n_padded:
        deg = np.concatenate([deg, np.zeros(n_padded - len(deg), deg.dtype)])
    order = np.argsort(-deg.astype(np.int64), kind="stable")
    c = np.arange(n_padded, dtype=np.int64) % (2 * ndev)
    d = np.where(c < ndev, c, 2 * ndev - 1 - c)
    # stable sort by device groups ranks per device in degree order; the
    # snake guarantees exactly ``per`` ranks per device (n_padded is a
    # multiple of ndev, so the remainder block is 0 or ndev wide)
    return order[np.argsort(d, kind="stable")]


def permute_csr(indptr, indices, data, perm, inv_opp=None):
    """Reorder CSR rows by ``perm`` (new row p = old row perm[p]),
    optionally renumbering column ids through ``inv_opp`` (the opposite
    side's old-id -> new-position map).  Returns (indptr, indices, data)."""
    d = np.diff(indptr)[perm]
    new_ip = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(d, out=new_ip[1:])
    try:
        from .. import _native

        vals, _, cols = _native.gather_rows(indptr, indices, data, perm)
    except Exception:
        total = int(new_ip[-1])
        src = (np.repeat(indptr[perm], d)
               + (np.arange(total, dtype=np.int64)
                  - np.repeat(new_ip[:-1], d)))
        cols, vals = indices[src], data[src]
    if inv_opp is not None:
        cols = inv_opp[cols].astype(np.int32)
    return new_ip, cols, vals


def prepare_table_sharded(indptr_u, ind_u, dat_u, indptr_i, ind_i, dat_i,
                          n_users, n_items, k, ndev, gather_itemsize,
                          dtype=np.float32, balance=None, **build_kw):
    """Plan + build both sides' sharded ELL layouts (the shared front half
    of the model-parallel engine, used by ``HPF._make_runner`` and
    ``bench.py``).

    ``balance`` (default: env ``HPFREC_TABLE_BALANCE`` != "0") applies
    the degree-aware row snake of :func:`plan_balanced_rows` to BOTH sides,
    renumbering each side's cols through the opposite permutation.

    Returns ``(se_u, se_i, plan_u, plan_i, perm_u, perm_i)`` where the
    perms are (n_padded,) virtual-row permutations (identity when
    balancing is off).  State tables must be permuted to match
    (:func:`permute_state`) and results inverse-permuted on the way out.
    """
    if balance is None:
        import os

        balance = os.environ.get("HPFREC_TABLE_BALANCE", "1") != "0"
    plan_u = plan_table_sharding(n_users, k, ndev, gather_itemsize)
    plan_i = plan_table_sharding(n_items, k, ndev, gather_itemsize)
    nU_p, nI_p = plan_u[0], plan_i[0]
    ip_u = np.concatenate([indptr_u,
                           np.full(nU_p - n_users, indptr_u[-1])])
    ip_i = np.concatenate([indptr_i,
                           np.full(nI_p - n_items, indptr_i[-1])])
    if balance and ndev > 1:
        perm_u = plan_balanced_rows(np.diff(ip_u), nU_p, ndev)
        perm_i = plan_balanced_rows(np.diff(ip_i), nI_p, ndev)
        inv_u = np.empty(nU_p, dtype=np.int64)
        inv_u[perm_u] = np.arange(nU_p)
        inv_i = np.empty(nI_p, dtype=np.int64)
        inv_i[perm_i] = np.arange(nI_p)
        ip_u, ind_u, dat_u = permute_csr(ip_u, ind_u, dat_u, perm_u, inv_i)
        ip_i, ind_i, dat_i = permute_csr(ip_i, ind_i, dat_i, perm_i, inv_u)
    else:
        perm_u = np.arange(nU_p, dtype=np.int64)
        perm_i = np.arange(nI_p, dtype=np.int64)
    se_u = build_sharded_ell(ip_u, ind_u, dat_u, nU_p, ndev,
                             opp_plan=(plan_i[0], plan_i[2], plan_i[3]),
                             dtype=dtype, **build_kw)
    se_i = build_sharded_ell(ip_i, ind_i, dat_i, nI_p, ndev,
                             opp_plan=(plan_u[0], plan_u[2], plan_u[3]),
                             dtype=dtype, **build_kw)
    return se_u, se_i, plan_u, plan_i, perm_u, perm_i


def permute_state(state: VariationalState, perm_u, perm_i):
    """Reorder a PADDED state's rows into the balanced layout (new row p =
    old row perm[p]); inverse with the inverse permutation."""
    import jax.numpy as jnp

    pu = jnp.asarray(perm_u)
    pi = jnp.asarray(perm_i)
    return VariationalState(
        G_shp=state.G_shp[pu], G_rte=state.G_rte[pu],
        L_shp=state.L_shp[pi], L_rte=state.L_rte[pi],
        k_rte=state.k_rte[pu], t_rte=state.t_rte[pi])


class ShardedEll(NamedTuple):
    """Per-device ELL layouts stacked on a leading device axis.

    Bucket arrays: rows (ndev, m_b) [LOCAL row ids], cols (ndev, m_b, w)
    [opposite-side ids, SHARD-SUB-TILE-LOCAL], vals (ndev, m_b, w);
    inv_perm (ndev, rows_per_dev); split info stacked likewise.

    ``bucket_meta[j] = (offset, lo, hi)``: bucket ``j``'s segments reference
    rows [lo, hi) of the opposite shard that arrives at ring step
    ``offset`` (static — drives the unrolled ring schedule).
    """

    buckets: list
    inv_perm: np.ndarray
    split_rows: np.ndarray
    split_seg_pos: tuple
    rows_per_dev: int
    bucket_meta: Tuple[Tuple[int, int, int], ...]
    per_opp: int


def build_sharded_ell(indptr, indices, data, n_rows_padded, ndev,
                      opp_plan: Tuple[int, int, int],
                      min_width=8, max_width=8192,
                      dtype=np.float32) -> ShardedEll:
    """Build one ELL layout per device over its contiguous row range, then
    stack them on a common (ring offset, sub-tile, width) bucket frame.

    ``opp_plan = (n_opp_padded, n_sub, chunk)`` describes the opposite
    side's padded layout (from :func:`plan_table_sharding`) — it must match
    the padding the opposite state tables actually get, since cols are
    stored local to the (shard, sub-tile) grid it defines.
    """
    assert n_rows_padded % ndev == 0
    per = n_rows_padded // ndev
    n_opp_padded, n_sub, chunk = opp_plan
    per_opp = n_sub * chunk
    assert n_opp_padded == per_opp * ndev

    layouts = []
    for d in range(ndev):
        lo, hi = d * per, (d + 1) * per
        # local CSR slice (row ids shifted to local)
        lptr = (indptr[lo:hi + 1] - indptr[lo]).astype(np.int64)
        lind = indices[indptr[lo]:indptr[hi]]
        ldat = data[indptr[lo]:indptr[hi]]
        layouts.append(build_ell(lptr, lind, ldat, per, min_width=min_width,
                                 max_width=max_width, dtype=dtype,
                                 col_chunk_rows=chunk, n_cols=n_opp_padded))

    # Re-key each device's buckets by (ring offset, sub-tile, width): the
    # absolute chunk index of a bucket's span maps to opposite shard
    # e = ac // n_sub and sub-tile c = ac % n_sub; the shard arrives at
    # ring step o = (d - e) % ndev.  The common frame is the union of keys
    # with per-key segment counts padded to the max over devices.
    def key_of(d, span, w):
        ac = span[0] // chunk
        e, c = ac // n_sub, ac % n_sub
        return ((d - e) % ndev, c, w)

    keys = sorted({key_of(d, l.col_spans[j], b.cols.shape[1])
                   for d, l in enumerate(layouts)
                   for j, b in enumerate(l.buckets)})
    m_of = {kk: 0 for kk in keys}
    for d, l in enumerate(layouts):
        for j, b in enumerate(l.buckets):
            kk = key_of(d, l.col_spans[j], b.cols.shape[1])
            m_of[kk] = max(m_of[kk], b.rows.shape[0])

    buckets = []
    meta = []
    offsets = {}
    pos = 0
    for kk in keys:
        o, c, w = kk
        m = m_of[kk]
        offsets[kk] = pos
        buckets.append(EllBucket(rows=np.zeros((ndev, m), dtype=np.int32),
                                 cols=np.zeros((ndev, m, w), dtype=np.int32),
                                 vals=np.zeros((ndev, m, w), dtype=dtype)))
        meta.append((o, c * chunk, (c + 1) * chunk))
        pos += m
    total_segs = pos

    inv_perm = np.zeros((ndev, per), dtype=np.int64)
    remaps = []
    for d, l in enumerate(layouts):
        # map this device's original segment positions -> common-frame
        # positions (build_ell's segment order is concat over ITS buckets)
        remap_chunks = []
        for j, b in enumerate(l.buckets):
            kk = key_of(d, l.col_spans[j], b.cols.shape[1])
            m_local = b.rows.shape[0]
            slot = keys.index(kk)
            tgt = buckets[slot]
            tgt.rows[d, :m_local] = b.rows
            tgt.cols[d, :m_local] = b.cols
            tgt.vals[d, :m_local] = b.vals
            remap_chunks.append(offsets[kk] + np.arange(m_local, dtype=np.int64))
        remap = np.concatenate(remap_chunks) if remap_chunks else np.zeros(0, np.int64)
        inv_perm[d] = remap[l.inv_perm]
        remaps.append(remap)
    split_rows, split_seg_pos = _stack_split_trees(layouts, remaps)
    return ShardedEll(buckets=buckets, inv_perm=inv_perm,
                      split_rows=split_rows, split_seg_pos=split_seg_pos,
                      rows_per_dev=per, bucket_meta=tuple(meta),
                      per_opp=per_opp)


def _stack_split_trees(layouts, remaps):
    """Stack the devices' split-row reduction trees on a common frame.

    Every device gets the same number of levels (a device whose tree is
    shallower repeats its last output through identity levels) and each
    level is padded to the longest device's row count with -1 rows, which
    reduce to zero.  Level 0 is remapped to common-frame segment
    positions.  Pad entries of ``split_rows`` point at row 0 with a zero
    sum, so every row still gets one fixed-order sum."""
    ndev = len(layouts)
    depth = max((len(l.split_seg_pos) for l in layouts), default=0)
    if depth == 0:
        return np.zeros((ndev, 0), np.int64), ()
    trees = []
    for l, remap in zip(layouts, remaps):
        lv = list(l.split_seg_pos)
        if lv:
            lv[0] = np.where(lv[0] >= 0, remap[np.clip(lv[0], 0, None)], -1)
        while len(lv) < depth:
            n = lv[-1].shape[0] if lv else 0
            ident = np.full((n, SPLIT_FANIN), -1, dtype=np.int64)
            ident[:, 0] = np.arange(n)
            lv.append(ident)
        trees.append(lv)
    levels = []
    for li in range(depth):
        n_l = max(max(t[li].shape[0] for t in trees), 1)
        mat = np.full((ndev, n_l, SPLIT_FANIN), -1, dtype=np.int64)
        for d, t in enumerate(trees):
            mat[d, :t[li].shape[0]] = t[li]
        levels.append(mat)
    split_rows = np.zeros((ndev, levels[-1].shape[1]), dtype=np.int64)
    for d, l in enumerate(layouts):
        split_rows[d, :l.split_rows.shape[0]] = l.split_rows
    return split_rows, tuple(levels)


def _ring_table_sums(t_self_loc, opp_shard, se: ShardedEll, ndev: int):
    """Per-local-row phi sums on one device (inside shard_map), streaming
    the opposite table's shards around a ``ppermute`` ring.  At step ``o``
    this device holds opposite shard ``(d - o) % ndev`` and reduces exactly
    the buckets whose ``bucket_meta`` offset is ``o``; shard sub-tiles are
    statically sliced into ``FAST_GATHER_BYTES`` chunks.
    The bucket arrays arrive with their leading device axis stripped."""
    import jax
    import jax.numpy as jnp

    from ..ops.ell import _bucket_phi_sums, _dep_stride

    _stride = _dep_stride(acc_dtype=t_self_loc.dtype)
    k = opp_shard.shape[1]
    per_opp = se.per_opp
    parts = [None] * len(se.buckets)
    buf = opp_shard
    deps = []
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    for o in range(ndev):
        slices = {}
        for j, b in enumerate(se.buckets):
            mo, lo, hi = se.bucket_meta[j]
            if mo != o:
                continue
            if (lo, hi) == (0, per_opp):
                tab = buf
            else:
                if (lo, hi) not in slices:
                    slices[(lo, hi)] = jax.lax.slice(buf, (lo, 0), (hi, k))
                tab = slices[(lo, hi)]
            out, deps = _bucket_phi_sums(t_self_loc, tab, b.rows, b.cols,
                                         b.vals, deps=deps,
                                         dep_stride=_stride)
            parts[j] = out
        if o < ndev - 1:
            buf = jax.lax.ppermute(buf, DATA_AXIS, perm)
    seg = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    out = seg[se.inv_perm]
    if se.split_seg_pos:
        # pad entries of split_rows add an exact zero to row 0
        extra = reduce_split_tree(seg, se.split_seg_pos)
        out = out.at[se.split_rows].add(extra, mode="promise_in_bounds")
    return out


def make_table_sharded_step(mesh, ell_u: ShardedEll, ell_i: ShardedEll,
                            hp: Hyperparams, n_users_real: int,
                            n_items_real: int, gather_dtype=None,
                            row_ids_u=None, row_ids_i=None):
    """Build a jitted ``(state_sharded, niter) -> state_sharded`` runner with
    user tables sharded P('d') by row and item tables likewise.

    The reference update order (``cython_loops.pxi:227-259``) is preserved;
    padded rows stay inert through the infinite-rate invariant (see
    ``pad_state``) with only the (n, 1) k_rte/t_rte updates masked.
    ``gather_dtype``
    (None | jnp.bfloat16) is the exchange/gather dtype of the per-iteration
    exp tables — bfloat16 halves both exchange volume and gather bytes;
    arithmetic promotes to float32 right after each gather (same contract
    as the data-parallel engine's ``gather_dtype``).

    ``row_ids_u`` / ``row_ids_i`` ((n_padded,) virtual-row id per table
    slot, i.e. the ``perm`` of :func:`plan_balanced_rows`) drive the
    pad-row masks; None means the contiguous identity layout.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.cavi import exp_elog_tables

    ndev = len(mesh.devices.ravel())
    per_u = ell_u.rows_per_dev
    per_i = ell_i.rows_per_dev

    def _cast(tab):
        return tab.astype(gather_dtype) if gather_dtype is not None else tab

    def carry_init(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte):
        # derive the loop-carried auxiliaries (exp tables + Beta colsum)
        # once per block; each iteration then produces the NEXT ones where
        # the side's shp/rte are updated, fusing with the Theta/Beta
        # divisions and reductions (same carried-tables restructure as
        # ops.ell.cavi_step_ell_carried — saves the 5 per-iteration table
        # passes the fori_loop carry blocked XLA from fusing)
        t_loc = _cast(exp_elog_tables(G_shp, G_rte))
        b_loc = _cast(exp_elog_tables(L_shp, L_rte))
        beta_colsum = jax.lax.psum(
            jnp.sum(L_shp / L_rte, axis=0, keepdims=True), DATA_AXIS)
        return (G_shp, G_rte, L_shp, L_rte, k_rte, t_rte,
                t_loc, b_loc, beta_colsum)

    def step_local(carry, umask, imask):
        # maskless pad-row handling: pad rows carry k_rte/t_rte = 0 (see
        # ``pad_state``), so their rates re-derive to +inf each iteration
        # and Theta/Beta/exp-tables are EXACTLY +0.0 there — every colsum
        # stays clean with no (n, k) mask traffic (measured at MillionSong
        # scale the masked variant paid ~7 extra elementwise passes over
        # the 204 MB user table per iteration).  Only the (n, 1)
        # k_rte/t_rte updates multiply by the row masks, re-zeroing the
        # pad rows to carry the invariant.
        (G_shp, G_rte, L_shp, L_rte, k_rte, t_rte,
         t_loc, b_loc, beta_colsum) = carry

        su = _ring_table_sums(t_loc, b_loc, ell_u_local[0], ndev)
        si = _ring_table_sums(b_loc, t_loc, ell_i_local[0], ndev)
        su = su.astype(G_shp.dtype)
        si = si.astype(L_shp.dtype)

        G_rte = hp.k_shp / k_rte + beta_colsum
        G_shp = hp.a + su
        Theta = G_shp / G_rte
        t_new = _cast(exp_elog_tables(G_shp, G_rte))
        theta_colsum = jax.lax.psum(jnp.sum(Theta, axis=0, keepdims=True), DATA_AXIS)
        L_rte = hp.t_shp / t_rte + theta_colsum
        L_shp = hp.c + si
        Beta = L_shp / L_rte
        b_new = _cast(exp_elog_tables(L_shp, L_rte))
        beta_colsum_new = jax.lax.psum(
            jnp.sum(Beta, axis=0, keepdims=True), DATA_AXIS)
        k_rte = (hp.add_k_rte + jnp.sum(Theta, axis=1, keepdims=True)) * umask
        t_rte = (hp.add_t_rte + jnp.sum(Beta, axis=1, keepdims=True)) * imask
        return (G_shp, G_rte, L_shp, L_rte, k_rte, t_rte,
                t_new, b_new, beta_colsum_new)

    nb_u = len(ell_u.buckets)
    nb_i = len(ell_i.buckets)
    ell_u_local = []
    ell_i_local = []

    nl_u = len(ell_u.split_seg_pos)
    nl_i = len(ell_i.split_seg_pos)

    def unflatten(flat, se, nb, nl, per):
        return ShardedEll(
            buckets=[EllBucket(*flat[3 * i: 3 * i + 3]) for i in range(nb)],
            inv_perm=flat[3 * nb], split_rows=flat[3 * nb + 1],
            split_seg_pos=tuple(flat[3 * nb + 2: 3 * nb + 2 + nl]),
            rows_per_dev=per, bucket_meta=se.bucket_meta, per_opp=se.per_opp)

    def runner_local(niter, G_shp, G_rte, L_shp, L_rte, k_rte, t_rte, *flat):
        # strip the (length-1) leading device axis shard_map leaves in place
        flat = tuple(a[0] for a in flat)
        n_fu = 3 * nb_u + 2 + nl_u
        se_u = unflatten(flat[:n_fu], ell_u, nb_u, nl_u, per_u)
        se_i = unflatten(flat[n_fu:-2], ell_i, nb_i, nl_i, per_i)
        rid_u, rid_i = flat[-2], flat[-1]
        ell_u_local.clear(); ell_u_local.append(se_u)
        ell_i_local.clear(); ell_i_local.append(se_i)

        umask = (rid_u[:, None] < n_users_real).astype(G_shp.dtype)
        imask = (rid_i[:, None] < n_items_real).astype(L_shp.dtype)

        def body(_, carry):
            return step_local(carry, umask, imask)

        carry = jax.lax.fori_loop(
            0, niter, body,
            carry_init(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte))
        return carry[:6]

    table_u = P(DATA_AXIS, None)

    def layout_specs(se):
        specs = []
        for _ in se.buckets:
            specs += [P(DATA_AXIS, None), P(DATA_AXIS, None, None),
                      P(DATA_AXIS, None, None)]
        specs += [P(DATA_AXIS, None), P(DATA_AXIS, None)]
        return specs + [P(DATA_AXIS, None, None)] * len(se.split_seg_pos)

    bucket_specs_u = layout_specs(ell_u)
    bucket_specs_i = layout_specs(ell_i)

    sharded = jax.shard_map(
        runner_local,
        mesh=mesh,
        in_specs=(P(), table_u, table_u, table_u, table_u, table_u, table_u,
                  *bucket_specs_u, *bucket_specs_i,
                  P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(table_u,) * 6,
        check_vma=False,
    )

    # pass the layout arrays as jit ARGUMENTS (closing over device arrays
    # embeds them as HLO constants — payload blow-up at large nnz); place
    # them pre-sharded so calls don't re-transfer
    from jax.sharding import NamedSharding

    def _put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(mesh, spec))

    flat_all = []
    for se in (ell_u, ell_i):
        for b in se.buckets:
            flat_all += [_put(b.rows, P(DATA_AXIS, None)),
                         _put(b.cols, P(DATA_AXIS, None, None)),
                         _put(b.vals, P(DATA_AXIS, None, None))]
        flat_all += [_put(se.inv_perm, P(DATA_AXIS, None)),
                     _put(se.split_rows, P(DATA_AXIS, None))]
        flat_all += [_put(lv, P(DATA_AXIS, None, None))
                     for lv in se.split_seg_pos]
    if row_ids_u is None:
        row_ids_u = np.arange(ndev * per_u, dtype=np.int64)
    if row_ids_i is None:
        row_ids_i = np.arange(ndev * per_i, dtype=np.int64)
    flat_all += [
        _put(np.asarray(row_ids_u, dtype=np.int32).reshape(ndev, per_u),
             P(DATA_AXIS, None)),
        _put(np.asarray(row_ids_i, dtype=np.int32).reshape(ndev, per_i),
             P(DATA_AXIS, None)),
    ]

    @jax.jit
    def _run(state: VariationalState, niter, *flat):
        out = sharded(niter, state.G_shp, state.G_rte, state.L_shp, state.L_rte,
                      state.k_rte, state.t_rte, *flat)
        return VariationalState(*out)

    def run(state: VariationalState, niter):
        return _run(state, niter, *flat_all)

    return run


def pad_state(state: VariationalState, n_users_padded, n_items_padded):
    """Grow the state tables to padded row counts, establishing the
    maskless pad-row invariant the step maintains: shapes pad with 1 and
    rates with +inf, so ``Theta = shp/rte`` and the E-step's
    ``exp(digamma(shp) - log(rte))`` are EXACTLY +0.0 on pad rows;
    ``k_rte``/``t_rte`` pad with 0, so the next ``k_shp / k_rte``
    re-derives the infinite rate.  Pad rows then stay inert through every
    colsum without any per-iteration (n, k) mask work (round-2 verdict
    weak #3 follow-up: the masked step spent ~7 elementwise passes over
    the 204 MB user table per iteration on masking alone).

    CONSUMER CONTRACT: after a step, pad rows hold nonzero engine-internal
    values (e.g. ``G_shp = a`` with ``G_rte = +inf``) — only the
    shp/rte-derived quantities are guaranteed zero there.  Never read a
    padded state's rows directly; slice to real rows first
    (``HPF._slice_state_real``).  See the ``VariationalState`` docstring."""
    import jax.numpy as jnp

    def pad_rows(a, n, fill):
        if a.shape[0] == n:
            return a
        extra = jnp.full((n - a.shape[0], a.shape[1]), fill, a.dtype)
        return jnp.concatenate([a, extra], axis=0)

    return VariationalState(
        G_shp=pad_rows(state.G_shp, n_users_padded, 1),
        G_rte=pad_rows(state.G_rte, n_users_padded, jnp.inf),
        L_shp=pad_rows(state.L_shp, n_items_padded, 1),
        L_rte=pad_rows(state.L_rte, n_items_padded, jnp.inf),
        k_rte=pad_rows(state.k_rte, n_users_padded, 0),
        t_rte=pad_rows(state.t_rte, n_items_padded, 0),
    )


def make_table_sharded_metric(mesh, ell_u: ShardedEll, full_llk: bool):
    """Train-metric partials for the table-sharded engine: each device
    reduces the llk pieces of its own users' nonzeros, streaming the Beta
    shards around the same ppermute ring as the training step, and a
    ``psum`` combines the per-op partials.  Returns a
    ``(Theta_sharded, Beta_sharded) -> (ll, se, sp)`` callable for
    ``ops.metrics.ell_train_llk_rmse`` — padded rows carry zero vals, so
    they are inert."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.metrics import ell_llk_parts

    ndev = len(mesh.devices.ravel())
    nb = len(ell_u.buckets)
    per_opp = ell_u.per_opp
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    def local(Theta_loc, Beta_loc, *flat):
        # strip the (length-1) leading device axis shard_map leaves in place
        flat = tuple(a[0] for a in flat)
        buckets = [EllBucket(*flat[3 * i: 3 * i + 3]) for i in range(nb)]
        ll_p, se_p, sp_p = [], [], []
        buf = Beta_loc
        dep = None
        for o in range(ndev):
            idx = [j for j in range(nb) if ell_u.bucket_meta[j][0] == o]
            if idx:
                spans = tuple((ell_u.bucket_meta[j][1], ell_u.bucket_meta[j][2])
                              for j in idx)
                ll, se, sp = ell_llk_parts(Theta_loc, buf,
                                           [buckets[j] for j in idx],
                                           spans, full_llk, dep=dep)
                dep = ll[-1]
                ll_p += ll; se_p += se; sp_p += sp
            if o < ndev - 1:
                buf = jax.lax.ppermute(buf, DATA_AXIS, perm)
        out = jnp.stack([jnp.stack(ll_p), jnp.stack(se_p), jnp.stack(sp_p)])
        return jax.lax.psum(out, DATA_AXIS)

    bucket_specs = []
    for _ in range(nb):
        bucket_specs += [P(DATA_AXIS, None), P(DATA_AXIS, None, None),
                         P(DATA_AXIS, None, None)]
    sharded = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), *bucket_specs),
        out_specs=P(),
        check_vma=False,
    ))

    def _put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(mesh, spec))

    flat = []
    for b in ell_u.buckets:
        flat += [_put(b.rows, P(DATA_AXIS, None)),
                 _put(b.cols, P(DATA_AXIS, None, None)),
                 _put(b.vals, P(DATA_AXIS, None, None))]

    def sums_fn(Theta, Beta):
        out = sharded(Theta, Beta, *flat)
        return out[0], out[1], out[2]

    return sums_fn
