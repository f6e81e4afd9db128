"""Sharded execution engine: shard_map data-parallel segment sums.

Strategy (see SURVEY.md §2.3): the blocked nonzero stream ``(nblocks, B)``
is sharded along its leading axis over the mesh's ``'d'`` axis; the factor
tables and their E[log] lookup tables are replicated.  Each device scans its
local blocks, producing local (nU, k)/(nI, k) partial segment sums, which a
``psum`` over ``'d'`` combines into the replicated totals.  This is the
distributed analogue of the reference's racy OpenMP scatter-add
(``cython_loops.pxi:598-606``) but deterministic for a fixed mesh.

The per-iteration communication volume is 2*(nU + nI)*k floats over the
device interconnect (NVLink between GPUs of one host); the per-nonzero
compute stays entirely local.  Row-sharding the tables
with a ragged all-to-all is the planned follow-up for catalogs that do not
fit replicated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.cavi import BlockedCOO, phi_segment_sums
from .mesh import DATA_AXIS


def shard_blocked_data(data: BlockedCOO, mesh: Mesh) -> BlockedCOO:
    """Place the blocked COO stream with its leading (block) axis sharded
    over the mesh.  ``block_coo`` already padded nblocks to a multiple of the
    mesh size."""
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return BlockedCOO(
        y=jax.device_put(data.y, sharding),
        ix_u=jax.device_put(data.ix_u, sharding),
        ix_i=jax.device_put(data.ix_i, sharding),
    )


def shard_ell_layout(layout, mesh: Mesh):
    """Place an ELL layout with each bucket's segment (m) axis sharded over
    the mesh (build_ell must have been called with pad_shards=mesh size);
    the reassembly arrays stay replicated."""
    from ..ops.ell import EllBucket, EllLayout

    row_sh = NamedSharding(mesh, P(DATA_AXIS))
    mat_sh = NamedSharding(mesh, P(DATA_AXIS, None))
    rep = NamedSharding(mesh, P())
    return EllLayout(
        buckets=[
            EllBucket(
                rows=jax.device_put(b.rows, row_sh),
                cols=jax.device_put(b.cols, mat_sh),
                vals=jax.device_put(b.vals, mat_sh),
            )
            for b in layout.buckets
        ],
        inv_perm=jax.device_put(layout.inv_perm, rep),
        split_rows=jax.device_put(layout.split_rows, rep),
        split_seg_pos=tuple(jax.device_put(l, rep)
                            for l in layout.split_seg_pos),
        n_rows=layout.n_rows,
        col_spans=layout.col_spans,
    )


def make_sharded_ell_phi_sums(mesh: Mesh, n_buckets: int, col_spans=None):
    """Sharded counterpart of ``ops.ell.ell_phi_sums``: each device computes
    the phi sums of its segment shard (dense, scatter-free), per-bucket
    all_gathers rebuild the global segment vector (communication:
    ~(n_segments x k) floats), and reassembly runs replicated.

    ``col_spans`` (static, from the layout) keeps the column-tiled
    path inside the shard_map body."""
    from ..ops.ell import EllBucket, segment_table_sums

    def local_sums(t_self, t_other, *flat):
        from ..ops.ell import _bucket_phi_sums, _dep_stride

        _stride = _dep_stride(acc_dtype=t_self.dtype)

        buckets = [EllBucket(*flat[3 * i: 3 * i + 3]) for i in range(n_buckets)]
        k = t_other.shape[1]
        slices = {}
        parts = []
        deps = []  # chain buckets so temporaries are not all live at once
        for i, b in enumerate(buckets):
            span = col_spans[i] if col_spans is not None else None
            if span is None:
                tab = t_other
            else:
                if span not in slices:
                    slices[span] = jax.lax.slice(t_other, (span[0], 0),
                                                 (span[1], k))
                tab = slices[span]
            out, deps = _bucket_phi_sums(t_self, tab, b.rows, b.cols, b.vals,
                                         deps=deps, dep_stride=_stride)
            parts.append(jax.lax.all_gather(out, DATA_AXIS, axis=0, tiled=True))
        return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

    bucket_specs = []
    for _ in range(n_buckets):
        bucket_specs += [P(DATA_AXIS), P(DATA_AXIS, None), P(DATA_AXIS, None)]
    sharded = jax.shard_map(
        local_sums,
        mesh=mesh,
        in_specs=(P(), P(), *bucket_specs),
        out_specs=P(),
        check_vma=False,
    )

    def phi_sums_fn(t_self, t_other, layout):
        flat = []
        for b in layout.buckets:
            flat += [b.rows, b.cols, b.vals]
        seg = sharded(t_self, t_other, *flat)
        return segment_table_sums(seg, layout)

    return phi_sums_fn


def make_sharded_svi_phi_sums(mesh: Mesh):
    """Mesh-parallel phi segment sums for one SVI mini-batch: the batch's
    padded nonzero buffer is split evenly over ``'d'`` (the buffer capacity
    is rounded to a mesh-size multiple by the caller), each device
    segment-adds its slice's phi into full-size tables, and a ``psum``
    combines them.  Tables stay replicated — the per-batch communication is
    2*(nU + nI)*k floats, same as the full-batch engine.  Pass the
    result as ``phi_sums_fn`` to ``ops.svi.svi_run_batches``."""
    from ..ops.svi import phi_sums_tables

    def local(t_tab, b_tab, y, iu, ii):
        su, si = phi_sums_tables(t_tab, b_tab, y, iu, ii)
        return jax.lax.psum(su, DATA_AXIS), jax.lax.psum(si, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )


def make_sharded_segment_sums(mesh: Mesh):
    """Build a drop-in replacement for ``ops.cavi.phi_segment_sums`` that
    runs one shard_map over the mesh.  Suitable as the ``segment_sums_fn``
    argument of ``ops.cavi.cavi_step``."""

    def local_sums(elogt, elogb, y, iu, ii):
        su, si = phi_segment_sums(elogt, elogb, BlockedCOO(y, iu, ii))
        return jax.lax.psum(su, DATA_AXIS), jax.lax.psum(si, DATA_AXIS)

    sharded = jax.shard_map(
        local_sums,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )

    def segment_sums_fn(elogt, elogb, data: BlockedCOO):
        return sharded(elogt, elogb, data.y, data.ix_u, data.ix_i)

    return segment_sums_fn


def make_sharded_ell_metric(mesh: Mesh, layout, full_llk: bool):
    """Sharded counterpart of ``ops.metrics.ell_llk_rmse_sums`` for the
    data-parallel engine: each device reduces the llk pieces over its
    bucket-segment shard (tables replicated, spans keep the tiled
    path), and a ``psum`` combines the per-op partials.
    Returns a ``(Theta, Beta) -> (ll, se, sp)`` callable suitable as the
    ``sums_fn`` of ``ops.metrics.ell_train_llk_rmse``, so multi-chip
    convergence checks no longer fall back to the blocked-COO path."""
    from ..ops.ell import EllBucket
    from ..ops.metrics import ell_llk_parts

    n_buckets = len(layout.buckets)
    col_spans = layout.col_spans

    def local(Theta, Beta, *flat):
        buckets = [EllBucket(*flat[3 * i: 3 * i + 3]) for i in range(n_buckets)]
        ll_p, se_p, sp_p = ell_llk_parts(Theta, Beta, buckets, col_spans,
                                         full_llk)
        out = jnp.stack([jnp.stack(ll_p), jnp.stack(se_p), jnp.stack(sp_p)])
        return jax.lax.psum(out, DATA_AXIS)

    bucket_specs = []
    for _ in range(n_buckets):
        bucket_specs += [P(DATA_AXIS), P(DATA_AXIS, None), P(DATA_AXIS, None)]
    sharded = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), *bucket_specs),
        out_specs=P(),
        check_vma=False,
    ))

    flat = []
    for b in layout.buckets:  # already device-resident, pre-sharded
        flat += [b.rows, b.cols, b.vals]

    def sums_fn(Theta, Beta):
        out = sharded(Theta, Beta, *flat)
        return out[0], out[1], out[2]

    return sums_fn
