"""Fused CAVI compute core (single-device; the sharded variant wraps these).

The reference implements the E-step as an explicit (nnz, k) ``phi`` matrix
(``cython_loops.pxi:551-592``) followed by serial-or-racy scatter-adds
(``:594-621``).  Here the two are fused: nonzeros are processed in fixed-size
blocks; each block does a (B, k) gather of per-row expectation tables, a
row-softmax scaled by the count, and two deterministic scatter-adds
(segment sums) into the user- and item-side accumulators.  ``phi`` never
exists at full (nnz, k) size, the scatter is deterministic by construction
(subsuming both the reference's `allow_inconsistent_math` variants), and the
log-sum-exp max-subtraction trick (`sum_exp_trick`, ``pxi:560-577``) is
always on because it is free inside the fused softmax.

Data layout: the COO triplet stream is padded and reshaped to
``(nblocks, B)`` host-side (see ``utils/data.py``); padding rows carry
``y == 0`` which makes their phi-rows exactly zero, so they are inert in
every segment sum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma

from ..models.state import Hyperparams, VariationalState


class BlockedCOO(NamedTuple):
    """Padded, blocked COO stream (user-sorted).  All (nblocks, B)."""

    y: jax.Array
    ix_u: jax.Array
    ix_i: jax.Array


def elog_tables(shp: jax.Array, rte: jax.Array) -> jax.Array:
    """E_q[log x] for a Gamma(shp, rte) posterior: digamma(shp) - log(rte).

    Computed once per iteration per table — O((nU+nI) k) — so the per-nonzero
    hot path is free of transcendentals.
    (Reference computes digamma/log per nonzero, ``pxi:570``.)
    """
    return digamma(shp) - jnp.log(rte)


def exp_elog_tables(shp: jax.Array, rte: jax.Array) -> jax.Array:
    """Row-stabilized exp of E[log x]: ``exp(elog - rowmax(elog))``.

    The phi softmax factorizes: softmax_k(elogt[u] + elogb[i]) =
    (t[u] * b[i]) / <t[u], b[i]> with t = exp(elogt), b = exp(elogb); the
    per-ROW max subtraction cancels exactly in the ratio.  So the E-step
    needs NO transcendentals per nonzero — only a multiply and a dot — and
    the reference's `sum_exp_trick` stabilization (``pxi:560-577``) is
    built in for free, and the per-nonzero exp/max/softmax chain is gone.
    """
    elog = digamma(shp) - jnp.log(rte)
    m = jnp.max(elog, axis=1, keepdims=True)
    # an all--inf row (a pad row under the table-sharded engine's
    # infinite-rate invariant) would make elog - m = NaN; zeroing the
    # non-finite rowmax keeps exp(-inf - 0) = +0.0 exactly.  Finite rows
    # are bit-unchanged, and the guard is one (n, 1) where.
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    return jnp.exp(elog - m)


def _phi_block(t_tab, b_tab, y, iu, ii):
    """phi for one block: phi_n = y_n * (t[u_n] * b[i_n]) / <t[u_n], b[i_n]>.

    ``t_tab``/``b_tab`` are the stabilized exp tables from
    :func:`exp_elog_tables`.  Zero-count (padding) rows give zero phi rows.
    """
    p = t_tab[iu] * b_tab[ii]
    denom = jnp.sum(p, axis=-1)
    return (y / denom)[:, None] * p


def _accumulate_block(carry, blk, *, elogt, elogb):
    su, si = carry
    y, iu, ii = blk
    phi = _phi_block(elogt, elogb, y, iu, ii)
    # ix_u is sorted within a block (global user-sort); ix_i is not.
    su = su.at[iu].add(phi, indices_are_sorted=True, mode="promise_in_bounds")
    si = si.at[ii].add(phi, mode="promise_in_bounds")
    return (su, si), None


def phi_segment_sums(
    elogt: jax.Array,
    elogb: jax.Array,
    data: BlockedCOO,
) -> tuple[jax.Array, jax.Array]:
    """Sum of phi rows per user and per item.

    Equivalent to the reference's ``update_phi`` + ``update_G_n_L_sh``
    (``pxi:551-621``) minus the prior constant, which the caller adds.
    Returns ``(sum_u phi, sum_i phi)`` with shapes (nU, k), (nI, k).
    """
    nU, k = elogt.shape
    nI = elogb.shape[0]
    dt = elogt.dtype
    su0 = jnp.zeros((nU, k), dt)
    si0 = jnp.zeros((nI, k), dt)
    body = functools.partial(_accumulate_block, elogt=elogt, elogb=elogb)
    if data.y.shape[0] == 1:
        (su, si), _ = body((su0, si0), (data.y[0], data.ix_u[0], data.ix_i[0]))
        return su, si
    (su, si), _ = jax.lax.scan(body, (su0, si0), (data.y, data.ix_u, data.ix_i))
    return su, si


def cavi_step(
    state: VariationalState,
    data: BlockedCOO,
    hp: Hyperparams,
    segment_sums_fn=phi_segment_sums,
) -> VariationalState:
    """One full-batch coordinate-ascent iteration.

    Update order matches the reference main loop exactly
    (``cython_loops.pxi:227-259``):

      1. phi from current (G_shp, G_rte, L_shp, L_rte)
      2. G_rte  <- k_shp/k_rte + colsum(Beta)          [old Beta, old k_rte]
      3. G_shp  <- a + segment_sum_u(phi)
      4. Theta  <- G_shp / G_rte
      5. L_rte  <- t_shp/t_rte + colsum(Theta)         [old t_rte, new Theta]
      6. L_shp  <- c + segment_sum_i(phi)
      7. Beta   <- L_shp / L_rte
      8. k_rte  <- a'/b' + rowsum(Theta)
      9. t_rte  <- c'/d' + rowsum(Beta)

    ``segment_sums_fn`` is pluggable so the sharded engine can substitute a
    shard_map+psum variant without duplicating the update algebra.
    """
    t_tab = exp_elog_tables(state.G_shp, state.G_rte)
    b_tab = exp_elog_tables(state.L_shp, state.L_rte)
    su, si = segment_sums_fn(t_tab, b_tab, data)

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


@functools.partial(jax.jit, static_argnames=("hp", "segment_sums_fn"), donate_argnums=(0,))
def run_cavi_block(
    state: VariationalState,
    data: BlockedCOO,
    niter: jax.Array,
    hp: Hyperparams,
    segment_sums_fn=phi_segment_sums,
) -> VariationalState:
    """Run ``niter`` CAVI iterations inside one XLA program.

    ``niter`` is a traced scalar so the same executable serves any
    ``check_every`` cadence; the state is donated so the six tables are
    updated in place in HBM.
    """

    def body(_, st):
        return cavi_step(st, data, hp, segment_sums_fn=segment_sums_fn)

    return jax.lax.fori_loop(0, niter, body, state)
