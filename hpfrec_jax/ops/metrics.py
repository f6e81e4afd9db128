"""Likelihood / error metrics and pairwise prediction kernels.

Mirrors the reference's ``llk_plus_rmse`` / ``sum_prediction`` /
``predict_multiple`` native kernels (``cython_loops.pxi:627-660, 799-825``)
as fused gather-dot reductions.  The reference accumulates in ``long
double``; here partial sums are computed per block in the compute dtype and
combined in float64 on host (one scalar per block), which bounds the
accumulation error the same way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from . import PRECISION
from .cavi import BlockedCOO


@functools.partial(jax.jit, static_argnames=("full_llk",))
def llk_rmse_sums(Theta, Beta, data: BlockedCOO, full_llk: bool = False):
    """Per-block partial sums of the Poisson log-likelihood pieces.

    Returns (nblocks,) float32 arrays: ``ll`` = sum y*log(yhat)
    [- lgamma(y+1) if full_llk], ``se`` = sum (y - yhat)^2, and
    ``sp`` = sum yhat, all over real (non-padding) rows only.  The caller
    combines them per the stopping criterion:

      train llk (reference ``pxi:78``):  sum(ll) - colsum(Theta).colsum(Beta)
      val   llk (reference ``pxi:72``):  sum(ll) - sum(sp)
      rmse: sqrt(sum(se) / nnz)
    """

    def block(_, blk):
        y, iu, ii = blk
        yhat = jnp.sum(Theta[iu] * Beta[ii], axis=-1)
        mask = y > 0
        safe = jnp.where(yhat > 0, yhat, 1.0)
        ll = y * jnp.log(safe)
        if full_llk:
            ll = ll - gammaln(y + 1.0)
        ll = jnp.where(mask, ll, 0.0)
        se = jnp.where(mask, (y - yhat) ** 2, 0.0)
        sp = jnp.where(mask, yhat, 0.0)
        return None, (jnp.sum(ll), jnp.sum(se), jnp.sum(sp))

    _, (ll, se, sp) = jax.lax.scan(block, None, (data.y, data.ix_u, data.ix_i))
    return ll, se, sp


def train_llk_rmse(Theta, Beta, data: BlockedCOO, nnz: int, full_llk: bool = False):
    """Full-batch training criterion: exact all-pairs rate sum via the
    factorization identity colsum(Theta).colsum(Beta) (reference ``pxi:78``).
    Returns host floats (llk, rmse)."""
    ll, se, _ = llk_rmse_sums(Theta, Beta, data, full_llk=full_llk)
    correction = _colsum_dot(Theta, Beta)
    import numpy as np

    llk = float(np.asarray(ll, dtype=np.float64).sum()) - float(correction)
    rmse = float(np.sqrt(np.asarray(se, dtype=np.float64).sum() / nnz))
    return llk, rmse


def val_llk_rmse(Theta, Beta, data: BlockedCOO, nnz: int, full_llk: bool = False):
    """Validation criterion: subtract only the predictions of the observed
    pairs (reference ``pxi:72``)."""
    ll, se, sp = llk_rmse_sums(Theta, Beta, data, full_llk=full_llk)
    import numpy as np

    llk = float(np.asarray(ll, dtype=np.float64).sum()) - float(
        np.asarray(sp, dtype=np.float64).sum()
    )
    rmse = float(np.sqrt(np.asarray(se, dtype=np.float64).sum() / nnz))
    return llk, rmse


def ell_llk_parts(Theta, Beta, buckets, col_spans, full_llk: bool,
                  dep=None):
    """Per-fused-op partial sums of the llk pieces over ELL buckets.

    The common body behind the single-device jit wrapper and the sharded
    engines' shard_map local functions (``Beta`` may be a ring shard there;
    ``col_spans`` then carries spans into that shard).  Bucket padding
    slots carry ``vals == 0`` and in-bounds indices, so they are masked
    exactly like the blocked-COO path's padding.  Returns three lists of
    scalar partials (combined in float64 on host by the callers, which
    bounds accumulation error like the reference's long-double
    accumulators)."""
    from .ell import TARGET_SLOTS

    acc_dt = (jnp.float32 if Theta.dtype in (jnp.bfloat16, jnp.float32)
              else Theta.dtype)
    ll_p, se_p, sp_p = [], [], []
    k = Beta.shape[1]
    slices = {}
    for j, b in enumerate(buckets):
        span = col_spans[j] if col_spans is not None else None
        if span is None or span == (0, Beta.shape[0]):
            tab = Beta
        else:
            if span not in slices:
                slices[span] = jax.lax.slice(Beta, (span[0], 0), (span[1], k))
            tab = slices[span]
        m, w = b.cols.shape
        c = max(1, TARGET_SLOTS // w) if m * w > TARGET_SLOTS else m
        for st in range(0, m, c):
            rows_c = b.rows[st:st + c]
            if dep is not None:
                rows_c, dep = jax.lax.optimization_barrier((rows_c, dep))
            y = b.vals[st:st + c]
            yhat = jnp.einsum("ck,cwk->cw", Theta[rows_c],
                              tab[b.cols[st:st + c]],
                              preferred_element_type=acc_dt,
                              precision=PRECISION)
            mask = y > 0
            safe = jnp.where(yhat > 0, yhat, 1.0)
            ll = y * jnp.log(safe)
            if full_llk:
                ll = ll - gammaln(y + 1.0)
            ll_s = jnp.sum(jnp.where(mask, ll, 0.0))
            se_s = jnp.sum(jnp.where(mask, (y - yhat) ** 2, 0.0))
            sp_s = jnp.sum(jnp.where(mask, yhat, 0.0))
            dep = ll_s
            ll_p.append(ll_s)
            se_p.append(se_s)
            sp_p.append(sp_s)
    return ll_p, se_p, sp_p


@functools.partial(jax.jit, static_argnames=("full_llk",))
def ell_llk_rmse_sums(Theta, Beta, layout, full_llk: bool = False):
    """Per-op partial sums of the llk pieces over a (possibly column-tiled)
    user-side ELL layout — same contract as :func:`llk_rmse_sums`, reusing
    the E-step's layout (and its column tiles, when tiled) instead of a
    separate blocked-COO copy of the data.  Returns stacked (n_ops,)
    partials."""
    ll_p, se_p, sp_p = ell_llk_parts(Theta, Beta, layout.buckets,
                                     layout.col_spans, full_llk)
    return jnp.stack(ll_p), jnp.stack(se_p), jnp.stack(sp_p)


def ell_train_llk_rmse(Theta, Beta, layout, nnz: int, full_llk: bool = False,
                       sums_fn=None):
    """Training criterion over the ELL layout (exact all-pairs correction
    via colsum(Theta).colsum(Beta), reference ``pxi:78``).  ``sums_fn``
    (a ``(Theta, Beta) -> (ll, se, sp)`` callable, full_llk baked in) lets
    the sharded engines substitute their shard_map metric — the layout
    argument is then unused."""
    import numpy as np

    if sums_fn is not None:
        ll, se, _ = sums_fn(Theta, Beta)
    else:
        ll, se, _ = ell_llk_rmse_sums(Theta, Beta, layout, full_llk=full_llk)
    llk = float(np.asarray(ll, dtype=np.float64).sum()) - float(
        _colsum_dot(Theta, Beta))
    rmse = float(np.sqrt(np.asarray(se, dtype=np.float64).sum() / nnz))
    return llk, rmse


@jax.jit
def _colsum_dot(Theta, Beta):
    return jnp.dot(
        jnp.sum(Theta, axis=0), jnp.sum(Beta, axis=0),
        preferred_element_type=jnp.float32, precision=PRECISION)


@jax.jit
def rowsum_dot_rows(Theta, Beta, iu, ii):
    """colsum(Theta[iu]) . colsum(Beta[ii]) — the (rows counted with
    multiplicity) correction used by ``eval_after_term`` on a validation set
    (reference ``pxi:105``).  Kept for behavioral parity."""
    return jnp.dot(
        jnp.sum(Theta[iu], axis=0),
        jnp.sum(Beta[ii], axis=0),
        preferred_element_type=jnp.float32,
        precision=PRECISION,
    )


@jax.jit
def predict_pairs(Theta, Beta, iu, ii):
    """Batched yhat_j = Theta[u_j] . Beta[i_j] (reference ``predict_multiple``,
    ``pxi:803-810``)."""
    return jnp.sum(Theta[iu] * Beta[ii], axis=-1)


@jax.jit
def sum_pairs_prediction(Theta, Beta, iu, ii):
    """Reference ``sum_prediction`` (``pxi:816-825``)."""
    return jnp.sum(jnp.sum(Theta[iu] * Beta[ii], axis=-1))


@jax.jit
def theta_diff_norm(Theta, Theta_prev):
    """Frobenius norm of the Theta delta for the diff-norm stopping criterion
    (reference ``pxi:59``)."""
    d = Theta - Theta_prev
    return jnp.sqrt(jnp.sum(d * d))
