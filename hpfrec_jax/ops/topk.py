"""Serving-side ranking kernels.

The reference serves one user at a time with a host BLAS gemv +
argpartition (``hpfrec/__init__.py:1337-1356``, measured 45.8 ms/user on
its 24-core box for a 376K-item catalog).  Here a whole batch of users is
scored as one (b, k) x (k, nI) matmul and ``lax.top_k`` runs on device.

Seen-item exclusion is done ON DEVICE by scattering ``-inf`` into the
score matrix at the batch's (row, seen-item) pairs and taking a plain
``top_k(n)`` — the previous oversample-by-max-seen + host setdiff
approach made ``top_k``'s k explode when any user in the batch had a
large history.  Shapes are bucketed to powers of two so the jit cache
stays bounded.
"""

from __future__ import annotations

import functools

import numpy as np


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


@functools.lru_cache(maxsize=1)
def _kernels():
    import jax
    import jax.numpy as jnp

    from . import PRECISION

    @functools.partial(jax.jit, static_argnames=("n",))
    def plain(Theta_rows, Beta, n: int):
        scores = jnp.dot(Theta_rows, Beta.T, preferred_element_type=jnp.float32,
                         precision=PRECISION)
        return jax.lax.top_k(scores, n)

    @functools.partial(jax.jit, static_argnames=("n",))
    def masked(Theta_rows, Beta, mask_rows, mask_items, n: int):
        scores = jnp.dot(Theta_rows, Beta.T, preferred_element_type=jnp.float32,
                         precision=PRECISION)
        # out-of-bounds pairs (padding uses item == nI) are dropped
        scores = scores.at[mask_rows, mask_items].set(-jnp.inf, mode="drop")
        return jax.lax.top_k(scores, n)

    return plain, masked


def topn_batch(Theta, Beta, users, n, seen_indptr=None, seen_indices=None,
               n_seen=None):
    """Top-n item rows for each user row in ``users``.

    With seen-lists given (CSR start offsets + per-user counts, the
    reference's ``_st_ix_user``/``seen``/``_n_seen_by_user`` metadata),
    those items are masked out on device before ranking — same exclusion
    semantics as reference ``topN``.  Returns (len(users), n) int array of
    item rows.
    """
    import jax.numpy as jnp

    plain, masked = _kernels()
    users = np.asarray(users, dtype=np.int64)
    b = len(users)
    nI = Beta.shape[0]
    k_eff = min(n, nI)

    if seen_indptr is None:
        _, idx = plain(jnp.asarray(Theta[users]), jnp.asarray(Beta), n=k_eff)
        return np.asarray(idx)

    # ragged gather of the batch's seen items (host, vectorized)
    starts = np.asarray(seen_indptr)[users]
    counts = np.asarray(n_seen)[users].astype(np.int64)
    total = int(counts.sum())
    rows = np.repeat(np.arange(b, dtype=np.int32), counts)
    gx = (np.repeat(starts - (np.cumsum(counts) - counts), counts)
          + np.arange(total, dtype=np.int64))
    items = np.asarray(seen_indices)[gx].astype(np.int32)

    # pad the pair list and the user batch to pow2 buckets (padding pairs
    # use item == nI -> dropped by the scatter; padding users are sliced
    # off the result)
    t_pad = _next_pow2(max(total, 1))
    rows_p = np.zeros(t_pad, dtype=np.int32)
    items_p = np.full(t_pad, nI, dtype=np.int32)
    rows_p[:total] = rows
    items_p[:total] = items
    b_pad = _next_pow2(b)
    users_p = np.zeros(b_pad, dtype=np.int64)
    users_p[:b] = users

    vals, idx = masked(jnp.asarray(Theta[users_p]), jnp.asarray(Beta),
                       jnp.asarray(rows_p), jnp.asarray(items_p), n=k_eff)
    idx = np.array(idx[:b])  # writable host copy (backfill mutates rows)
    vals = np.asarray(vals[:b])

    # pathological case: a user saw nearly the whole catalog and fewer
    # than n items remain -> -inf slots.  Backfill first with any other
    # unseen items, then (when the unseen set itself is smaller than n,
    # where the reference's topN simply returns fewer rows) with the
    # user's best-scoring seen items so the output stays rectangular.
    bad = ~np.isfinite(vals)
    if bad.any():
        for j in np.flatnonzero(bad.any(axis=1)):
            seen = np.asarray(seen_indices)[starts[j]:starts[j] + counts[j]]
            good = idx[j][np.isfinite(vals[j])]
            rest = np.setdiff1d(np.arange(nI), np.concatenate([seen, good]))
            fill = np.concatenate([good, rest])
            if fill.shape[0] < k_eff:
                # score only THIS user's seen items — (n_seen_j,) work.  An
                # earlier version scored the whole batch against the whole
                # catalog here ((b, nI) — ~6 GB at b=4096 x 377K items), so
                # one pathological user made every batch member pay.
                # Index BEFORE np.asarray: Beta may be a device-resident
                # array (HPF._beta_device) and converting it whole would
                # pull the full table to host.
                s_seen = np.asarray(Theta[users[j]]) @ np.asarray(Beta[seen]).T
                order = seen[np.argsort(-s_seen, kind="stable")]
                fill = np.concatenate([fill, order])
            idx[j] = fill[:k_eff]
    return idx
