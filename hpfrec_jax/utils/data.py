"""Host-side data layer: ingestion, reindexing, blocking, CSR metadata.

Mirrors the behavior of the reference's private data methods
(``hpfrec/__init__.py:434-633``): triplet coercion from DataFrame / ndarray /
scipy COO, the stop_crit-dependent zero/low-count filter, ``pd.factorize``
reindexing with saved mappings, dtype casts, and the CSR seen-items
metadata used by ``topN(exclude_seen=True)`` and SVI batching.

On top of that, this module owns the device layout step: padding the COO
stream to a rectangular ``(nblocks, B)`` layout (padding rows have
``y == 0`` and in-bounds indices, making them inert in every kernel).

Where available, the native C++ helpers in ``hpfrec_jax._native`` are used
for the O(nnz) host passes (sort/CSR build/batch gather); numpy is the
always-present fallback.  pandas is never imported here: DataFrame inputs
are recognized only when the caller has pandas loaded, so ndarray and
scipy-COO inputs run without it.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import NamedTuple, Optional

import numpy as np


class ProcessedData(NamedTuple):
    """Flat, filtered, reindexed COO triplets (host numpy, user-sorted
    whenever ``sorted_by_user``)."""

    y: np.ndarray  # (nnz,) real dtype
    ix_u: np.ndarray  # (nnz,) int32
    ix_i: np.ndarray  # (nnz,) int32
    nusers: int
    nitems: int
    user_mapping: Optional[np.ndarray]
    item_mapping: Optional[np.ndarray]
    sorted_by_user: bool


class BlockedHost(NamedTuple):
    """Blocked (nblocks, B) numpy layout ready for device placement."""

    y: np.ndarray
    ix_u: np.ndarray
    ix_i: np.ndarray
    nnz: int  # number of real (non-padding) entries


def is_dataframe(x) -> bool:
    """True for a pandas DataFrame, without importing pandas (a DataFrame
    can only exist once its caller has loaded pandas)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(x, pd.DataFrame)


def coerce_triplets(input_df, copy: bool = True):
    """Accept a pandas DataFrame with UserId/ItemId/Count columns, an
    (n, >=3) ndarray, or a scipy COO array (reference
    ``hpfrec/__init__.py:437-460``).  Returns (u, i, y, nusers, nitems,
    forced_no_reindex); nusers/nitems are None unless the input dictates them.
    """
    from scipy.sparse import issparse

    if isinstance(input_df, np.ndarray):
        assert len(input_df.shape) > 1
        assert input_df.shape[1] >= 3
        u = np.asarray(input_df[:, 0])
        i = np.asarray(input_df[:, 1])
        y = np.asarray(input_df[:, 2])
        return u, i, y, None, None, False
    if is_dataframe(input_df):
        assert input_df.shape[0] > 0
        for col in ("UserId", "ItemId", "Count"):
            assert col in input_df.columns, f"'{col}' column missing"
        u = input_df["UserId"].to_numpy()
        i = input_df["ItemId"].to_numpy()
        y = input_df["Count"].to_numpy()
        return u, i, y, None, None, False
    if issparse(input_df) and (input_df.format == "coo"):
        nusers, nitems = input_df.shape
        return (
            np.asarray(input_df.row),
            np.asarray(input_df.col),
            np.asarray(input_df.data),
            int(nusers),
            int(nitems),
            True,
        )
    raise ValueError(
        "'input_df' must be a pandas data frame, numpy array, or scipy sparse coo_array."
    )


def filter_low_counts(u, i, y, stop_crit: str, what: str = "counts_df"):
    """Drop observations with Count <= thr; thr is 0 for maxiter/diff-norm and
    0.9 for likelihood criteria (reference ``hpfrec/__init__.py:462-475``)."""
    thr = 0 if stop_crit in ("maxiter", "diff-norm") else 0.9
    low = y <= thr
    n_low = int(low.sum())
    if n_low > 0:
        warnings.warn(
            f"'{what}' contains observations with a count value less than 1, "
            "these will be ignored."
        )
        keep = ~low
        u, i, y = u[keep], i[keep], y[keep]
    return u, i, y


def _factorize(values):
    """First-occurrence-order factorize (``pd.factorize`` semantics).

    pandas' hash-based factorize is the fastest (about 18x a
    ``std::unordered_map`` C++ version at 20M rows, host CPU), so it is
    used when the caller already loaded pandas; otherwise integer ids go
    through the native ``factorize_i64`` and anything else through a
    sort-based numpy version."""
    values = np.asarray(values)
    pd = sys.modules.get("pandas")
    if pd is not None:
        return pd.factorize(values)
    if values.dtype.kind in "iu":
        try:
            from .._native import factorize_i64

            codes, uniques = factorize_i64(values.astype(np.int64, copy=False))
            return codes, uniques.astype(values.dtype, copy=False)
        except RuntimeError:  # native library unavailable
            pass
    uniq, first, inv = np.unique(values, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], uniq[order]


def reindex_ids(u, i):
    """Factorize-based reindex (reference ``hpfrec/__init__.py:477-483``).
    Returns (codes_u, codes_i, user_mapping, item_mapping)."""
    codes_u, user_mapping = _factorize(u)
    codes_i, item_mapping = _factorize(i)
    user_mapping = np.require(user_mapping, requirements=["ENSUREARRAY"]).reshape(-1)
    item_mapping = np.require(item_mapping, requirements=["ENSUREARRAY"]).reshape(-1)
    return (
        codes_u.astype(np.int32, copy=False),
        codes_i.astype(np.int32, copy=False),
        user_mapping,
        item_mapping,
    )


def map_to_training_ids(values, mapping):
    """Map raw IDs to training row indices; unknown -> -1 (the reference's
    ``pd.Categorical(values, mapping).codes``,
    ``hpfrec/__init__.py:561-562``).  Numeric ids are found by binary
    search over the sorted mapping, any other ids by hashing."""
    mapping = np.asarray(mapping)
    values = np.asarray(values)
    if mapping.dtype.kind not in "iuf" or values.dtype.kind not in "iuf":
        index = {v: r for r, v in enumerate(mapping.tolist())}
        return np.fromiter((index.get(v, -1) for v in values.tolist()),
                           dtype=np.int64, count=values.shape[0])
    if mapping.shape[0] == 0:
        return np.full(values.shape[0], -1, dtype=np.int64)
    sorter = np.argsort(mapping, kind="stable")
    pos = np.searchsorted(mapping, values, sorter=sorter)
    hit = sorter[np.minimum(pos, mapping.shape[0] - 1)]
    return np.where(mapping[hit] == values, hit, -1).astype(np.int64)


def process_data(
    input_df,
    stop_crit: str,
    reindex: bool,
    dtype=np.float32,
    sort_by_user: bool = True,
) -> ProcessedData:
    """Full training-data pipeline (reference ``_process_data``,
    ``hpfrec/__init__.py:434-523``)."""
    u, i, y, nusers, nitems, forced_no_reindex = coerce_triplets(input_df)
    if forced_no_reindex:
        reindex = False
    u, i, y = filter_low_counts(u, i, y, stop_crit)
    if y.shape[0] == 0:
        raise ValueError("Input data has no valid observations.")

    user_mapping = item_mapping = None
    if reindex:
        ix_u, ix_i, user_mapping, item_mapping = reindex_ids(u, i)
        nusers = int(user_mapping.shape[0])
        nitems = int(item_mapping.shape[0])
    else:
        ix_u = np.asarray(u).astype(np.int64, copy=False)
        ix_i = np.asarray(i).astype(np.int64, copy=False)
        if ix_u.shape[0] and (ix_u.min() < 0 or ix_i.min() < 0):
            raise ValueError("With reindex=False, all IDs must be non-negative integers.")
        if nusers is None:
            nusers = int(ix_u.max()) + 1
        if nitems is None:
            nitems = int(ix_i.max()) + 1

    ix_u = ix_u.astype(np.int32, copy=False)
    ix_i = ix_i.astype(np.int32, copy=False)
    y = np.require(y, dtype=dtype, requirements=["C_CONTIGUOUS"])

    sorted_flag = False
    if sort_by_user:
        try:
            # O(nnz) counting sort through the native CSR builder
            from .._native import coo_to_csr

            indptr, ix_i, y = coo_to_csr(ix_u, ix_i, y, nusers)
            ix_u = np.repeat(
                np.arange(nusers, dtype=np.int32), np.diff(indptr).astype(np.int64))
        except Exception:
            order = np.argsort(ix_u, kind="stable")
            ix_u = np.ascontiguousarray(ix_u[order])
            ix_i = np.ascontiguousarray(ix_i[order])
            y = np.ascontiguousarray(y[order])
        sorted_flag = True

    return ProcessedData(
        y=y,
        ix_u=ix_u,
        ix_i=ix_i,
        nusers=nusers,
        nitems=nitems,
        user_mapping=user_mapping,
        item_mapping=item_mapping,
        sorted_by_user=sorted_flag,
    )


def process_valset(
    val_set,
    stop_crit: str,
    reindex: bool,
    user_mapping,
    item_mapping,
    nusers: int,
    nitems: int,
    dtype=np.float32,
    is_valset: bool = True,
):
    """Validation / eval-set pipeline (reference ``_process_valset``,
    ``hpfrec/__init__.py:525-585``).  Returns (y, ix_u, ix_i) or None when a
    validation set ends up empty (with the criterion-switch warning)."""
    from scipy.sparse import issparse

    if isinstance(val_set, np.ndarray):
        assert len(val_set.shape) > 1
        assert val_set.shape[1] >= 3
        u, i, y = val_set[:, 0], val_set[:, 1], val_set[:, 2]
    elif is_dataframe(val_set):
        assert val_set.shape[0] > 0
        for col in ("UserId", "ItemId", "Count"):
            assert col in val_set.columns
        u = val_set["UserId"].to_numpy()
        i = val_set["ItemId"].to_numpy()
        y = val_set["Count"].to_numpy()
    elif issparse(val_set) and (val_set.format == "coo"):
        assert val_set.shape[0] <= nusers
        assert val_set.shape[1] <= nitems
        u, i, y = val_set.row, val_set.col, val_set.data
    else:
        raise ValueError(
            "'val_set' must be a pandas data frame, numpy array, or sparse coo_array."
        )

    thr = 0 if stop_crit == "val-llk" else 0.9
    low = np.asarray(y) <= thr
    if low.sum() > 0:
        warnings.warn(
            "'val_set' contains observations with a count value less than 1, these will be ignored."
        )
        keep = ~low
        u, i, y = np.asarray(u)[keep], np.asarray(i)[keep], np.asarray(y)[keep]

    if reindex:
        cu = map_to_training_ids(u, user_mapping)
        ci = map_to_training_ids(i, item_mapping)
        keep = (cu != -1) & (ci != -1)
        cu, ci, y = cu[keep], ci[keep], np.asarray(y)[keep]
        if cu.shape[0] == 0:
            if is_valset:
                warnings.warn(
                    "Validation set has no combinations of users and items in common "
                    "with training set. If 'stop_crit' was set to 'val-llk', will now "
                    "be switched to 'train-llk'."
                )
                return None
            raise ValueError(
                "'input_df' has no combinations of users and items in common with the training set."
            )
    else:
        cu = np.asarray(u).astype(np.int64, copy=False)
        ci = np.asarray(i).astype(np.int64, copy=False)

    return (
        np.require(y, dtype=dtype, requirements=["C_CONTIGUOUS"]),
        cu.astype(np.int32, copy=False),
        ci.astype(np.int32, copy=False),
    )


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def block_coo(
    y: np.ndarray,
    ix_u: np.ndarray,
    ix_i: np.ndarray,
    block_size: Optional[int] = None,
    n_shards: int = 1,
    min_align: int = 8,
) -> BlockedHost:
    """Pad the COO stream and reshape to (nblocks, B).

    Padding rows have y=0 (inert in segment sums and masked metrics) and
    index 0 (in-bounds).  ``nblocks`` is a multiple of ``n_shards`` so the
    leading axis can be sharded evenly over a device mesh.
    """
    nnz = int(y.shape[0])
    if block_size is None:
        # One block when small; cap block size so per-block temporaries
        # ((B, k) gathers/softmax) stay comfortably in HBM/VMEM budgets.
        block_size = min(_next_multiple(nnz, min_align), 1 << 18)
    B = int(block_size)
    nblocks = max(1, -(-nnz // B))
    nblocks = _next_multiple(nblocks, n_shards)
    total = nblocks * B
    pad = total - nnz

    def _pad(a, fill):
        out = np.empty(total, dtype=a.dtype)
        out[:nnz] = a
        out[nnz:] = fill
        return out.reshape(nblocks, B)

    return BlockedHost(
        y=_pad(y, 0),
        ix_u=_pad(ix_u, 0),
        ix_i=_pad(ix_i, 0),
        nnz=nnz,
    )


def build_csr(ix_u: np.ndarray, ix_i: np.ndarray, y: np.ndarray, nusers: int, nitems: int):
    """CSR over the training triplets: (indptr (nU+1,), indices, data).

    Replaces the reference's scipy-based ``_store_metadata``
    (``hpfrec/__init__.py:587-606``); uses the native C++ builder when
    available, scipy otherwise.
    """
    try:
        from .._native import coo_to_csr  # noqa: PLC0415

        return coo_to_csr(ix_u, ix_i, y, nusers)
    except Exception:
        from scipy.sparse import coo_array

        X = coo_array((y, (ix_u, ix_i)), shape=(nusers, nitems)).tocsr()
        return (
            X.indptr.astype(np.int64, copy=False),
            X.indices.astype(np.int32, copy=False),
            X.data,
        )


def gather_batch_nonzeros(indptr, indices, data, rows: np.ndarray):
    """Concatenate the CSR slices of ``rows``: returns (y, ix_row, ix_col)
    where ``ix_row`` repeats each row id by its degree.  This is the
    reference's two-pass batch gather (``cython_loops.pxi:27-42, 770-797``)."""
    try:
        from .._native import gather_rows  # noqa: PLC0415

        return gather_rows(indptr, indices, data, rows)
    except Exception:
        rows64 = rows.astype(np.int64, copy=False)
        starts = indptr[rows64]
        counts = (indptr[rows64 + 1] - starts).astype(np.int64)
        total = int(counts.sum())
        # vectorized ragged gather: position j within the output maps to
        # indices[starts[r_j] + (j - out_start[r_j])]
        out_r = np.repeat(rows.astype(np.int32, copy=False), counts)
        ends = np.cumsum(counts)
        gather_ix = np.repeat(starts - (ends - counts), counts) + np.arange(total, dtype=np.int64)
        return data[gather_ix], out_r, indices[gather_ix]


def hyperparams_txt(path: str, a, a_prime, b_prime, c, c_prime, d_prime, k, random_seed):
    """Write hyperparameters.txt in the reference's exact format
    (``hpfrec/__init__.py:494-506``)."""
    with open(os.path.join(path, "hyperparameters.txt"), "w") as pf:
        pf.write("a: %.3f\n" % a)
        pf.write("a_prime: %.3f\n" % a_prime)
        pf.write("b_prime: %.3f\n" % b_prime)
        pf.write("c: %.3f\n" % c)
        pf.write("c_prime: %.3f\n" % c_prime)
        pf.write("d_prime: %.3f\n" % d_prime)
        pf.write("k: %d\n" % k)
        if random_seed is not None:
            pf.write("random seed: %d\n" % random_seed)
        else:
            pf.write("random seed: None\n")
