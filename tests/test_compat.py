"""compat helpers vs scipy/numpy references."""

import numpy as np

from hpfrec_jax import compat


def test_get_csc_data_matches_scipy():
    from scipy.sparse import coo_array

    rng = np.random.default_rng(0)
    nU, nI = 40, 30
    cells = rng.choice(nU * nI, size=300, replace=False)
    u = (cells // nI).astype(np.int32)
    i = (cells % nI).astype(np.int32)
    y = rng.random(300).astype(np.float32)
    indptr, indices, data = compat.get_csc_data(u, i, y, nU, nI)
    ref = coo_array((y, (u, i)), shape=(nU, nI)).tocsc()
    np.testing.assert_array_equal(indptr, ref.indptr)
    for c in range(nI):
        np.testing.assert_array_equal(
            np.sort(indices[indptr[c]:indptr[c + 1]]),
            np.sort(ref.indices[ref.indptr[c]:ref.indptr[c + 1]]))


def test_get_unique_items_batch():
    rng = np.random.default_rng(1)
    nU, nI = 30, 25
    iu = np.sort(rng.integers(0, nU, 400))
    ii = rng.integers(0, nI, 400)
    indptr = np.zeros(nU + 1, dtype=np.int64)
    np.add.at(indptr, iu + 1, 1)
    np.cumsum(indptr, out=indptr)
    users = np.array([3, 7, 11])
    items, st_pos = compat.get_unique_items_batch(users, indptr, ii, 1, return_ix=True)
    expected = np.unique(np.concatenate(
        [ii[indptr[u]:indptr[u + 1]] for u in users]))
    np.testing.assert_array_equal(items, expected)
    assert st_pos[-1] == sum(indptr[u + 1] - indptr[u] for u in users)


def test_casts():
    assert compat.cast_real_t(1.5) == np.float32(1.5)
    assert compat.cast_int(3.0) == 3
    assert compat.cast_ind_type(7) == 7
