"""Native C++ data-layer kernels vs scipy/numpy references."""

import numpy as np
import pytest

native = pytest.importorskip("hpfrec_jax._native")

if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def test_openmp_probe():
    assert native.get() in (0, 1)


def test_coo_to_csr_matches_scipy():
    from scipy.sparse import coo_array

    rng = np.random.default_rng(0)
    nU, nI = 300, 200
    # unique (row, col) pairs: scipy's tocsr sums duplicates, the native
    # builder (like the reference's compute path) preserves them
    cells = rng.choice(nU * nI, size=5000, replace=False)
    rows = (cells // nI).astype(np.int32)
    cols = (cells % nI).astype(np.int32)
    nnz = len(cells)
    vals = rng.random(nnz).astype(np.float32)

    indptr, indices, data = native.coo_to_csr(rows, cols, vals, nU)
    ref = coo_array((vals, (rows, cols)), shape=(nU, nI)).tocsr()
    np.testing.assert_array_equal(indptr, ref.indptr.astype(np.int64))
    # scipy sorts columns within rows; ours keeps appearance order —
    # compare per-row sets and value sums
    for r in range(0, nU, 37):
        st, en = indptr[r], indptr[r + 1]
        np.testing.assert_array_equal(np.sort(indices[st:en]),
                                      np.sort(ref.indices[ref.indptr[r]:ref.indptr[r + 1]]))
        np.testing.assert_allclose(np.sort(data[st:en]),
                                   np.sort(ref.data[ref.indptr[r]:ref.indptr[r + 1]]))


def test_gather_rows():
    rng = np.random.default_rng(1)
    nU, nI, nnz = 100, 80, 2000
    rows = np.sort(rng.integers(0, nU, nnz)).astype(np.int32)
    cols = rng.integers(0, nI, nnz).astype(np.int32)
    vals = rng.random(nnz).astype(np.float32)
    indptr, indices, data = native.coo_to_csr(rows, cols, vals, nU)

    batch = rng.choice(nU, size=17, replace=False).astype(np.int64)
    y, r, c = native.gather_rows(indptr, indices, data, batch)
    # reference: numpy concatenation
    exp_y, exp_r, exp_c = [], [], []
    for b in batch:
        st, en = indptr[b], indptr[b + 1]
        exp_c.append(indices[st:en])
        exp_y.append(data[st:en])
        exp_r.append(np.full(en - st, b, dtype=np.int32))
    np.testing.assert_array_equal(r, np.concatenate(exp_r))
    np.testing.assert_array_equal(c, np.concatenate(exp_c))
    np.testing.assert_allclose(y, np.concatenate(exp_y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_csr_cols_matches_argsort(dtype):
    """In-place per-row sort == the stable full-key argsort it replaces,
    including duplicate (row, col) entries keeping input order."""
    rng = np.random.default_rng(4)
    nU, nI, nnz = 200, 150, 4000
    rows = np.sort(rng.integers(0, nU, nnz)).astype(np.int32)
    cols = rng.integers(0, nI, nnz).astype(np.int32)
    cols[50:70] = cols[49]  # duplicates inside a row
    vals = rng.random(nnz).astype(dtype)
    indptr, indices, data = native.coo_to_csr(rows, cols, vals, nU)

    row_of = np.repeat(np.arange(nU, dtype=np.int64), np.diff(indptr))
    key = row_of * np.int64(nI) + indices.astype(np.int64)
    order = np.argsort(key, kind="stable")
    exp_idx, exp_dat = indices[order], data[order]

    got_idx, got_dat = indices.copy(), data.copy()
    native.sort_csr_cols(indptr, got_idx, got_dat)
    np.testing.assert_array_equal(got_idx, exp_idx)
    np.testing.assert_array_equal(got_dat, exp_dat)

    # idempotent (sorted-row fast path)
    native.sort_csr_cols(indptr, got_idx, got_dat)
    np.testing.assert_array_equal(got_idx, exp_idx)
    np.testing.assert_array_equal(got_dat, exp_dat)


def test_factorize_matches_pandas():
    import pandas as pd

    rng = np.random.default_rng(2)
    ids = rng.integers(-1000, 10**12, 5000)
    ids[100:200] = ids[0]  # duplicates
    codes, uniques = native.factorize_i64(ids)
    ref_codes, ref_uniques = pd.factorize(ids)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(uniques, np.asarray(ref_uniques))


def test_data_pipeline_uses_native_consistently():
    """process_data native sort == numpy fallback sort (same blocked data)."""
    import pandas as pd

    from hpfrec_jax.utils.data import process_data

    rng = np.random.default_rng(3)
    df = pd.DataFrame({
        "UserId": rng.integers(0, 50, 900),
        "ItemId": rng.integers(0, 40, 900),
        "Count": rng.poisson(2, 900) + 1,
    }).drop_duplicates(["UserId", "ItemId"])
    out = process_data(df, "maxiter", True, np.float32)
    assert (np.diff(out.ix_u) >= 0).all()  # user-sorted
    assert out.y.shape == out.ix_i.shape == out.ix_u.shape
    # per-user multisets identical to input
    for u in range(0, out.nusers, 11):
        got = np.sort(out.ix_i[out.ix_u == u])
        uid = out.user_mapping[u]
        exp = np.sort(
            process_data(df, "maxiter", True, np.float32, sort_by_user=False).ix_i[
                process_data(df, "maxiter", True, np.float32, sort_by_user=False).ix_u == u])
        np.testing.assert_array_equal(got, exp)
