"""End-to-end API tests mirroring the reference README sample usage
(/root/reference/README.md:70-150) — the de-facto smoke test of the
reference (SURVEY.md §4)."""

import numpy as np
import pandas as pd
import pytest

from hpfrec_jax import HPF


@pytest.fixture(scope="module")
def counts_df():
    rng = np.random.default_rng(1)
    nusers, nitems, nobs = 100, 100, 10_000
    df = pd.DataFrame({
        "UserId": rng.integers(nusers, size=nobs),
        "ItemId": rng.integers(nitems, size=nobs),
        "Count": (rng.gamma(1, 1, size=nobs) + 1).astype("int32"),
    })
    return df.loc[~df[["UserId", "ItemId"]].duplicated()].reset_index(drop=True)


@pytest.fixture(scope="module")
def fitted(counts_df):
    model = HPF(k=10, maxiter=30, check_every=10, stop_crit="train-llk",
                random_seed=123, verbose=False)
    model.fit(counts_df.copy())
    return model


def test_fit_sets_attributes(fitted, counts_df):
    assert fitted.is_fitted
    assert fitted.Theta.shape == (fitted.nusers, 10)
    assert fitted.Beta.shape == (fitted.nitems, 10)
    assert fitted.user_mapping_.shape[0] == fitted.nusers
    assert np.all(np.isfinite(fitted.Theta))
    assert np.all(fitted.Theta >= 0)
    assert fitted.niter is not None


def test_fit_improves_llk(counts_df):
    m1 = HPF(k=10, maxiter=1, check_every=1, stop_crit="maxiter",
             random_seed=123, verbose=False)
    m30 = HPF(k=10, maxiter=40, check_every=10, stop_crit="maxiter",
              random_seed=123, verbose=False)
    m1.fit(counts_df.copy())
    m30.fit(counts_df.copy())
    l1 = m1.eval_llk(counts_df.copy())["llk"]
    l30 = m30.eval_llk(counts_df.copy())["llk"]
    assert l30 > l1


def test_seeded_determinism(counts_df):
    a = HPF(k=8, maxiter=10, stop_crit="maxiter", random_seed=9, verbose=False)
    b = HPF(k=8, maxiter=10, stop_crit="maxiter", random_seed=9, verbose=False)
    a.fit(counts_df.copy())
    b.fit(counts_df.copy())
    np.testing.assert_array_equal(a.Theta, b.Theta)
    np.testing.assert_array_equal(a.Beta, b.Beta)


def test_predict_scalar_and_vector(fitted, counts_df):
    u0 = counts_df["UserId"].iloc[0]
    i0 = counts_df["ItemId"].iloc[0]
    p = fitted.predict(user=u0, item=i0)
    assert np.isscalar(p) or p.shape == ()
    assert p >= 0

    users = counts_df["UserId"].to_numpy()[:25]
    items = counts_df["ItemId"].to_numpy()[:25]
    preds = fitted.predict(user=users, item=items)
    assert preds.shape == (25,)
    assert np.all(np.isfinite(preds))
    # consistency between vector and scalar paths
    np.testing.assert_allclose(preds[0], fitted.predict(user=users[0], item=items[0]),
                               rtol=1e-5)


def test_predict_unknown_is_nan(fitted):
    assert np.isnan(fitted.predict(user=123456789, item=0))
    out = fitted.predict(user=np.array([123456789, 0]), item=np.array([0, 123456789]))
    assert np.isnan(out).all()


def test_topn(fitted, counts_df):
    rec = fitted.topN(user=counts_df["UserId"].iloc[0], n=10)
    assert rec.shape[0] == 10
    assert len(np.unique(rec)) == 10
    # excluded seen items
    u0 = counts_df["UserId"].iloc[0]
    seen = set(counts_df.loc[counts_df["UserId"] == u0, "ItemId"])
    assert not (set(rec.tolist()) & seen)
    # without exclusion, top item for a heavy user may be seen
    rec2 = fitted.topN(user=u0, n=10, exclude_seen=False)
    assert rec2.shape[0] == 10


def test_topn_items_pool(fitted, counts_df):
    pool = np.unique(counts_df["ItemId"].to_numpy())[:37]
    rec = fitted.topN(user=counts_df["UserId"].iloc[0], n=5, exclude_seen=False,
                      items_pool=pool)
    assert rec.shape[0] == 5
    assert np.isin(rec, pool).all()


def test_topn_scores_sorted(fitted, counts_df):
    u0 = counts_df["UserId"].iloc[0]
    rec = fitted.topN(user=u0, n=10, exclude_seen=False)
    scores = [fitted.predict(user=u0, item=i) for i in rec]
    assert all(s1 >= s2 - 1e-6 for s1, s2 in zip(scores, scores[1:]))


def test_eval_llk(fitted, counts_df):
    out = fitted.eval_llk(counts_df.copy())
    assert set(out) == {"llk", "nobs"}
    assert out["nobs"] == counts_df.shape[0]
    assert np.isfinite(out["llk"])


def test_predict_factors(fitted, counts_df):
    hist = counts_df.loc[counts_df["UserId"] == counts_df["UserId"].iloc[0],
                         ["ItemId", "Count"]]
    theta = fitted.predict_factors(hist.copy())
    assert theta.shape == (10,)
    assert np.all(np.isfinite(theta))
    assert np.all(theta >= 0)
    theta_all = fitted.predict_factors(hist.copy(), return_all=True)
    assert len(theta_all) == 4


def test_add_user_new(counts_df):
    model = HPF(k=10, maxiter=20, stop_crit="maxiter", random_seed=3, verbose=False)
    model.fit(counts_df.copy())
    nusers_before = model.nusers
    hist = counts_df.loc[counts_df["UserId"] == counts_df["UserId"].iloc[0],
                         ["ItemId", "Count"]]
    ok = model.add_user(user_id=987654, counts_df=hist.copy())
    assert ok
    assert model.nusers == nusers_before + 1
    assert model.Theta.shape[0] == nusers_before + 1
    # new user usable for topN / predict
    rec = model.topN(user=987654, n=5)
    assert rec.shape[0] == 5
    assert np.isfinite(model.predict(user=987654, item=counts_df["ItemId"].iloc[0]))


def test_add_user_update_existing(counts_df):
    model = HPF(k=10, maxiter=20, stop_crit="maxiter", random_seed=3, verbose=False)
    model.fit(counts_df.copy())
    u0 = counts_df["UserId"].iloc[0]
    hist = counts_df.loc[counts_df["UserId"] == u0, ["ItemId", "Count"]]
    before = model.Theta.copy()
    ok = model.add_user(user_id=u0, counts_df=hist.copy(), update_existing=True)
    assert ok
    row = model.user_dict_[u0]
    assert not np.array_equal(model.Theta[row], before[row])
    other = (row + 1) % model.nusers
    np.testing.assert_array_equal(model.Theta[other], before[other])


def test_val_llk_stopping(counts_df):
    val = counts_df.sample(frac=0.2, random_state=5)
    train = counts_df.drop(val.index)
    model = HPF(k=10, maxiter=50, check_every=5, stop_crit="val-llk",
                stop_thr=1e-3, random_seed=123, verbose=False)
    model.fit(train.copy(), val_set=val.copy())
    assert model.is_fitted


def test_diff_norm_stopping(counts_df):
    model = HPF(k=10, maxiter=100, check_every=5, stop_crit="diff-norm",
                stop_thr=1.0, random_seed=123, verbose=False)
    model.fit(counts_df.copy())
    assert model.is_fitted
    assert model.niter < 99  # should stop early with a loose threshold


def test_save_folder(tmp_path, counts_df):
    model = HPF(k=5, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1, verbose=False,
                save_folder=str(tmp_path))
    model.fit(counts_df.copy())
    for f in ["Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp",
              "Lambda_rte", "kappa_rte", "tau_rte", "users.csv", "items.csv",
              "hyperparameters.txt"]:
        assert (tmp_path / f).exists(), f
    theta = np.loadtxt(tmp_path / "Theta", delimiter=",")
    np.testing.assert_allclose(theta, model.Theta, rtol=1e-6, atol=1e-8)


def test_float64_mode(counts_df):
    model = HPF(k=5, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1, verbose=False,
                use_float=False)
    model.fit(counts_df.copy())
    assert model.Theta.dtype == np.float64


def test_coo_input():
    from scipy.sparse import coo_array

    rng = np.random.default_rng(0)
    nU, nI = 50, 40
    iu = rng.integers(0, nU, 600)
    ii = rng.integers(0, nI, 600)
    y = rng.poisson(2, 600) + 1
    X = coo_array((y, (iu, ii)), shape=(nU, nI))
    X.sum_duplicates()
    model = HPF(k=5, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1, verbose=False)
    model.fit(X)
    assert model.nusers == nU
    assert model.nitems == nI
    assert not model.reindex


def test_ndarray_input():
    rng = np.random.default_rng(0)
    arr = np.stack([rng.integers(0, 30, 300), rng.integers(0, 20, 300),
                    rng.poisson(2, 300) + 1.0], axis=1)
    arr = arr[~pd.DataFrame(arr[:, :2]).duplicated().to_numpy()]
    model = HPF(k=5, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1, verbose=False)
    model.fit(arr)
    assert model.is_fitted


def test_string_ids():
    rng = np.random.default_rng(2)
    df = pd.DataFrame({
        "UserId": np.char.add("u", rng.integers(0, 40, 500).astype(str)),
        "ItemId": np.char.add("i", rng.integers(0, 30, 500).astype(str)),
        "Count": rng.poisson(2, 500) + 1,
    }).drop_duplicates(["UserId", "ItemId"])
    model = HPF(k=5, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1, verbose=False)
    model.fit(df)
    u0 = df["UserId"].iloc[0]
    rec = model.topN(user=u0, n=5)
    assert all(isinstance(r, str) for r in rec.tolist())
    assert np.isfinite(model.predict(user=u0, item=df["ItemId"].iloc[0]))


def test_float64_with_forced_bf16_gather(counts_df):
    """The explicitly-permitted use_float=False + gather_dtype='bfloat16'
    combination must not break the fori_loop carry dtype."""
    model = HPF(k=5, maxiter=6, check_every=3, verbose=False, random_seed=2,
                use_float=False, gather_dtype="bfloat16")
    model.fit(counts_df.copy())
    assert model.Theta.dtype == np.float64
    assert np.isfinite(model.Theta).all()


def test_train_llk_computed_when_no_final_check(counts_df):
    """stop_crit='train-llk' with maxiter < check_every (or not a multiple)
    must still produce a real final llk, not the 0.0 placeholder."""
    m2 = HPF(k=5, maxiter=13, check_every=5, stop_crit="train-llk",
             verbose=False, random_seed=3)
    m2.fit(counts_df.copy())
    assert np.isfinite(m2.train_llk) and m2.train_llk != 0.0
