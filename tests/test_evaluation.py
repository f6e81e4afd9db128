"""Tests for utils.evaluation: exact small-case checks + statistical sanity
on a fitted model (the notebook cells 13-15 protocol, BASELINE.md rows)."""

import numpy as np
import pandas as pd
import pytest

from hpfrec_jax import HPF
from hpfrec_jax.utils import evaluation as ev


def _manual_model(Theta, Beta):
    """A 'fitted' model with hand-set factors, reindex=False."""
    m = HPF(k=Theta.shape[1], reindex=False, verbose=False)
    m.Theta = np.asarray(Theta, dtype=np.float32)
    m.Beta = np.asarray(Beta, dtype=np.float32)
    m.nusers = Theta.shape[0]
    m.nitems = Beta.shape[0]
    m.is_fitted = True
    return m


def test_ranking_metrics_exact():
    # 2 users, 4 items, scores are just Beta[:, 0] ordering per user
    Theta = np.array([[1.0], [1.0]])
    Beta = np.array([[4.0], [3.0], [2.0], [1.0]])  # ranking: 0,1,2,3
    m = _manual_model(Theta, Beta)
    # user 0 test items {0, 3}: top-2 = {0,1} -> 1 hit at rank 1
    #   recall@2 = 1/2; ndcg@2 = (1/log2(2)) / (1/log2(2)+1/log2(3)) = .6131
    # user 1 test items {1}:   top-2 = {0,1} -> 1 hit at rank 2
    #   recall@2 = 1/1; ndcg@2 = (1/log2(3)) / (1/log2(2)) = 0.6309
    test = np.array([[0, 0, 1.0], [0, 3, 1.0], [1, 1, 1.0]])
    out = ev.ranking_metrics(m, test, k=2, exclude_seen=False)
    ndcg0 = (1 / np.log2(2)) / (1 / np.log2(2) + 1 / np.log2(3))
    ndcg1 = (1 / np.log2(3)) / (1 / np.log2(2))
    assert out["n_users"] == 2
    np.testing.assert_allclose(out["recall"], (0.5 + 1.0) / 2, rtol=1e-12)
    np.testing.assert_allclose(out["ndcg"], (ndcg0 + ndcg1) / 2, rtol=1e-6)


def test_roc_auc_exact_separable():
    # model scores: user u's rate for item i = Theta[u] . Beta[i]
    Theta = np.array([[2.0], [1.0]])
    Beta = np.array([[1.0], [10.0]])
    m = _manual_model(Theta, Beta)
    # test pairs all involve item 1 (scores 20, 10); random pairs at seed
    # will mix; AUC must be within [0, 1] and here close to 1 since item 1
    # dominates any uniform mixture half the time
    test = np.array([[0, 1, 1.0], [1, 1, 1.0]])
    auc = ev.roc_auc(m, test, random_seed=3)
    assert 0.0 <= auc <= 1.0
    assert auc >= 0.5


def test_roc_auc_ties_midrank():
    # constant scores -> AUC exactly 0.5 via midrank handling
    Theta = np.ones((4, 1))
    Beta = np.ones((5, 1))
    m = _manual_model(Theta, Beta)
    test = np.array([[0, 0, 1.0], [1, 1, 1.0], [2, 2, 1.0]])
    auc = ev.roc_auc(m, test, random_seed=0)
    np.testing.assert_allclose(auc, 0.5, atol=1e-12)


def test_evaluate_on_fitted_model():
    rng = np.random.default_rng(0)
    nU, nI, nnz = 80, 60, 3000
    # planted low-rank structure: draw the full Poisson matrix and keep the
    # nonzeros, so WHICH pairs are observed carries the signal (like real
    # implicit-count data)
    Tt = rng.gamma(0.3, 1.0, (nU, 4))
    Bt = rng.gamma(0.3, 1.0, (nI, 4))
    Y = rng.poisson(Tt @ Bt.T)
    u, i = np.nonzero(Y)
    y = Y[u, i].astype(np.float64)
    perm = rng.permutation(len(y))
    u, i, y = u[perm], i[perm], y[perm]
    nnz = len(y)
    df = pd.DataFrame({"UserId": u, "ItemId": i, "Count": y})
    train = df.iloc[: nnz * 4 // 5].drop_duplicates(["UserId", "ItemId"])
    test = df.iloc[nnz * 4 // 5:].drop_duplicates(["UserId", "ItemId"])
    m = HPF(k=8, maxiter=30, verbose=False, random_seed=1, keep_data=True)
    m.fit(train)
    out = ev.evaluate(m, test, k=10, exclude_seen=True, random_seed=1)
    for key in ("mean_pred_test", "mean_pred_random", "lift", "roc_auc",
                "corr_count_pred", "recall_at_10", "ndcg_at_10"):
        assert key in out
        assert np.isfinite(out[key]), key
    assert 0.0 <= out["roc_auc"] <= 1.0
    assert 0.0 <= out["recall_at_10"] <= 1.0
    assert 0.0 <= out["ndcg_at_10"] <= 1.0
    # trained model should rate real interactions above random pairs
    assert out["lift"] > 1.0
    assert out["roc_auc"] > 0.5


def test_unknown_ids_dropped():
    Theta = np.ones((3, 2))
    Beta = np.ones((4, 2))
    m = _manual_model(Theta, Beta)
    test = np.array([[0, 0, 1.0], [99, 1, 1.0], [1, 99, 1.0]])
    y, ru, ri = ev._model_pairs(m, test)
    assert len(y) == 1 and ru[0] == 0 and ri[0] == 0

    with pytest.raises(ValueError):
        ev.ranking_metrics(m, np.array([[99, 0, 1.0]]), k=2, exclude_seen=False)


def test_ranking_metrics_k_exceeds_catalog():
    Theta = np.array([[2.0], [1.0]])
    Beta = np.array([[1.0], [3.0], [2.0]])
    m = _manual_model(Theta, Beta)
    test = np.array([[0, 1, 1.0], [1, 0, 1.0]])
    out = ev.ranking_metrics(m, test, k=10, exclude_seen=False)
    assert out["k"] == 3  # clamped to the catalog size
    assert 0.0 <= out["recall"] <= 1.0 and 0.0 <= out["ndcg"] <= 1.0


def test_evaluate_rank_users_subsample():
    """rank_users caps the ranking pass to a deterministic user sample."""
    rng = np.random.default_rng(4)
    nU, nI = 70, 40
    df = pd.DataFrame({"UserId": rng.integers(0, nU, 2500),
                       "ItemId": rng.integers(0, nI, 2500),
                       "Count": rng.poisson(2.0, 2500) + 1.0}
                      ).drop_duplicates(["UserId", "ItemId"])
    train = df.iloc[: len(df) * 4 // 5]
    test = df.iloc[len(df) * 4 // 5:]
    m = HPF(k=5, maxiter=8, check_every=4, verbose=False, random_seed=1,
            keep_data=True)
    m.fit(train)

    full = ev.evaluate(m, test, k=5)
    sub = ev.evaluate(m, test, k=5, rank_users=10)
    assert sub["n_eval_users"] == 10
    assert full["n_eval_users"] > 10
    # pairwise statistics are unaffected by the ranking subsample
    assert sub["roc_auc"] == full["roc_auc"]
    # deterministic for a fixed seed
    sub2 = ev.evaluate(m, test, k=5, rank_users=10)
    assert sub2["recall_at_5"] == sub["recall_at_5"]
