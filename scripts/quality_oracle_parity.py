"""Quality parity with a REAL comparison column.

Fits the framework AND ``tests/oracle.py``'s ``OracleHPF`` — the
independent numpy implementation of the reference math
(``/root/reference/hpfrec/cython_loops.pxi:227-259``) — end-to-end on the
SAME synthetic split with the SAME seed, then reports the reference
notebook's quality protocol (mean predicted rate on test vs random pairs,
ROC-AUC, corr) plus recall@10 / NDCG@10 side by side.  Both models start
from the identical MT19937 init bitstream, so metric deltas measure only
engine numerics (float32 on the device vs float64 numpy) — the like-for-like
"matching llk & recall@k within run variance" column BASELINE.md asks
for.  The real TasteProfile and a compiled reference build are
environment-blocked (no network, no cython — verified round 4).

Run (on a GPU):
  python scripts/quality_oracle_parity.py               # 3M-nnz Zipf
  QUALITY_SCALE=ml100k python scripts/quality_oracle_parity.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

SCALES = {
    # largest the host oracle comfortably fits end-to-end (~5 s/iter)
    "zipf3m": dict(nU=120_000, nI=25_000, nnz=3_000_000, k=30, iters=30,
                   rank_users=10_000),
    # BASELINE.json configs[1]: the MovieLens-100K shape
    "ml100k": dict(nU=943, nI=1_682, nnz=100_000, k=30, iters=30,
                   rank_users=None),
}


def synth_zipf(nU, nI, nnz, seed=0):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, nnz).astype(np.int64)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int64)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return iu, ii, y


def main():
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.utils.evaluation import evaluate
    from oracle import OracleHPF

    scale = os.environ.get("QUALITY_SCALE", "zipf3m")
    cfg = SCALES[scale]
    nU, nI, nnz, k = cfg["nU"], cfg["nI"], cfg["nnz"], cfg["k"]
    iters = cfg["iters"]
    seed = 123

    iu, ii, y = synth_zipf(nU, nI, nnz, seed=0)
    rng = np.random.default_rng(7)
    is_train = rng.random(nnz) < 0.8
    train_df = pd.DataFrame({"UserId": iu[is_train], "ItemId": ii[is_train],
                             "Count": y[is_train]})
    test_df = pd.DataFrame({"UserId": iu[~is_train], "ItemId": ii[~is_train],
                            "Count": y[~is_train]})

    # --- framework fit (reindex=False: both fits share one id space) ---
    model = HPF(k=k, maxiter=iters, stop_crit="maxiter", check_every=iters,
                random_seed=seed, reindex=False, keep_data=True,
                verbose=False)
    t0 = time.time()
    model.fit(train_df)
    t_model = time.time() - t0
    print("# framework fit: %.0f s (%d iters)" % (t_model, model.niter + 1),
          file=sys.stderr)

    # --- oracle fit: reference math, same seed, same data ---
    # nusers/nitems as the framework derived them (max id + 1)
    onU, onI = model.nusers, model.nitems
    oracle = OracleHPF(model.a, model.a_prime, model.b_prime,
                       model.c, model.c_prime, model.d_prime, k)
    oracle.init(onU, onI, seed=seed, dtype=np.float32)
    ytr = train_df["Count"].to_numpy(np.float32)
    utr = train_df["UserId"].to_numpy(np.int64)
    itr = train_df["ItemId"].to_numpy(np.int64)
    t0 = time.time()
    for it in range(iters):
        oracle.full_step(ytr, utr, itr)
        if (it + 1) % 10 == 0:
            print("# oracle iter %d/%d (%.0f s)"
                  % (it + 1, iters, time.time() - t0), file=sys.stderr)
    t_oracle = time.time() - t0
    print("# oracle fit: %.0f s" % t_oracle, file=sys.stderr)

    # oracle "model": the fitted parameters behind the same serving path
    shell = HPF(k=k, reindex=False, keep_data=True, verbose=False,
                random_seed=seed)
    shell.nusers, shell.nitems = onU, onI
    shell.Theta = np.ascontiguousarray(oracle.Theta, dtype=np.float32)
    shell.Beta = np.ascontiguousarray(oracle.Beta, dtype=np.float32)
    shell.seen = model.seen
    shell._st_ix_user = model._st_ix_user
    shell._n_seen_by_user = model._n_seen_by_user
    shell.is_fitted = True

    # train llk (no-constant form, reference pxi:69-79) for both, from
    # the same formula on each fit's parameters
    Th, Be = np.asarray(model.Theta, np.float64), np.asarray(model.Beta,
                                                            np.float64)
    pred_tr = np.einsum("ij,ij->i", Th[utr], Be[itr])
    llk_model = float((ytr * np.log(pred_tr)).sum()
                      - Th.sum(0).dot(Be.sum(0)))
    llk_oracle = float(oracle.train_llk(ytr, utr, itr))

    ev_m = evaluate(model, test_df, k=10, exclude_seen=True,
                    rank_users=cfg["rank_users"])
    ev_o = evaluate(shell, test_df, k=10, exclude_seen=True,
                    rank_users=cfg["rank_users"])

    rows = [
        ("train llk (no constant)", llk_model, llk_oracle),
        ("mean pred rate, test pairs", ev_m["mean_pred_test"], ev_o["mean_pred_test"]),
        ("mean pred rate, random pairs", ev_m["mean_pred_random"], ev_o["mean_pred_random"]),
        ("lift", ev_m["lift"], ev_o["lift"]),
        ("ROC-AUC", ev_m["roc_auc"], ev_o["roc_auc"]),
        ("corr(Count, Predicted)", ev_m["corr_count_pred"], ev_o["corr_count_pred"]),
        ("recall@10", ev_m["recall_at_10"], ev_o["recall_at_10"]),
        ("NDCG@10", ev_m["ndcg_at_10"], ev_o["ndcg_at_10"]),
    ]
    print("\n%-30s %16s %16s" % ("metric (scale=%s)" % scale,
                                 "framework (f32)", "oracle (ref math)"))
    for name, a, b in rows:
        fa = "None" if a is None else ("%.6g" % a)
        print("%-30s %16s %16.6g" % (name, fa, b))
    print(json.dumps({
        "scale": scale, "config": "nU=%d nI=%d nnz=%d k=%d iters=%d" % (
            nU, nI, nnz, k, iters),
        "n_eval_users": ev_m["n_eval_users"],
        "framework": {n: a for n, a, _ in rows},
        "oracle": {n: b for n, _, b in rows},
        "fit_seconds": {"framework": round(t_model, 1),
                        "oracle": round(t_oracle, 1)},
    }))


if __name__ == "__main__":
    main()
