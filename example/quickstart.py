"""End-to-end example on synthetic implicit-count data.

Reproduces the shape of the reference's README sample usage
(/root/reference/README.md:70-150) and its EchoNest notebook workflow
(fit -> monitor llk -> evaluate -> serve), on synthetic data so it runs
anywhere.  Run:  python example/quickstart.py
"""

import numpy as np
import pandas as pd

from hpfrec_jax import HPF


def make_synthetic(nusers=2000, nitems=1500, nnz=120_000, seed=1):
    """Zipf-ish implicit counts with planted low-rank structure."""
    rng = np.random.default_rng(seed)
    k_true = 8
    theta = rng.gamma(0.5, 1.0, size=(nusers, k_true))
    beta = rng.gamma(0.5, 1.0, size=(nitems, k_true))
    u = rng.integers(nusers, size=nnz)
    i = rng.integers(nitems, size=nnz)
    rate = np.einsum("ij,ij->i", theta[u], beta[i])
    y = rng.poisson(rate) + 1
    df = pd.DataFrame({"UserId": u, "ItemId": i, "Count": y})
    return df.drop_duplicates(["UserId", "ItemId"]).reset_index(drop=True)


def main():
    df = make_synthetic()
    val = df.sample(frac=0.15, random_state=7)
    train = df.drop(val.index)

    model = HPF(k=30, stop_crit="val-llk", check_every=5, stop_thr=1e-4,
                maxiter=200, random_seed=123)
    model.fit(train, val_set=val)
    print("fit throughput: %.3g nonzero-updates/s end-to-end "
          "(%d iterations over %d nonzeros in %.1fs)"
          % (model.fit_stats_.nnz_per_second, model.fit_stats_.iterations,
             model.fit_stats_.nnz, model.fit_stats_.wall_seconds))

    # --- evaluation ---------------------------------------------------
    print("\nheld-out llk:", model.eval_llk(val.copy()))

    from hpfrec_jax.utils import evaluation as ev

    report = ev.evaluate(model, val, k=10, exclude_seen=True, random_seed=7)
    print("ranking eval:", {kk: round(v, 4) if isinstance(v, float) else v
                            for kk, v in report.items()})

    # --- serving ------------------------------------------------------
    some_user = train["UserId"].iloc[0]
    print("top-10 for user", some_user, ":", model.topN(user=some_user, n=10))
    users = train["UserId"].drop_duplicates().to_numpy()[:64]
    recs = model.topN_batch(users, n=10)
    print("batch recommendations:", recs.shape)

    # --- fold-in a brand new user ------------------------------------
    hist = train.loc[train["UserId"] == some_user, ["ItemId", "Count"]]
    theta_new = model.predict_factors(hist.copy())
    print("fold-in factors:", np.round(theta_new[:6], 4))

    model.add_user(user_id=10**9, counts_df=hist.copy())
    print("after add_user, topN:", model.topN(user=10**9, n=5))


if __name__ == "__main__":
    main()
