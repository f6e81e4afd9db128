"""The BASELINE.json north-star, end to end on one GPU: fit a
MillionSong-TasteProfile-shape dataset (38.7M train nonzeros, 1,019,318
users x 376,768 items, k=30) to CONVERGED val-llk, through the public
``HPF.fit`` API with a real validation set — the configuration the
reference's EchoNest notebook records at 42:48 total wall (38.3 min of
optimization) on a 24-core Skylake
(/root/reference/example/hpfrec_echonest.ipynb cell 10; README.md:9).

Unlike bench.py (steady-state device rate, no host work) this measures
the WHOLE pipeline — triplet ingest, factorize reindex, CSR builds,
ELL packing, transfers, jit compile, optimization, val-llk checks — and
prints the per-phase wall-time attribution from ``fit_stats_``.

Run (on a GPU):  python example/northstar_e2e.py
Env: NORTHSTAR_K (default 30), NORTHSTAR_MAXITER (150),
     NORTHSTAR_NNZ (48_373_586 total rows before the 80/20 split),
     NORTHSTAR_STOP_CRIT (default val-llk; set to ``maxiter`` with
     NORTHSTAR_MAXITER=110 to MEASURE the reference's 110-iteration
     count instead of early-stopping on the easy synthetic stand-in;
     train llk+rmse still evaluates every check_every like the
     notebook's run).
"""

import os
import time

import numpy as np

# this script exists to ATTRIBUTE the wall time, so force the transfer
# phase to materialize separately from compile (costs some wall vs the
# default async overlap; see utils/profiling.FitStats)
os.environ.setdefault("HPFREC_PROFILE_TRANSFERS", "1")


def synth_tasteprofile(nU=1_019_318, nI=376_768, n_rows=48_373_586, seed=0):
    """Zipf-item triplets at the notebook's pre-split row count."""
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, n_rows).astype(np.int64)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=n_rows, p=p).astype(np.int64)
    y = (rng.poisson(2.0, n_rows) + 1).astype(np.float64)
    return iu, ii, y


def st_device():
    import jax

    d = jax.devices()[0]
    return "%d x %s" % (len(jax.devices()), d.device_kind)


def main():
    import pandas as pd

    from hpfrec_jax import HPF

    k = int(os.environ.get("NORTHSTAR_K", 30))
    maxiter = int(os.environ.get("NORTHSTAR_MAXITER", 150))
    n_rows = int(os.environ.get("NORTHSTAR_NNZ", 48_373_586))

    print("Generating synthetic TasteProfile (%.1fM rows)..." % (n_rows / 1e6))
    t_gen = time.time()
    iu, ii, y = synth_tasteprofile(n_rows=n_rows)
    rng = np.random.default_rng(7)
    is_train = rng.random(n_rows) < 0.8
    train = pd.DataFrame({"UserId": iu[is_train], "ItemId": ii[is_train],
                          "Count": y[is_train]})
    val = pd.DataFrame({"UserId": iu[~is_train], "ItemId": ii[~is_train],
                        "Count": y[~is_train]})
    print("  %.0fs (train %.1fM, val %.1fM rows)"
          % (time.time() - t_gen, len(train) / 1e6, len(val) / 1e6))

    stop_crit = os.environ.get("NORTHSTAR_STOP_CRIT", "val-llk")
    model = HPF(k=k, stop_crit=stop_crit, check_every=10, stop_thr=1e-3,
                maxiter=maxiter, random_seed=123, verbose=True)
    t0 = time.time()
    model.fit(train, val_set=val if stop_crit == "val-llk" else None)
    wall = time.time() - t0

    st = model.fit_stats_
    print("\n=== North-star result ===")
    print("Converged val-llk fit: %d iterations in %.1f s wall "
          "(reference notebook: 42:48 = 2568 s total, 110 iterations)"
          % (st.iterations, wall))
    print("End-to-end throughput: %.3g nonzero-updates/s" % st.nnz_per_second)
    print("Phase breakdown:")
    print(st.phase_report())
    print("reference: 2568 s on 24 CPU cores; this run: %.0f s on %s"
          % (wall, st_device()))


if __name__ == "__main__":
    main()
