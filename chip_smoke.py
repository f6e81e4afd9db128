"""Smoke run of hpfrec_jax on NVIDIA GPUs, through the public ``HPF`` API.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: the mesh engines only

One GPU, in one process:

1. device: the JAX device and the card's name and power limit;
2. parity: one ELL and one COO CAVI iteration (and the bfloat16-gather ELL
   variant) at k=50 against the float64 numpy oracle (``tests/oracle.py``),
   in float32 and in float64;
3. fit: ``HPF.fit`` at the MillionSong TasteProfile shape (1,019,318 users
   x 376,768 items, 38.7M nonzeros, k=50, Zipf item popularity);
4. determinism: the same fit again, which must give bit-identical factors;
5. serving and online updates on the fitted model: ``topN_batch`` against
   a numpy float64 top-k, ``predict``, ``eval_llk``, ``predict_factors``,
   ``add_user`` and ``partial_fit``;
6. svi: two SVI epochs at the medium shape (200K x 40K, 10M nonzeros).

With ``--chips 4``: the TasteProfile fit on a four-device mesh with
``shard_tables`` off and on, each compared with the same fit on one
device, and a mesh-sharded SVI epoch compared with the one-device epoch.

Every phase prints one JSON line with its seconds; the line before the last
is the card's name and power limit as ``nvidia-smi`` reports them, and the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero and prints no result; it also exits non-zero,
before doing any work, when JAX finds no GPU.  Inputs are ndarrays made
from a seed, so pandas is not needed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the reference's MillionSong TasteProfile run (BASELINE.md) and bench.py's
# medium shape
TASTE = dict(n_users=1_019_318, n_items=376_768, nnz=38_700_000)
MEDIUM = dict(n_users=200_000, n_items=40_000, nnz=10_000_000)
PARITY = dict(n_users=20_000, n_items=5_000, nnz=500_000)
K = 50


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def card_info():
    """``name, power.limit`` per card, from nvidia-smi (a child process that
    does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpus(n):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU (platform %r); "
                         "nothing was run" % devs[0].platform)
    if len(devs) < n:
        raise SystemExit("chip_smoke: %d GPUs needed, JAX found %d"
                         % (n, len(devs)))
    return devs[:n]


def powerlaw_counts(n_users, n_items, nnz, seed=0):
    """(n, 3) int64 [user, item, count] triplets, user-sorted, with Zipf
    item popularity (the degree skew of TasteProfile)."""
    from bench import synth_powerlaw

    y, iu, ii = synth_powerlaw(n_users, n_items, nnz, seed=seed)
    return np.column_stack([iu, ii, y]).astype(np.int64)


def peak_bytes():
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def rel_err(ours, ref, rtol, atol):
    """Largest |ours - ref| / (atol + rtol |ref|): at most 1 passes."""
    ours = np.asarray(ours, dtype=np.float64)
    return float(np.max(np.abs(ours - ref) / (atol + rtol * np.abs(ref))))


def phase_parity(n_users, n_items, nnz, k):
    """One CAVI iteration of each engine against the float64 oracle."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import OracleHPF, synth_counts

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.cavi import BlockedCOO, cavi_step
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.utils.data import block_coo, build_csr

    hp = Hyperparams(k=k)
    out = {}
    for dtype, tol in ((np.float32, 2e-4), (np.float64, 1e-9)):
        with jax.enable_x64(dtype == np.float64):
            y, iu, ii = synth_counts(n_users, n_items, nnz, seed=5, dtype=dtype)
            state = initialize_state(n_users, n_items, hp, 11, dtype)
            ref = OracleHPF(*hp).init(n_users, n_items, 11, dtype)
            for name in ("G_shp", "G_rte", "L_shp", "L_rte", "k_rte", "t_rte"):
                setattr(ref, name, getattr(ref, name).astype(np.float64))
            ref.full_step(y.astype(np.float64), iu, ii)
            ell_u = device_ell(build_ell(*build_csr(iu, ii, y, n_users, n_items),
                                         n_users, dtype=dtype))
            ell_i = device_ell(build_ell(*build_csr(ii, iu, y, n_items, n_users),
                                         n_items, dtype=dtype))
            blk = block_coo(y, iu, ii)
            coo = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u),
                             jnp.asarray(blk.ix_i))
            step_ell = jax.jit(cavi_step_ell,
                               static_argnames=("hp", "gather_dtype"))
            runs = {"ell": (step_ell(state, ell_u, ell_i, hp=hp), tol),
                    "coo": (jax.jit(cavi_step, static_argnames="hp")(
                        state, coo, hp=hp), tol)}
            if dtype == np.float32:
                # the explicit gather_dtype='bfloat16' option, at the
                # tolerance tests/test_ell.py states for it
                runs["ell_bf16"] = (step_ell(state, ell_u, ell_i, hp=hp,
                                             gather_dtype=jnp.bfloat16), 2e-2)
            for engine, (st, t) in runs.items():
                err = max(rel_err(getattr(st, f), getattr(ref, r), t, t)
                          for f, r in (("G_shp", "G_shp"), ("G_rte", "G_rte"),
                                       ("L_shp", "L_shp"), ("L_rte", "L_rte"),
                                       ("k_rte", "k_rte"), ("t_rte", "t_rte")))
                key = "%s_%s" % (engine, np.dtype(dtype).name)
                out[key] = {"tol": t, "max_err_over_tol": err}
                if not err <= 1.0:
                    raise AssertionError("%s differs from the oracle: %s"
                                         % (key, out[key]))
    return out


def fit_taste(data, maxiter, check_every=5, **kw):
    """``HPF.fit`` at the TasteProfile shape; returns the model and the
    train llk printed at each convergence check."""
    from hpfrec_jax import HPF

    model = HPF(k=K, stop_crit="train-llk", check_every=check_every,
                maxiter=maxiter, random_seed=123, reindex=False,
                verbose=True, **kw)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        model.fit(data)
    llks = [float(v) for v in re.findall(r"Iteration \d+ \| train llk: (-?\d+)",
                                         log.getvalue())]
    if not (np.isfinite(model.Theta).all() and np.isfinite(model.Beta).all()):
        raise AssertionError("non-finite factors")
    return model, llks


def fit_fields(model, llks):
    st = model.fit_stats_
    steady = st.phases.get("device", 0.0) / max(st.iterations - 1, 1)
    return {"train_llk_at_checks": llks, "iterations": st.iterations,
            "wall_s": round(st.wall_seconds, 3),
            "phases_s": {k: round(v, 3) for k, v in st.phases.items()},
            "compile_and_warmup_s": round(st.phases.get("compile_and_warmup", 0.0), 3),
            "steady_s_per_iter": round(steady, 4),
            "peak_bytes_in_use": peak_bytes()}


def check_topn(model, users, top, n):
    """Each user's top-n set must be a top-n set of the numpy float64
    scores over unseen items (ties may order or pick differently)."""
    Theta = np.asarray(model.Theta, dtype=np.float64)
    Beta = np.asarray(model.Beta, dtype=np.float64)
    worst = 0.0
    for j, u in enumerate(users):
        s = Beta @ Theta[u]
        seen = model.seen[model._st_ix_user[u]:
                          model._st_ix_user[u] + model._n_seen_by_user[u]]
        s[seen] = -np.inf
        if np.isin(top[j], seen).any() or len(set(top[j].tolist())) != n:
            raise AssertionError("top-N for user %d has seen or repeated items" % u)
        kth = np.partition(s, -n)[-n]
        gap = (kth - s[top[j]].min()) / max(abs(kth), 1e-30)
        worst = max(worst, gap)
    # float32 scoring: a chosen item may trail the true n-th score by
    # rounding only
    if worst > 1e-5:
        raise AssertionError("top-N disagrees with numpy (relative gap %g)" % worst)
    return worst


def phase_serving(model, data, n_users, n_items):
    rng = np.random.default_rng(3)
    users = np.sort(rng.choice(n_users, 1024, replace=False))
    t = time.time()
    top = model.topN_batch(users, n=10, exclude_seen=True)
    top_s = time.time() - t
    gap = check_topn(model, users, top, 10)

    pu, pi = rng.integers(0, n_users, 4096), rng.integers(0, n_items, 4096)
    pred = model.predict(user=pu, item=pi)
    llk = model.eval_llk(data[rng.choice(len(data), min(len(data), 100_000),
                                         replace=False)])
    hist = np.column_stack([rng.choice(n_items, 40, replace=False),
                            rng.integers(1, 5, 40)])
    theta = model.predict_factors(hist)
    model.add_user(n_users, hist)
    batch_users = rng.choice(n_users, 256, replace=False)
    batch = data[np.isin(data[:, 0], batch_users)]
    t = time.time()
    model.partial_fit(batch, batch_type="users")
    pf_s = time.time() - t
    finite = {"predict": np.isfinite(pred).all(),
              "eval_llk": np.isfinite(llk["llk"]),
              "predict_factors": np.isfinite(theta).all() and theta.shape == (K,),
              "add_user": model.Theta.shape[0] == n_users + 1,
              "partial_fit": bool(np.isfinite(model.Theta).all()
                                  and np.isfinite(model.Beta).all())}
    if not all(finite.values()):
        raise AssertionError("serving/online results: %s" % finite)
    return {"topn_users": len(users), "topn_s": round(top_s, 4),
            "topn_max_rel_gap": gap, "eval_llk": llk["llk"],
            "partial_fit_rows": int(len(batch)), "partial_fit_s": round(pf_s, 3)}


def fit_svi(data, use_float=True, **kw):
    from hpfrec_jax import HPF

    model = HPF(k=K, users_per_batch=20_000, maxiter=2, stop_crit="train-llk",
                check_every=1, random_seed=123, verbose=False,
                use_float=use_float, **kw)
    model.fit(data)
    if not np.isfinite(model.train_llk):
        raise AssertionError("SVI llk is not finite: %r" % model.train_llk)
    return model


def run_one_gpu():
    t0 = time.time()
    (dev,) = require_gpus(1)
    cards = card_info()
    emit("device", t0, platform=dev.platform, kind=dev.device_kind,
         count=1, nvidia_smi=cards)

    t0 = time.time()
    emit("parity", t0, shape=PARITY, k=K,
         **phase_parity(PARITY["n_users"], PARITY["n_items"], PARITY["nnz"], K))

    t0 = time.time()
    data = powerlaw_counts(**TASTE)
    emit("data", t0, shape=TASTE, rows=int(len(data)))

    t0 = time.time()
    model, llks = fit_taste(data, maxiter=10)
    if len(llks) < 2 or not llks[-1] > llks[0]:
        raise AssertionError("train llk did not improve: %s" % llks)
    emit("fit", t0, shape=TASTE, k=K, **fit_fields(model, llks))

    t0 = time.time()
    again, llks2 = fit_taste(data, maxiter=10)
    same = (np.array_equal(model.Theta, again.Theta)
            and np.array_equal(model.Beta, again.Beta))
    if not same:
        raise AssertionError("repeat fit is not bit-identical")
    emit("determinism", t0, bit_identical=True, **fit_fields(again, llks2))
    del again

    t0 = time.time()
    emit("serving", t0, **phase_serving(model, data, TASTE["n_users"],
                                        TASTE["n_items"]))
    del model, data

    t0 = time.time()
    svi = fit_svi(powerlaw_counts(**MEDIUM, seed=1))
    emit("svi", t0, shape=MEDIUM, k=K, train_llk=svi.train_llk,
         phases_s={k: round(v, 3) for k, v in svi.fit_stats_.phases.items()},
         peak_bytes_in_use=peak_bytes())
    return dev, cards


def max_rel_diff(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def run_four_gpus():
    from hpfrec_jax.parallel import make_mesh

    t0 = time.time()
    devs = require_gpus(4)
    cards = card_info()
    emit("device", t0, platform=devs[0].platform, kind=devs[0].device_kind,
         count=4, nvidia_smi=cards)

    data = powerlaw_counts(**TASTE)
    t0 = time.time()
    one, _ = fit_taste(data, maxiter=2, check_every=2,
                       mesh=make_mesh(devs[:1]))
    emit("fit_1dev", t0, **fit_fields(one, []))
    # tolerances of tests/test_ell.py (data-parallel) and
    # tests/test_table_sharded.py (table-sharded) for the same comparison
    for shard_tables, rtol, atol in ((False, 1e-5, 0.0), (True, 1e-4, 1e-6)):
        t0 = time.time()
        m, _ = fit_taste(data, maxiter=2, check_every=2, mesh=make_mesh(devs),
                         shard_tables=shard_tables)
        diff = {"theta_max_rel": max_rel_diff(m.Theta, one.Theta),
                "beta_max_rel": max_rel_diff(m.Beta, one.Beta)}
        emit("fit_4dev", t0, shard_tables=shard_tables, rtol=rtol, atol=atol,
             **diff, **fit_fields(m, []))
        np.testing.assert_allclose(m.Theta, one.Theta, rtol=rtol, atol=atol)
        np.testing.assert_allclose(m.Beta, one.Beta, rtol=rtol, atol=atol)
        del m
    del one, data

    # float64, held to tests/test_svi_fit_parity.py's tolerance
    svi_data = powerlaw_counts(**MEDIUM, seed=1)
    t0 = time.time()
    s1 = fit_svi(svi_data, use_float=False, mesh=make_mesh(devs[:1]))
    s4 = fit_svi(svi_data, use_float=False, mesh=make_mesh(devs))
    emit("svi_4dev", t0, theta_max_rel=max_rel_diff(s4.Theta, s1.Theta),
         train_llk=[s1.train_llk, s4.train_llk])
    np.testing.assert_allclose(s4.Theta, s1.Theta, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s4.Beta, s1.Beta, rtol=1e-8, atol=1e-10)
    return devs[0], cards


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: every phase on one GPU; 4: the mesh engines")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import hpfrec_jax  # noqa: F401  (fails first when run without the repo)

    dev, cards = run_four_gpus() if args.chips == 4 else run_one_gpu()
    import jax

    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}),
          flush=True)


if __name__ == "__main__":
    main()
