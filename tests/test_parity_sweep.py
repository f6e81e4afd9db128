"""Randomized parity sweep: small random + edge shapes through the PUBLIC
fit path, every engine x mesh x dtype combination, against the numpy
oracle (round-3 verdict item 9).

The layout machinery this guards — width ladder, small-bucket merge,
degree-balanced row snake, column tiling, shard padding — is all
shape-dependent, so regressions hide in edge shapes: nU == nI (dispatch
ambiguity), a single user (extreme degree + heavy shard padding), degree-1
rows (min-width buckets), id gaps with reindex=False (empty table rows),
catalog-head skew (split rows).  Each config fits a few iterations and
must match the oracle's Theta/Beta.
"""

import numpy as np
import pandas as pd
import pytest

from oracle import OracleHPF

HP = dict(a=0.3, a_prime=0.3, b_prime=1.0, c=0.3, c_prime=0.3, d_prime=1.0)


def _triplets(shape_kind, seed):
    """(nU, nI, y, iu, ii) with exact table sizes (reindex=False)."""
    rng = np.random.default_rng(seed)
    if shape_kind == "square":
        nU = nI = 40
        iu = rng.integers(0, nU, 500)
        ii = rng.integers(0, nI, 500)
    elif shape_kind == "single_user":
        nU, nI = 1, 30
        iu = np.zeros(60, dtype=np.int64)
        ii = rng.integers(0, nI, 60)
    elif shape_kind == "single_item":
        nU, nI = 40, 1
        iu = rng.integers(0, nU, 60)
        ii = np.zeros(60, dtype=np.int64)
    elif shape_kind == "degree_one":
        nU, nI = 50, 20
        iu = np.arange(nU, dtype=np.int64)  # every user exactly one play
        ii = rng.integers(0, nI, nU)
    elif shape_kind == "id_gaps":
        # users 10-19 and items 5-9 never appear -> empty table rows
        nU, nI = 45, 25
        iu = rng.choice(np.setdiff1d(np.arange(nU), np.arange(10, 20)), 400)
        ii = rng.choice(np.setdiff1d(np.arange(nI), np.arange(5, 10)), 400)
        iu[0], ii[0] = nU - 1, nI - 1  # pin the table sizes
    elif shape_kind == "skewed":
        nU, nI = 64, 48
        iu = rng.integers(0, nU, 700)
        ranks = 1.0 / np.arange(1, nI + 1)
        ii = rng.choice(nI, 700, p=ranks / ranks.sum())
    else:  # random
        nU = int(rng.integers(3, 80))
        nI = int(rng.integers(3, 80))
        n = int(rng.integers(nU + nI, 4 * (nU + nI)))
        iu = rng.integers(0, nU, n)
        ii = rng.integers(0, nI, n)
        iu[0], ii[0] = nU - 1, nI - 1
    # pin the max ids so reindex=False infers the intended table sizes
    # (random draws can miss row nU-1 / col nI-1)
    iu = iu.copy()
    ii = ii.copy()
    iu[0], ii[0] = nU - 1, nI - 1
    # dedupe (u, i), sum counts, user-major order
    key = iu.astype(np.int64) * nI + ii
    uniq, inv = np.unique(key, return_inverse=True)
    y = np.zeros(len(uniq))
    np.add.at(y, inv, rng.poisson(2.0, len(iu)) + 1)
    return nU, nI, y, (uniq // nI).astype(np.int64), (uniq % nI).astype(np.int64)


def _run_config(shape_kind, k, engine, shard_tables, use_float, seed,
                niter=3, force_tile=False, gather_dtype="auto", tol=None,
                monkeypatch=None):
    from hpfrec_jax import HPF

    if force_tile:
        # shrink the tiling thresholds so column tiling engages at toy
        # scale (normally it needs a >48 MB table)
        import hpfrec_jax.ops.ell as ell_mod

        monkeypatch.setattr(ell_mod, "TILE_THRESHOLD_BYTES", 256)
        monkeypatch.setattr(ell_mod, "FAST_GATHER_BYTES", 512)

    nU, nI, y, iu, ii = _triplets(shape_kind, seed)
    dtype = np.float32 if use_float else np.float64
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    m = HPF(k=k, maxiter=niter, stop_crit="maxiter", check_every=None,
            random_seed=seed, verbose=False, reindex=False,
            use_float=use_float,
            engine=engine, shard_tables=shard_tables,
            gather_dtype=gather_dtype, **HP)
    m.fit(df)
    assert m.nusers == nU and m.nitems == nI

    oracle = OracleHPF(k=k, **HP).init(nU, nI, seed, dtype)
    for _ in range(niter):
        oracle.full_step(y.astype(dtype), iu, ii)

    if tol is None:
        tol = 5e-3 if use_float else 1e-8
    np.testing.assert_allclose(m.Theta, oracle.Theta, rtol=tol, atol=tol,
                               err_msg=str((shape_kind, engine, shard_tables)))
    np.testing.assert_allclose(m.Beta, oracle.Beta, rtol=tol, atol=tol)


SWEEP = [
    # (shape, k, engine, shard_tables, use_float, force_tile)
    ("square", 7, "ell", False, True, False),
    ("square", 7, "ell", True, True, False),
    ("square", 7, "coo", False, True, False),
    ("single_user", 5, "ell", False, True, False),
    ("single_user", 5, "ell", True, True, False),
    ("single_item", 5, "ell", False, True, False),
    ("single_item", 5, "ell", True, False, False),
    ("degree_one", 6, "ell", False, True, False),
    ("degree_one", 6, "ell", True, True, False),
    ("degree_one", 6, "coo", False, False, False),
    ("id_gaps", 7, "ell", False, True, False),
    ("id_gaps", 7, "ell", True, True, False),
    ("id_gaps", 7, "coo", False, True, False),
    ("skewed", 9, "ell", False, False, False),
    ("skewed", 9, "ell", True, True, False),
    ("skewed", 1, "ell", False, True, False),   # k=1 degenerate softmax
    ("random", 33, "ell", False, True, False),  # k not a lane multiple
    ("random", 5, "ell", False, True, False),
    ("random", 5, "ell", True, True, False),
    ("random", 5, "coo", False, True, False),
    ("random", 5, "ell", False, False, False),
    # forced column tiling at toy scale (chunk-local cols + split rows)
    ("skewed", 6, "ell", False, True, True),
    ("id_gaps", 6, "ell", False, True, True),
    ("random", 6, "ell", False, True, True),
]


@pytest.mark.parametrize("shape_kind,k,engine,shard_tables,use_float,force_tile",
                         SWEEP)
def test_parity_sweep(shape_kind, k, engine, shard_tables, use_float,
                      force_tile, monkeypatch):
    import zlib

    # stable across processes (hash() is salted per interpreter, which
    # would make a failing config unreproducible)
    seed = zlib.crc32(repr((shape_kind, k, engine, shard_tables))
                      .encode()) % 1000 + 1
    _run_config(shape_kind, k, engine, shard_tables, use_float, seed,
                force_tile=force_tile, monkeypatch=monkeypatch)


def test_parity_bf16_gather(monkeypatch):
    """Forced bfloat16 gather tables stay within bf16 tolerance of the
    oracle (the arithmetic is f32; only the gathered tables are bf16)."""
    _run_config("skewed", 6, "ell", False, True, 11, niter=2,
                gather_dtype="bfloat16", tol=0.06, monkeypatch=monkeypatch)
