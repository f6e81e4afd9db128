"""Table-sharded (model-parallel) engine vs the replicated single-device
engine, on the 8-device virtual mesh."""

import numpy as np
import pytest

from oracle import synth_counts


def _csr(y, rows, cols, n):
    from scipy.sparse import coo_array

    X = coo_array((y, (rows, cols)), shape=(n, int(cols.max()) + 1)).tocsr()
    return X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data.astype(np.float32)


def test_table_sharded_step_matches_replicated():
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.table_sharded import (build_sharded_ell,
                                                   make_table_sharded_step,
                                                   pad_state,
                                                   plan_table_sharding)

    assert len(jax.devices()) == 8
    nU, nI, k = 83, 45, 6  # deliberately not multiples of 8
    y, iu, ii = synth_counts(nU, nI, nnz=1100, seed=5)
    hp = Hyperparams(k=k)
    state0 = initialize_state(nU, nI, hp, 31)

    # reference: replicated single-device ELL, 3 iterations
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    lu = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=32))
    li = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=32))
    ref = state0
    for _ in range(3):
        ref = cavi_step_ell(ref, lu, li, hp)

    # table-sharded: pad rows per the ring-tiling plan
    mesh = make_mesh()
    plan_u = plan_table_sharding(nU, k, 8)
    plan_i = plan_table_sharding(nI, k, 8)
    nU_p, nI_p = plan_u[0], plan_i[0]
    ip_u = np.concatenate([indptr_u, np.full(nU_p - nU, indptr_u[-1])])
    ip_i = np.concatenate([indptr_i, np.full(nI_p - nI, indptr_i[-1])])
    se_u = build_sharded_ell(ip_u, ind_u, dat_u, nU_p, 8,
                             opp_plan=(plan_i[0], plan_i[2], plan_i[3]),
                             max_width=32)
    se_i = build_sharded_ell(ip_i, ind_i, dat_i, nI_p, 8,
                             opp_plan=(plan_u[0], plan_u[2], plan_u[3]),
                             max_width=32)
    run = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI)

    padded = pad_state(state0, nU_p, nI_p)
    out = run(padded, jnp.asarray(3, jnp.int32))

    np.testing.assert_allclose(np.asarray(out.G_shp)[:nU], np.asarray(ref.G_shp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.L_shp)[:nI], np.asarray(ref.L_shp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.G_rte)[:nU], np.asarray(ref.G_rte),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.L_rte)[:nI], np.asarray(ref.L_rte),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.k_rte)[:nU], np.asarray(ref.k_rte),
                               rtol=1e-5, atol=1e-6)


def test_hpf_fit_shard_tables_matches_single_device():
    """HPF.fit(shard_tables=True) on the 8-device mesh == plain fit."""
    import pandas as pd

    import jax

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh

    y, iu, ii = synth_counts(83, 45, nnz=1000, seed=6)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    m1 = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
             random_seed=4, verbose=False, mesh=make_mesh(jax.devices()[:1]))
    m1.fit(df.copy())
    mt = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
             random_seed=4, verbose=False, mesh=make_mesh(), shard_tables=True)
    mt.fit(df.copy())

    np.testing.assert_allclose(mt.Theta, m1.Theta, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(mt.Beta, m1.Beta, rtol=1e-4, atol=1e-6)
    assert mt.Theta.shape == m1.Theta.shape  # padding sliced off


def test_table_sharded_with_split_rows():
    """Degree outliers split across segments still sum correctly when
    sharded (max_width smaller than the head item's degree)."""
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.table_sharded import (build_sharded_ell,
                                                   make_table_sharded_step,
                                                   pad_state,
                                                   plan_table_sharding)

    rng = np.random.default_rng(0)
    nU, nI, k = 64, 16, 5
    # item 0 is a catalog head: almost every user interacts with it
    iu = np.concatenate([np.arange(nU), rng.integers(0, nU, 300)]).astype(np.int32)
    ii = np.concatenate([np.zeros(nU, np.int32),
                         rng.integers(1, nI, 300).astype(np.int32)])
    key = iu.astype(np.int64) * nI + ii
    uniq = np.unique(key)
    iu = (uniq // nI).astype(np.int32)
    ii = (uniq % nI).astype(np.int32)
    y = (rng.poisson(2, len(uniq)) + 1).astype(np.float32)
    order = np.argsort(iu, kind="stable")
    iu, ii, y = iu[order], ii[order], y[order]

    hp = Hyperparams(k=k)
    state0 = initialize_state(nU, nI, hp, 3)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)

    lu = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=16))
    li = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=16))
    ref = cavi_step_ell(state0, lu, li, hp)

    mesh = make_mesh()
    plan_u = plan_table_sharding(nU, k, 8)
    plan_i = plan_table_sharding(nI, k, 8)
    se_u = build_sharded_ell(indptr_u, ind_u, dat_u, nU, 8,
                             opp_plan=(plan_i[0], plan_i[2], plan_i[3]),
                             max_width=16)
    se_i = build_sharded_ell(indptr_i, ind_i, dat_i, nI, 8,
                             opp_plan=(plan_u[0], plan_u[2], plan_u[3]),
                             max_width=16)
    run = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI)
    out = run(pad_state(state0, nU, nI), jnp.asarray(1, jnp.int32))

    np.testing.assert_allclose(np.asarray(out.L_shp), np.asarray(ref.L_shp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.G_shp), np.asarray(ref.G_shp),
                               rtol=1e-5, atol=1e-6)


def test_table_sharded_sub_tiled_ring():
    """Force multiple sub-tiles per shard (n_sub > 1) so the within-shard
    static-slice path of the ring runs, and check parity."""
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.table_sharded import (build_sharded_ell,
                                                   make_table_sharded_step,
                                                   pad_state)

    nU, nI, k = 83, 45, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1100, seed=5)
    hp = Hyperparams(k=k)
    state0 = initialize_state(nU, nI, hp, 31)

    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    lu = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=32))
    li = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=32))
    ref = cavi_step_ell(cavi_step_ell(state0, lu, li, hp), lu, li, hp)

    # hand-build plans with 3 sub-tiles per shard on each side
    mesh = make_mesh()
    per_u = 3 * 4          # n_sub=3, chunk=4 -> per=12, padded 96 >= 83
    per_i = 3 * 2          # n_sub=3, chunk=2 -> per=6, padded 48 >= 45
    nU_p, nI_p = per_u * 8, per_i * 8
    ip_u = np.concatenate([indptr_u, np.full(nU_p - nU, indptr_u[-1])])
    ip_i = np.concatenate([indptr_i, np.full(nI_p - nI, indptr_i[-1])])
    se_u = build_sharded_ell(ip_u, ind_u, dat_u, nU_p, 8,
                             opp_plan=(nI_p, 3, 2), max_width=32)
    se_i = build_sharded_ell(ip_i, ind_i, dat_i, nI_p, 8,
                             opp_plan=(nU_p, 3, 4), max_width=32)
    assert any(m[0] > 0 for m in se_u.bucket_meta)   # ring actually used
    assert len({m[1:] for m in se_u.bucket_meta}) > 1  # sub-tiles used
    run = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI)
    out = run(pad_state(state0, nU_p, nI_p), jnp.asarray(2, jnp.int32))

    np.testing.assert_allclose(np.asarray(out.G_shp)[:nU], np.asarray(ref.G_shp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.L_shp)[:nI], np.asarray(ref.L_shp),
                               rtol=1e-5, atol=1e-6)


def test_table_sharded_bf16_ring_close_to_f32():
    """bfloat16 exchange/gather tables on the ring stay close to the f32
    table-sharded result (same contract as the data-parallel engine's
    gather_dtype)."""
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.table_sharded import (build_sharded_ell,
                                                   make_table_sharded_step,
                                                   pad_state,
                                                   plan_table_sharding)

    nU, nI, k = 83, 45, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1100, seed=5)
    hp = Hyperparams(k=k)
    state0 = initialize_state(nU, nI, hp, 31)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)

    mesh = make_mesh()
    plan_u = plan_table_sharding(nU, k, 8)
    plan_i = plan_table_sharding(nI, k, 8)
    nU_p, nI_p = plan_u[0], plan_i[0]
    ip_u = np.concatenate([indptr_u, np.full(nU_p - nU, indptr_u[-1])])
    ip_i = np.concatenate([indptr_i, np.full(nI_p - nI, indptr_i[-1])])
    se_u = build_sharded_ell(ip_u, ind_u, dat_u, nU_p, 8,
                             opp_plan=(plan_i[0], plan_i[2], plan_i[3]))
    se_i = build_sharded_ell(ip_i, ind_i, dat_i, nI_p, 8,
                             opp_plan=(plan_u[0], plan_u[2], plan_u[3]))
    run_f32 = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI)
    run_bf16 = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI,
                                       gather_dtype=jnp.bfloat16)
    padded = pad_state(state0, nU_p, nI_p)
    o32 = run_f32(padded, jnp.asarray(2, jnp.int32))
    o16 = run_bf16(padded, jnp.asarray(2, jnp.int32))
    np.testing.assert_allclose(np.asarray(o16.G_shp), np.asarray(o32.G_shp),
                               rtol=0.05, atol=1e-3)
    np.testing.assert_allclose(np.asarray(o16.L_shp), np.asarray(o32.L_shp),
                               rtol=0.05, atol=1e-3)


def test_degree_balanced_rows_parity_and_balance(monkeypatch):
    """Round-2 verdict item 3: the degree-snake row assignment must (a) not
    change the fitted result vs the contiguous layout, and (b) even out
    per-device nonzero load on skewed data."""
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.table_sharded import plan_balanced_rows

    nU, nI = 120, 60
    rng = np.random.default_rng(3)
    iu = rng.integers(0, nU, 2500)
    # Zipf-ish items: head ids take most of the mass (the skew the snake fixes)
    p = 1.0 / np.arange(1, nI + 1)
    ii = rng.choice(nI, size=2500, p=p / p.sum())
    y = rng.poisson(2.0, 2500) + 1.0
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    def fit(balance):
        monkeypatch.setenv("HPFREC_TABLE_BALANCE", "1" if balance else "0")
        m = HPF(k=5, maxiter=8, check_every=4, stop_crit="train-llk",
                stop_thr=1e-12, random_seed=9, verbose=False,
                mesh=make_mesh(), shard_tables=True)
        m.fit(df.copy())
        return m

    m_bal, m_contig = fit(True), fit(False)
    np.testing.assert_allclose(m_bal.Theta, m_contig.Theta, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(m_bal.Beta, m_contig.Beta, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(m_bal.train_llk, m_contig.train_llk, rtol=1e-5)

    # the snake's load balance on a skewed degree profile
    deg = np.bincount(ii, minlength=nI).astype(np.int64)
    ndev, n_pad = 4, 64
    perm = plan_balanced_rows(deg, n_pad, ndev)
    assert sorted(perm.tolist()) == list(range(n_pad))
    deg_pad = np.concatenate([deg, np.zeros(n_pad - nI, np.int64)])
    loads = deg_pad[perm].reshape(ndev, -1).sum(axis=1)
    contig = deg_pad.reshape(ndev, -1).sum(axis=1)
    assert loads.max() - loads.min() <= max(int(deg.max()), 1)
    assert (loads.max() / max(loads.min(), 1)) < (contig.max() / max(contig.min(), 1))


@pytest.mark.parametrize("nU,nI", [(64, 40), (120, 64), (16, 9), (64, 64)])
def test_table_sharded_divisibility_edges(nU, nI):
    """Shapes where one or both sides divide the mesh exactly (no padding)
    or are tiny: the engine-space detection bug found in round 3 only
    triggered on such shapes."""
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh

    rng = np.random.default_rng(nU + nI)
    n = 30 * max(nU, nI)
    df = pd.DataFrame({"UserId": rng.integers(0, nU, n),
                       "ItemId": rng.integers(0, nI, n),
                       "Count": rng.poisson(2.0, n) + 1.0}
                      ).drop_duplicates(["UserId", "ItemId"])
    ref = HPF(k=4, maxiter=6, check_every=3, stop_crit="train-llk",
              stop_thr=1e-12, random_seed=2, verbose=False)
    ref.fit(df.copy())
    m = HPF(k=4, maxiter=6, check_every=3, stop_crit="train-llk",
            stop_thr=1e-12, random_seed=2, verbose=False,
            mesh=make_mesh(), shard_tables=True)
    m.fit(df.copy())
    assert m.Theta.shape == ref.Theta.shape
    assert m.Beta.shape == ref.Beta.shape
    np.testing.assert_allclose(m.Theta, ref.Theta, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(m.Beta, ref.Beta, rtol=1e-4, atol=1e-6)
