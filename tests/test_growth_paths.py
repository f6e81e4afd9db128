"""Model-growth API corners (round-1 verdict item 6): the
``partial_fit(new_users=/new_items=)`` row-growth arithmetic
(reference ``hpfrec/__init__.py:888-963``), ``add_user(update_all_params=
True)`` (``:1130-1141``), and the OpenMP-absent ``ncores>1`` warning
(``:251-256``)."""

import numpy as np
import pandas as pd
import pytest

from oracle import synth_counts


def _make_df(nU, nI, nnz, seed):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


def _base_model(**kw):
    from hpfrec_jax import HPF

    kw.setdefault("k", 5)
    kw.setdefault("verbose", False)
    kw.setdefault("random_seed", 11)
    kw.setdefault("reindex", False)
    kw.setdefault("keep_data", False)
    kw.setdefault("maxiter", 4)
    kw.setdefault("check_every", 2)
    kw.setdefault("stop_crit", "maxiter")
    return HPF(**kw)


def test_partial_fit_new_users_growth_arithmetic():
    """Reference formula (``__init__.py:891-895``): nusers_add =
    self.nusers - (max batch user id + 1); the appended rows are
    prime + 0.01*default_rng(seed) draws with the scaler rate at its
    prior (``:933-946``), and rows not in the batch keep that exact
    initialization through the update."""
    nU, nI, k = 50, 20, 5
    m = _base_model(k=k)
    df = _make_df(nU, nI, 600, seed=1)
    m.fit(df)

    # batch covers users 0..46 only -> nusers_now = 47, add = 3
    batch = df[df.UserId <= 46]
    assert int(batch.UserId.max()) == 46
    beta_before = m.Beta.copy()
    m.partial_fit(batch, new_users=True, random_seed=7)

    assert m.nusers == 53
    assert m.Theta.shape == (53, k)
    assert m.Gamma_shp.shape == (53, k)
    assert m.k_rte.shape == (53, 1)

    # oracle: the exact draw sequence of the reference's
    # _initialize_extra_users; Gamma_shp is updated for batch users only,
    # so the appended rows keep the initialization bit-exact
    rng = np.random.default_rng(7)
    exp_shp = (m.a_prime + 0.01 * rng.random(size=(3, k), dtype=np.float32))
    np.testing.assert_array_equal(m.Gamma_shp[50:], exp_shp)
    # the update then recomputes Gamma_rte and Theta over ALL rows
    # (reference ``pxi:443, 464``): new rows' rate is the prior term
    # k_shp/b_prime plus the pre-update Beta column sums
    k_shp = m.a_prime + k * m.a
    exp_rte = k_shp / m.b_prime + beta_before.sum(axis=0, keepdims=True)
    np.testing.assert_allclose(m.Gamma_rte[50:],
                               np.broadcast_to(exp_rte, (3, k)), rtol=1e-5)
    np.testing.assert_allclose(m.Theta[50:], exp_shp / exp_rte, rtol=1e-5)


def test_partial_fit_new_items_growth_arithmetic():
    nU, nI, k = 30, 40, 5
    m = _base_model(k=k)
    df = _make_df(nU, nI, 500, seed=2)
    m.fit(df)

    batch = df[df.ItemId <= 37]
    assert int(batch.ItemId.max()) == 37
    m.partial_fit(batch, new_items=True, random_seed=9)

    assert m.nitems == 42
    assert m.Beta.shape == (42, k)
    rng = np.random.default_rng(9)
    exp_shp = (m.c_prime + 0.01 * rng.random(size=(2, k), dtype=np.float32))
    np.testing.assert_array_equal(m.Lambda_shp[40:], exp_shp)


def test_partial_fit_new_users_no_growth_raises():
    m = _base_model()
    df = _make_df(50, 20, 600, seed=1)
    m.fit(df)
    with pytest.raises(ValueError, match="no new users"):
        m.partial_fit(df, new_users=True)  # max id + 1 == nusers -> add 0


def test_add_user_update_all_params_existing():
    """``add_user(update_all_params=True, update_existing=True)`` loops
    ``partial_fit`` on the single-user batch (reference ``:1130-1141``) —
    item parameters move too, unlike the fold-in path."""
    nU, nI, k = 40, 25, 5
    m = _base_model(k=k)
    df = _make_df(nU, nI, 500, seed=3)
    m.fit(df)
    theta_before = m.Theta.copy()
    beta_before = m.Beta.copy()
    niter_before = m.niter

    new_counts = pd.DataFrame({"ItemId": np.arange(8),
                               "Count": np.arange(1.0, 9.0)})
    ok = m.add_user(user_id=3, counts_df=new_counts, update_existing=True,
                    update_all_params=True, maxiter=3)
    assert ok is True
    assert m.Theta.shape == (nU, k)           # no row growth
    assert not np.allclose(m.Theta[3], theta_before[3])
    assert not np.allclose(m.Beta, beta_before)  # global params blended
    assert m.niter > niter_before             # partial_fit steps counted


def test_add_user_update_all_params_new_user_quirk():
    """Reference quirk: for a brand-new id (== nusers) the inner
    ``partial_fit(new_users=True)`` computes nusers_add = nusers -
    (user_id + 1) <= 0 and raises — reproduced for behavioral parity."""
    m = _base_model()
    df = _make_df(40, 25, 500, seed=3)
    m.fit(df)
    new_counts = pd.DataFrame({"ItemId": np.arange(5),
                               "Count": np.ones(5)})
    with pytest.raises(ValueError, match="no new users"):
        m.add_user(user_id=40, counts_df=new_counts, update_existing=False,
                   update_all_params=True)


def test_ncores_warning_without_openmp(monkeypatch):
    """Reference parity (``__init__.py:251-256``): requesting ncores > 1
    warns when the native kernels lack OpenMP, and stays silent when they
    have it or when ncores == 1."""
    import warnings

    from hpfrec_jax import _native

    monkeypatch.setattr(_native, "get", lambda: 0)
    with pytest.warns(UserWarning, match="multi-threading"):
        _base_model(ncores=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _base_model(ncores=1)

    monkeypatch.setattr(_native, "get", lambda: 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _base_model(ncores=2)


def test_partial_fit_shards_over_mesh_matches_single_device():
    """Round-2 verdict item 8: the online-update path follows the SPMD
    story — ``partial_fit``'s phi segment sums shard over the active mesh
    and must match a single-device update."""
    import jax
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.mesh import DATA_AXIS

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    nU, nI = 40, 25
    df = _make_df(nU, nI, 300, seed=9)

    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), (DATA_AXIS,))
    m_single = _base_model(mesh=mesh1)
    m_single.partial_fit(df.copy(), nusers=nU, nitems=nI)
    m_single.partial_fit(df.copy())

    m_mesh = _base_model(mesh=make_mesh())
    m_mesh.partial_fit(df.copy(), nusers=nU, nitems=nI)
    m_mesh.partial_fit(df.copy())

    np.testing.assert_allclose(m_mesh.Theta, m_single.Theta, rtol=1e-5)
    np.testing.assert_allclose(m_mesh.Beta, m_single.Beta, rtol=1e-5)


def test_partial_fit_device_state_cache():
    """Repeated partial_fit reuses the device-resident state (no host
    re-upload) and every mutation path invalidates correctly: the
    results must be identical to a cache-free run, and add_user's
    in-place row edit must drop the cache explicitly."""
    df = _make_df(40, 30, 500, seed=2)
    m = _base_model(keep_data=True)
    m.fit(df)
    assert m._dev_state_cache is not None  # populated by fit

    batch = _make_df(40, 30, 120, seed=5)
    m.partial_fit(batch)
    cached_after_1 = m._dev_state_cache
    assert cached_after_1 is not None
    # untouched attrs -> the next call must REUSE the cached device state
    assert m._state_from_host() is cached_after_1[1]

    # reference run without any cache: same arithmetic
    m2 = _base_model(keep_data=True)
    m2.fit(df)
    m2._dev_state_cache = None
    m2.partial_fit(_make_df(40, 30, 120, seed=5))
    np.testing.assert_allclose(m.Gamma_shp, m2.Gamma_shp, rtol=1e-6)
    np.testing.assert_allclose(m.t_rte, m2.t_rte, rtol=1e-6)

    # user reassignment invalidates (identity change)
    m.Gamma_shp = m.Gamma_shp.copy()
    assert m._state_from_host() is not cached_after_1[1]

    # add_user's in-place row edit clears the cache explicitly
    hist = pd.DataFrame({"ItemId": np.arange(5), "Count": np.ones(5)})
    m.add_user(user_id=3, counts_df=hist, update_existing=True)
    assert m._dev_state_cache is None
