"""Checkpoint/resume and whole-model save/load tests (SURVEY.md §5)."""

import numpy as np
import pandas as pd

from oracle import synth_counts


def _df(seed=2, nU=60, nI=40):
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


def test_full_batch_checkpoint_resume(tmp_path):
    from hpfrec_jax import HPF

    df = _df()
    ck = str(tmp_path / "ck")

    # straight 20-iteration run
    m_full = HPF(k=6, maxiter=20, check_every=5, stop_crit="maxiter",
                 random_seed=44, verbose=False)
    m_full.fit(df.copy())

    # 10 iterations with checkpointing, then resume to 20
    m_a = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
              random_seed=44, verbose=False,
              checkpoint_folder=ck, checkpoint_every=5)
    m_a.fit(df.copy())
    m_b = HPF(k=6, maxiter=20, check_every=5, stop_crit="maxiter",
              random_seed=44, verbose=False,
              checkpoint_folder=ck, checkpoint_every=5)
    m_b.fit(df.copy(), resume=True)

    np.testing.assert_allclose(m_b.Theta, m_full.Theta, rtol=1e-6)
    np.testing.assert_allclose(m_b.Beta, m_full.Beta, rtol=1e-6)


def test_svi_checkpoint_resume(tmp_path):
    from hpfrec_jax import HPF

    df = _df()
    ck = str(tmp_path / "ck")

    m_full = HPF(k=6, maxiter=6, check_every=3, stop_crit="maxiter",
                 users_per_batch=16, random_seed=44, verbose=False)
    m_full.fit(df.copy())

    m_a = HPF(k=6, maxiter=3, check_every=3, stop_crit="maxiter",
              users_per_batch=16, random_seed=44, verbose=False,
              checkpoint_folder=ck, checkpoint_every=3)
    m_a.fit(df.copy())
    m_b = HPF(k=6, maxiter=6, check_every=3, stop_crit="maxiter",
              users_per_batch=16, random_seed=44, verbose=False,
              checkpoint_folder=ck, checkpoint_every=3)
    m_b.fit(df.copy(), resume=True)

    # resumed run must replay the same shuffle stream -> identical result
    np.testing.assert_allclose(m_b.Theta, m_full.Theta, rtol=1e-5)


def test_table_sharded_checkpoint_resume(tmp_path):
    """Regression (round-2 verdict): table-sharded fits train on a PADDED
    state; checkpoints must store the real-row slice so resume validates
    and continues.  The resumed run must match an uninterrupted one."""
    import jax

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh()
    # 83 x 45: deliberately not divisible by 8 so padding is exercised
    df = _df(seed=7, nU=83, nI=45)
    ck = str(tmp_path / "ck")

    m_full = HPF(k=6, maxiter=20, check_every=5, stop_crit="maxiter",
                 random_seed=44, verbose=False, mesh=mesh, shard_tables=True)
    m_full.fit(df.copy())

    m_a = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
              random_seed=44, verbose=False, mesh=mesh, shard_tables=True,
              checkpoint_folder=ck, checkpoint_every=5)
    m_a.fit(df.copy())
    # the checkpoint on disk must already be real-shaped
    from hpfrec_jax.utils import io as io_utils

    ck_state, _, _ = io_utils.load_checkpoint(ck)
    assert ck_state.G_shp.shape == (m_a.nusers, 6)
    assert ck_state.L_shp.shape == (m_a.nitems, 6)

    m_b = HPF(k=6, maxiter=20, check_every=5, stop_crit="maxiter",
              random_seed=44, verbose=False, mesh=mesh, shard_tables=True,
              checkpoint_folder=ck, checkpoint_every=5)
    m_b.fit(df.copy(), resume=True)

    np.testing.assert_allclose(m_b.Theta, m_full.Theta, rtol=1e-5)
    np.testing.assert_allclose(m_b.Beta, m_full.Beta, rtol=1e-5)


def test_resume_without_checkpoint_raises(tmp_path):
    from hpfrec_jax import HPF

    m = HPF(k=4, maxiter=4, check_every=4, verbose=False,
            checkpoint_folder=str(tmp_path / "none"))
    try:
        m.fit(_df(), resume=True)
        raise AssertionError("should have raised")
    except ValueError as e:
        assert "no checkpoint" in str(e)


def test_model_save_load_roundtrip(tmp_path):
    from hpfrec_jax import HPF

    df = _df()
    m = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
            random_seed=44, verbose=False)
    m.fit(df.copy())
    path = str(tmp_path / "model")
    m.save(path)
    m2 = HPF.load(path)

    np.testing.assert_array_equal(m.Theta, m2.Theta)
    np.testing.assert_array_equal(m.Beta, m2.Beta)
    assert m2.is_fitted
    assert m2.nusers == m.nusers

    u0 = df["UserId"].iloc[0]
    np.testing.assert_array_equal(m.topN(user=u0, n=5), m2.topN(user=u0, n=5))
    assert m.predict(user=u0, item=df["ItemId"].iloc[0]) == \
        m2.predict(user=u0, item=df["ItemId"].iloc[0])

    # loaded model supports continued updates (keep_all_objs round-trips)
    hist = df.loc[df["UserId"] == u0, ["ItemId", "Count"]]
    theta = m2.predict_factors(hist.copy())
    assert np.isfinite(theta).all()
