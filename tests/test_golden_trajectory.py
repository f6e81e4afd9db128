"""Golden-trajectory regression (SURVEY.md §4 plan (e), round-1 verdict
item 5): pins the seeded synthetic-config train-llk curve at every
``check_every`` to tight tolerance so that any numeric drift in the fused
kernels fails CI, and checks the curve SHAPE against the reference's
recorded MillionSong trajectory (``example/hpfrec_echonest.ipynb`` cell
10 / BASELINE.md: -611.6M @ it10 -> -504.4M @ it100 -> -503.9M @ it110 —
steep early improvement, <0.5% of the total improvement left in the last
check window)."""

import numpy as np
import pandas as pd

from oracle import synth_counts

# Recorded on the 8-device virtual CPU mesh (tests/conftest.py), k=8,
# seed=123, check_every=10, maxiter=60; bit-identical across repeat runs.
GOLDEN_LLK = np.array([-8613.189682, -6042.636433, -5696.673380,
                       -5607.851234, -5581.155046, -5571.343185])
GOLDEN_RMSE = np.array([4.090780, 3.699739, 3.647795,
                        3.633064, 3.627870, 3.625349])


def _fit_with_trajectory(monkeypatch):
    from hpfrec_jax import HPF

    y, iu, ii = synth_counts(120, 80, nnz=2000, seed=42)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    records = []
    orig = HPF._evaluate_criterion

    def rec(self, *a, **k):
        out = orig(self, *a, **k)
        records.append((self._last_llk, self._last_rmse))
        return out

    monkeypatch.setattr(HPF, "_evaluate_criterion", rec)
    m = HPF(k=8, maxiter=60, check_every=10, stop_crit='train-llk',
            stop_thr=1e-10, random_seed=123, verbose=False)
    m.fit(df)
    return np.array([r[0] for r in records]), np.array([r[1] for r in records])


def test_golden_llk_trajectory(monkeypatch):
    llk, rmse = _fit_with_trajectory(monkeypatch)
    assert llk.shape[0] == GOLDEN_LLK.shape[0]
    np.testing.assert_allclose(llk, GOLDEN_LLK, rtol=2e-6)
    np.testing.assert_allclose(rmse, GOLDEN_RMSE, rtol=2e-6)


def test_trajectory_shape_matches_reference_profile(monkeypatch):
    """Qualitative shape parity with the reference's recorded curve:
    monotone ascent with the first check window dominating and under 2%
    of the total improvement left in the last window (the reference's
    MillionSong run leaves 0.46%)."""
    llk, _ = _fit_with_trajectory(monkeypatch)
    deltas = np.diff(llk)
    assert np.all(deltas > 0), "CAVI train llk must ascend between checks"
    total = llk[-1] - llk[0]
    assert deltas[0] / total > 0.5          # early window dominates
    assert deltas[-1] / total < 0.02        # converged flattening
