"""Verbose-output format parity with the reference
(``hpfrec/__init__.py:1448-1458``, ``cython_loops.pxi:828-847``)."""

import re

import numpy as np
import pandas as pd

from oracle import synth_counts


def _fit_capture(capsys, **kw):
    from hpfrec_jax import HPF

    y, iu, ii = synth_counts(50, 40, nnz=700, seed=1)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    m = HPF(k=5, random_seed=1, verbose=True, **kw)
    m.fit(df)
    return capsys.readouterr().out


def test_banner_and_data_info(capsys):
    out = _fit_capture(capsys, maxiter=4, check_every=2, stop_crit="maxiter")
    assert "**********************************" in out
    assert "Hierarchical Poisson Factorization" in out
    assert "Number of users: 50" in out
    assert "Number of items: 40" in out
    assert "Latent factors to use: 5" in out
    assert "Initializing parameters..." in out
    assert "Initializing optimization procedure..." in out


def test_llk_iteration_lines(capsys):
    out = _fit_capture(capsys, maxiter=6, check_every=2, stop_crit="train-llk")
    lines = re.findall(r"Iteration (\d+) \| train llk: (-?\d+) \| train rmse: (\d+\.\d{4})", out)
    assert len(lines) >= 2
    assert lines[0][0] == "2"


def test_diff_norm_lines(capsys):
    out = _fit_capture(capsys, maxiter=6, check_every=2, stop_crit="diff-norm",
                       stop_thr=1e-9)
    assert re.search(r"Iteration 2 \| Norm\(Theta_\{2\} - Theta_\{0\}\): \d+\.\d{5}", out)


def test_final_message(capsys):
    out = _fit_capture(capsys, maxiter=4, check_every=2, stop_crit="maxiter")
    assert "Optimization finished" in out
    assert re.search(r"Final log-likelihood: -?\d+", out)
    assert re.search(r"Final RMSE: \d+\.\d{4}", out)
    assert re.search(r"Minutes taken \(optimization part\): \d+\.\d", out)
