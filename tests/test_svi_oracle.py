"""SVI / partial_fit / fold-in updates vs the numpy oracle."""

import numpy as np
import pytest

from oracle import OracleHPF, synth_counts


def _mk(dtype=np.float64, k=6, seed=11):
    import jax

    from hpfrec_jax.models.state import Hyperparams, initialize_state

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    nU, nI = 50, 35
    y, iu, ii = synth_counts(nU, nI, nnz=700, seed=2, dtype=dtype)
    hp = Hyperparams(k=k)
    state = initialize_state(nU, nI, hp, seed, dtype)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, dtype)
    return state, oracle, (y, iu, ii), hp, nU, nI


def _pad_batch(y, iu, ii, dtype):
    P = ((max(len(y), 1) + 7) // 8) * 8
    y_p = np.zeros(P, dtype=dtype)
    iu_p = np.zeros(P, dtype=np.int32)
    ii_p = np.zeros(P, dtype=np.int32)
    y_p[:len(y)] = y
    iu_p[:len(y)] = iu
    ii_p[:len(y)] = ii
    return y_p, iu_p, ii_p


@pytest.mark.parametrize("user_side", [True, False])
@pytest.mark.parametrize("blend_all", [True, False])
def test_svi_batch_matches_oracle(user_side, blend_all):
    import jax.numpy as jnp

    from hpfrec_jax.ops.svi import build_row_mask, svi_batch_update

    dtype = np.float64
    state, oracle, (y, iu, ii), hp, nU, nI = _mk(dtype)
    # batch = users [3, 7, 20] (or items [2, 9] for item-side)
    if user_side:
        rows = np.array([3, 7, 20])
        sel = np.isin(iu, rows)
    else:
        rows = np.array([2, 9, 14])
        sel = np.isin(ii, rows)
    yb, iub, iib = y[sel], iu[sel], ii[sel]
    users_b = np.unique(iub) if not user_side else rows
    items_b = np.unique(iib) if user_side else rows
    step, mult = 0.4, 3.5

    y_p, iu_p, ii_p = _pad_batch(yb, iub, iib, dtype)
    umask = build_row_mask(nU, jnp.asarray(users_b.astype(np.int32)))
    imask = build_row_mask(nI, jnp.asarray(items_b.astype(np.int32)))
    new = svi_batch_update(
        state, jnp.asarray(y_p), jnp.asarray(iu_p), jnp.asarray(ii_p),
        umask, imask, jnp.asarray(step, dtype=dtype), jnp.asarray(mult, dtype=dtype),
        hp, user_side=user_side, blend_all_scalers=blend_all)

    if user_side:
        oracle.svi_user_batch(yb, iub, iib, users_b, items_b, step, mult, blend_all)
    else:
        oracle.svi_item_batch(yb, iub, iib, users_b, items_b, step, mult, blend_all)

    for ours, ref, name in [
        (new.G_shp, oracle.G_shp, "G_shp"), (new.G_rte, oracle.G_rte, "G_rte"),
        (new.L_shp, oracle.L_shp, "L_shp"), (new.L_rte, oracle.L_rte, "L_rte"),
        (new.k_rte, oracle.k_rte, "k_rte"), (new.t_rte, oracle.t_rte, "t_rte"),
    ]:
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_partial_fit_matches_oracle_user_batch():
    """HPF.partial_fit == oracle user-batch with blend-all-scalers."""
    import pandas as pd

    from hpfrec_jax import HPF

    dtype = np.float64
    nU, nI, k, seed = 50, 35, 6, 11
    y, iu, ii = synth_counts(nU, nI, nnz=700, seed=2, dtype=dtype)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, dtype)

    model = HPF(k=k, use_float=False, reindex=False, verbose=False,
                random_seed=seed, keep_data=False)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    rows = np.unique(iu)[:10]
    sel = np.isin(iu, rows)
    batch = df.loc[sel]

    model.partial_fit(batch, batch_type="users", step_size=0.5, nusers=nU, nitems=nI)

    users_b = rows
    items_b = np.unique(ii[sel])
    mult = float(nU) / len(users_b)
    oracle.svi_user_batch(y[sel], iu[sel], ii[sel], users_b, items_b, 0.5, mult,
                          blend_all_scalers=True)

    np.testing.assert_allclose(model.Gamma_shp, oracle.G_shp, rtol=1e-10)
    np.testing.assert_allclose(model.Lambda_shp, oracle.L_shp, rtol=1e-10)
    np.testing.assert_allclose(model.k_rte, oracle.k_rte, rtol=1e-10)
    np.testing.assert_allclose(model.Theta, oracle.Theta, rtol=1e-10)


def test_user_factors_matches_oracle_loop():
    """Fold-in loop vs a hand-rolled numpy loop with frozen item params."""
    from scipy.special import digamma

    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams
    from hpfrec_jax.ops.svi import user_factors_loop

    import jax

    jax.config.update("jax_enable_x64", True)
    dtype = np.float64
    k = 6
    rng = np.random.default_rng(0)
    nI = 30
    L_shp = 0.3 + rng.random((nI, k))
    L_rte = 0.3 + rng.random((nI, k))
    Beta = L_shp / L_rte
    ix_i = rng.choice(nI, size=12, replace=False)
    y = (rng.poisson(2, 12) + 1).astype(dtype)

    hp = Hyperparams(k=k)
    Theta0 = rng.gamma(hp.a, 1 / hp.b_prime, size=k)
    k_rte0 = hp.b_prime + Theta0.sum()
    G_rte0 = rng.gamma(hp.a_prime, hp.b_prime / hp.a_prime, size=1) + Beta.sum(axis=0)
    G_shp0 = G_rte0 * Theta0 * rng.uniform(0.85, 1.15, size=k)

    elogb = digamma(L_shp[ix_i]) - np.log(L_rte[ix_i])
    bcs = Beta.sum(axis=0)

    # numpy oracle loop
    Gs, Gr, kr, Th = G_shp0.copy(), G_rte0.copy(), k_rte0, Theta0.copy()
    niter = 0
    for it in range(30):
        logits = (digamma(Gs) - np.log(Gr))[None, :] + elogb
        m = logits.max(axis=1, keepdims=True)
        e = np.exp(logits - m)
        phi = y[:, None] * e / e.sum(axis=1, keepdims=True)
        Gr = hp.k_shp / kr + bcs
        Gs = hp.a + phi.sum(axis=0)
        Th_new = Gs / Gr
        kr = hp.add_k_rte + Th_new.sum()
        niter = it + 1
        if np.linalg.norm(Th_new - Th) < 1e-6:
            Th = Th_new
            break
        Th = Th_new

    P = 16
    y_p = np.zeros(P); y_p[:12] = y
    e_p = np.zeros((P, k)); e_p[:12] = elogb
    Theta, G_shp, G_rte, phi_norm, i = user_factors_loop(
        jnp.asarray(y_p), jnp.asarray(e_p), jnp.asarray(bcs),
        jnp.asarray(Theta0), jnp.asarray(G_shp0), jnp.asarray(G_rte0),
        jnp.asarray(np.float64(k_rte0)), hp, 30, jnp.asarray(1e-6))

    np.testing.assert_allclose(np.asarray(Theta), Th, rtol=1e-9)
    assert int(i) == niter


def test_partial_fit_empty_items_in_batch_blends_nothing():
    """A caller-supplied EMPTY items_in_batch must blend no item rows
    (oracle: items_b = []).  Regression for the round-4 mask bucketing,
    whose padding could otherwise mark row 0 as in-batch."""
    import pandas as pd

    from hpfrec_jax import HPF

    dtype = np.float64
    nU, nI, k, seed = 40, 30, 5, 7
    y, iu, ii = synth_counts(nU, nI, nnz=500, seed=4, dtype=dtype)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, dtype)

    model = HPF(k=k, use_float=False, reindex=False, verbose=False,
                random_seed=seed, keep_data=False)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    rows = np.unique(iu)[:8]
    sel = np.isin(iu, rows)
    batch = df.loc[sel]

    model.partial_fit(batch, batch_type="users", step_size=0.5,
                      nusers=nU, nitems=nI,
                      items_in_batch=np.array([], dtype=np.int64))

    mult = float(nU) / len(rows)
    oracle.svi_user_batch(y[sel], iu[sel], ii[sel], rows,
                          np.array([], dtype=np.int64), 0.5, mult,
                          blend_all_scalers=True)

    np.testing.assert_allclose(model.Lambda_shp, oracle.L_shp, rtol=1e-10)
    np.testing.assert_allclose(model.Lambda_rte, oracle.L_rte, rtol=1e-10)
    np.testing.assert_allclose(model.Gamma_shp, oracle.G_shp, rtol=1e-10)
