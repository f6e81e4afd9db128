"""Bucketed-ELL scatter-free segment sums vs oracle, and full CAVI-step
equivalence with the scatter engine."""

import numpy as np
import pytest

from oracle import synth_counts


def _csr(y, iu, ii, nU):
    from scipy.sparse import coo_array

    X = coo_array((y, (iu, ii)), shape=(nU, int(ii.max()) + 1)).tocsr()
    return X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data


def test_ell_phi_sums_vs_oracle():
    import jax.numpy as jnp

    from hpfrec_jax.ops.ell import build_ell, device_ell, ell_phi_sums

    rng = np.random.default_rng(0)
    nU, nI, k = 200, 120, 9
    y, iu, ii = synth_counts(nU, nI, nnz=3000, seed=1)
    indptr, indices, data = _csr(y, iu, ii, nU)
    elogt = rng.random((nU, k)).astype(np.float32)
    elogb = rng.random((nI, k)).astype(np.float32)

    t_tab = np.exp(elogt - elogt.max(axis=1, keepdims=True))
    b_tab = np.exp(elogb - elogb.max(axis=1, keepdims=True))
    layout = device_ell(build_ell(indptr, indices, data, nU, max_width=32))
    out = np.asarray(ell_phi_sums(jnp.asarray(t_tab), jnp.asarray(b_tab), layout))

    logits = elogt[iu] + elogb[ii]
    m = logits.max(1, keepdims=True)
    e = np.exp(logits - m)
    phi = (y / e.sum(1))[:, None] * e
    ref = np.zeros((nU, k), np.float32)
    np.add.at(ref, iu, phi)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_carried_block_matches_stepwise():
    """run_cavi_block_ell (carried exp tables + Beta colsum, round 4)
    must follow the exact trajectory of repeated single steps — the
    carry holds values each iteration would otherwise re-derive, so the
    restructure is algebraically inert."""
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import (build_ell, cavi_step_ell, device_ell,
                                    run_cavi_block_ell)

    nU, nI, k = 90, 70, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1200, seed=9)
    hp = Hyperparams(k=k)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    lu = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=64))
    li = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=64))

    blocked = run_cavi_block_ell(initialize_state(nU, nI, hp, 5), lu, li,
                                 jnp.asarray(7, jnp.int32), hp)
    stepped = initialize_state(nU, nI, hp, 5)
    for _ in range(7):
        stepped = cavi_step_ell(stepped, lu, li, hp)
    for ours, ref in zip(blocked, stepped):
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_minirow_reshape_matches_native_widths():
    """The mini-row fast path ((c*w/8, 8) view of each /8-divisible
    bucket, round-5) must match the native-width computation — same
    slots, same math, only within-row summation reassociated."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.ell import build_ell, device_ell, ell_phi_sums

    rng = np.random.default_rng(4)
    nU, nI, k = 300, 150, 7
    y, iu, ii = synth_counts(nU, nI, nnz=6000, seed=2)
    indptr, indices, data = _csr(y, iu, ii, nU)
    elogt = rng.random((nU, k)).astype(np.float32)
    elogb = rng.random((nI, k)).astype(np.float32)
    t_tab = jnp.asarray(np.exp(elogt - elogt.max(axis=1, keepdims=True)))
    b_tab = jnp.asarray(np.exp(elogb - elogb.max(axis=1, keepdims=True)))
    for chunk in (None, 37):  # untiled and tiled layouts
        layout = device_ell(build_ell(indptr, indices, data, nU,
                                      max_width=64, col_chunk_rows=chunk,
                                      n_cols=nI))
        on = np.asarray(ell_phi_sums(t_tab, b_tab, layout, minirow=True))
        off = np.asarray(ell_phi_sums(t_tab, b_tab, layout, minirow=False))
        np.testing.assert_allclose(on, off, rtol=2e-5, atol=2e-5)


def test_interleaved_pair_matches_default_step():
    """ell_phi_sums_interleaved (both sides' op chains alternated under
    one shared dep chain — a scheduling variant, round-5 verdict item 4)
    computes identical values: per-bucket math and per-side concat order
    are unchanged, only op ordering differs."""
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import (build_ell, device_ell,
                                    ell_phi_sums_interleaved,
                                    run_cavi_block_ell)

    nU, nI, k = 90, 70, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1200, seed=9)
    hp = Hyperparams(k=k)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    # tiled layouts so the interleave walks per-(chunk, width) op lists
    lu = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=64,
                              col_chunk_rows=17, n_cols=nI))
    li = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=64,
                              col_chunk_rows=13, n_cols=nU))

    base = run_cavi_block_ell(initialize_state(nU, nI, hp, 5), lu, li,
                              jnp.asarray(5, jnp.int32), hp)
    inter = run_cavi_block_ell(initialize_state(nU, nI, hp, 5), lu, li,
                               jnp.asarray(5, jnp.int32), hp,
                               phi_pair_fn=ell_phi_sums_interleaved)
    for ours, ref in zip(inter, base):
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_sharded_ell_matches_single_device():
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.engine import (make_sharded_ell_phi_sums,
                                            shard_ell_layout)

    assert len(jax.devices()) == 8
    nU, nI, k = 80, 50, 7
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=3)
    hp = Hyperparams(k=k)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)

    lu1 = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=64))
    li1 = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=64))
    ref = cavi_step_ell(initialize_state(nU, nI, hp, 21), lu1, li1, hp)

    mesh = make_mesh()
    lu8 = shard_ell_layout(build_ell(indptr_u, ind_u, dat_u, nU, max_width=64,
                                     pad_shards=8), mesh)
    li8 = shard_ell_layout(build_ell(indptr_i, ind_i, dat_i, nI, max_width=64,
                                     pad_shards=8), mesh)
    fn_u = make_sharded_ell_phi_sums(mesh, len(lu8.buckets))
    fn_i = make_sharded_ell_phi_sums(mesh, len(li8.buckets))

    def phi_sums_fn(t_self, t_other, layout, side):
        return (fn_u if side == "user" else fn_i)(t_self, t_other, layout)

    out = jax.jit(lambda st: cavi_step_ell(st, lu8, li8, hp,
                                           phi_sums_fn=phi_sums_fn))(
        initialize_state(nU, nI, hp, 21))

    np.testing.assert_allclose(np.asarray(out.G_shp), np.asarray(ref.G_shp), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.L_shp), np.asarray(ref.L_shp), rtol=1e-6)


def test_hpf_fit_sharded_ell_matches_single_device():
    """HPF.fit on an 8-device mesh == single-device fit (full-batch ELL)."""
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh

    import jax

    y, iu, ii = synth_counts(60, 40, nnz=800, seed=9)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    m1 = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
             random_seed=3, verbose=False, mesh=make_mesh(jax.devices()[:1]))
    m1.fit(df.copy())
    m8 = HPF(k=6, maxiter=10, check_every=5, stop_crit="maxiter",
             random_seed=3, verbose=False, mesh=make_mesh())
    m8.fit(df.copy())
    np.testing.assert_allclose(m8.Theta, m1.Theta, rtol=1e-5)
    np.testing.assert_allclose(m8.Beta, m1.Beta, rtol=1e-5)


def test_cavi_step_ell_matches_scatter_engine():
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.cavi import BlockedCOO, cavi_step
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.utils.data import block_coo

    nU, nI, k = 80, 50, 7
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=3)
    hp = Hyperparams(k=k)
    state = initialize_state(nU, nI, hp, 21)

    blk = block_coo(y, iu, ii, block_size=256)
    data = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u), jnp.asarray(blk.ix_i))
    ref = cavi_step(state, data, hp)

    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    ell_u = device_ell(build_ell(indptr_u, ind_u, dat_u, nU, max_width=64))
    ell_i = device_ell(build_ell(indptr_i, ind_i, dat_i, nI, max_width=64))
    out = cavi_step_ell(state, ell_u, ell_i, hp)

    for a, b, name in [(out.G_shp, ref.G_shp, "G_shp"), (out.L_shp, ref.L_shp, "L_shp"),
                       (out.G_rte, ref.G_rte, "G_rte"), (out.L_rte, ref.L_rte, "L_rte"),
                       (out.k_rte, ref.k_rte, "k_rte"), (out.t_rte, ref.t_rte, "t_rte")]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_bf16_gather_tables_close_to_f32():
    """gather_dtype=bfloat16 (the large-table fast path) must track the
    float32 engine closely: tables are cast for the gather only, arithmetic
    promotes back to float32."""
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell

    nU, nI, k = 80, 50, 7
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=3)
    hp = Hyperparams(k=k)
    state = initialize_state(nU, nI, hp, 21)

    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)
    ell_u = device_ell(build_ell(indptr_u, ind_u, dat_u, nU))
    ell_i = device_ell(build_ell(indptr_i, ind_i, dat_i, nI))

    st32 = cavi_step_ell(state, ell_u, ell_i, hp)
    st16 = cavi_step_ell(state, ell_u, ell_i, hp, gather_dtype=jnp.bfloat16)
    assert st16.G_shp.dtype == st32.G_shp.dtype  # accumulation stays f32
    np.testing.assert_allclose(np.asarray(st16.G_shp), np.asarray(st32.G_shp),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(st16.L_shp), np.asarray(st32.L_shp),
                               rtol=2e-2, atol=2e-2)


def test_gather_table_dtype_policy():
    """'auto' gathers in float32 at every size (bfloat16 gathers measured
    8% faster on an H100, not enough to give up float32); bfloat16 only
    when asked for."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.ell import gather_table_dtype

    assert gather_table_dtype() is None
    assert gather_table_dtype("auto") is None
    assert gather_table_dtype("float32") is None
    assert gather_table_dtype("bfloat16") is jnp.bfloat16


def test_hpf_fit_forced_bf16_gather():
    import pandas as pd

    from hpfrec_jax import HPF

    y, iu, ii = synth_counts(60, 40, nnz=500, seed=9)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    m32 = HPF(k=5, maxiter=60, verbose=False, random_seed=4,
              gather_dtype="float32")
    m32.fit(df.copy())
    m16 = HPF(k=5, maxiter=60, verbose=False, random_seed=4,
              gather_dtype="bfloat16")
    m16.fit(df.copy())
    # individual factors are identifiable only up to rotation, and on tiny
    # data CAVI amplifies any perturbation into a different (equally good)
    # mode — so compare model QUALITY, not trajectories.  (At realistic
    # scale the llk agrees to about 1e-6 relative; see PERF.md.)
    p32 = np.asarray(m32.predict(iu, ii), dtype=np.float64)
    p16 = np.asarray(m16.predict(iu, ii), dtype=np.float64)
    np.testing.assert_allclose(p16.mean(), p32.mean(), rtol=5e-2)
    corr = np.corrcoef(p16, p32)[0, 1]
    assert corr > 0.9, corr
    l32 = m32.eval_llk(df.copy())["llk"]
    l16 = m16.eval_llk(df.copy())["llk"]
    assert abs(l16 - l32) / abs(l32) < 5e-2, (l16, l32)


def test_col_tiled_matches_untiled():
    """Column-tiled layout (forced tiny chunks) must reproduce the untiled
    phi sums: same math, different gather partitioning."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.ell import build_ell, device_ell, ell_phi_sums

    rng = np.random.default_rng(0)
    nU, nI, k = 200, 120, 9
    y, iu, ii = synth_counts(nU, nI, nnz=3000, seed=1)
    indptr, indices, data = _csr(y, iu, ii, nU)
    t_tab = jnp.asarray(rng.random((nU, k)).astype(np.float32) + 0.2)
    b_tab = jnp.asarray(rng.random((nI, k)).astype(np.float32) + 0.2)

    plain = device_ell(build_ell(indptr, indices, data, nU, max_width=32))
    ref = np.asarray(ell_phi_sums(t_tab, b_tab, plain))

    for chunk in (7, 16, 50, 119, 120, 1000):
        tiled = build_ell(indptr, indices, data, nU, max_width=32,
                          col_chunk_rows=chunk, n_cols=nI)
        assert tiled.col_spans is not None
        for span, b in zip(tiled.col_spans, tiled.buckets):
            lo, hi = span
            assert 0 <= lo < hi <= nI
            real = np.asarray(b.vals) != 0
            assert (np.asarray(b.cols)[real] < hi - lo).all()
        out = np.asarray(ell_phi_sums(t_tab, b_tab, device_ell(tiled)))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"chunk={chunk}")


def test_build_ell_native_sort_matches_numpy_fallback(monkeypatch):
    """The native in-row sort path and the numpy argsort fallback must
    produce byte-identical tiled layouts (same buckets, same positions),
    including duplicate (row, col) entries."""
    pytest.importorskip("hpfrec_jax._native")
    from hpfrec_jax import _native
    from hpfrec_jax.ops.ell import build_ell

    if not _native.available():
        pytest.skip("native toolchain unavailable")

    y, iu, ii = synth_counts(150, 90, nnz=2500, seed=3)
    ii[40:60] = ii[39]  # duplicates inside rows
    indptr, indices, data = _csr(y, iu, ii, 150)

    nat = build_ell(indptr, indices, data, 150, col_chunk_rows=17, n_cols=90)

    def boom(*a, **kw):
        raise RuntimeError("forced fallback")

    monkeypatch.setattr(_native, "sort_csr_cols", boom)
    fb = build_ell(indptr, indices, data, 150, col_chunk_rows=17, n_cols=90)

    assert len(nat.buckets) == len(fb.buckets)
    for bn, bf in zip(nat.buckets, fb.buckets):
        np.testing.assert_array_equal(bn.rows, bf.rows)
        np.testing.assert_array_equal(bn.cols, bf.cols)
        np.testing.assert_array_equal(bn.vals, bf.vals)
    np.testing.assert_array_equal(nat.inv_perm, fb.inv_perm)
    np.testing.assert_array_equal(nat.split_rows, fb.split_rows)
    assert len(nat.split_seg_pos) == len(fb.split_seg_pos)
    for ln, lf in zip(nat.split_seg_pos, fb.split_seg_pos):
        np.testing.assert_array_equal(ln, lf)
    assert nat.col_spans == fb.col_spans


def test_col_tiled_cavi_step_matches():
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell

    nU, nI, k = 80, 50, 7
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=3)
    hp = Hyperparams(k=k)
    state = initialize_state(nU, nI, hp, 21)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)

    ref = cavi_step_ell(
        state,
        device_ell(build_ell(indptr_u, ind_u, dat_u, nU)),
        device_ell(build_ell(indptr_i, ind_i, dat_i, nI)), hp)
    out = cavi_step_ell(
        state,
        device_ell(build_ell(indptr_u, ind_u, dat_u, nU,
                             col_chunk_rows=13, n_cols=nI)),
        device_ell(build_ell(indptr_i, ind_i, dat_i, nI,
                             col_chunk_rows=17, n_cols=nU)), hp)
    for a, b in [(out.G_shp, ref.G_shp), (out.L_shp, ref.L_shp),
                 (out.k_rte, ref.k_rte), (out.t_rte, ref.t_rte)]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_plan_col_tiling_policy(monkeypatch):
    """No table size turns column tiling on (untiled measured faster on an
    H100); with a threshold set, chunks stay within FAST_GATHER_BYTES."""
    import hpfrec_jax.ops.ell as ell_mod
    from hpfrec_jax.ops.ell import plan_col_tiling

    assert plan_col_tiling(100_000, 50) is None
    assert plan_col_tiling(1_019_318, 50) is None        # 204 MB: untiled
    assert plan_col_tiling(1_019_318, 50, 2) is None
    monkeypatch.setattr(ell_mod, "TILE_THRESHOLD_BYTES", 48 * 1024 * 1024)
    assert plan_col_tiling(100_000, 50) is None          # under threshold
    chunk = plan_col_tiling(1_019_318, 50)
    assert chunk * 50 * 4 <= ell_mod.FAST_GATHER_BYTES   # chunks fit
    # bf16 halves bytes: bigger chunks, and the 377K item table needs none
    assert plan_col_tiling(376_768, 50, 2) is None
    assert plan_col_tiling(1_019_318, 50, 2) == 2 * plan_col_tiling(1_019_318, 50)


def test_hpf_fit_tiled_path(monkeypatch):
    """Force the auto-tiling policy on at toy scale so the full HPF.fit
    pipeline (CSR -> tiled build_ell -> fused engine -> reassembly) runs
    through the tiled branch; result must match the untiled fit."""
    import pandas as pd

    import hpfrec_jax.ops.ell as ell_mod
    from hpfrec_jax import HPF

    y, iu, ii = synth_counts(60, 40, nnz=800, seed=2)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})

    m_plain = HPF(k=6, maxiter=12, verbose=False, random_seed=5)
    m_plain.fit(df.copy())

    monkeypatch.setattr(ell_mod, "TILE_THRESHOLD_BYTES", 200)
    monkeypatch.setattr(ell_mod, "FAST_GATHER_BYTES", 17 * 6 * 4)  # 17-row chunks
    m_tiled = HPF(k=6, maxiter=12, verbose=False, random_seed=5)
    m_tiled.fit(df.copy())

    np.testing.assert_allclose(m_tiled.Theta, m_plain.Theta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m_tiled.Beta, m_plain.Beta, rtol=1e-4, atol=1e-5)


def test_ell_metrics_match_blocked():
    """ell_train_llk_rmse (tiled and untiled) == blocked-COO train metrics."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.cavi import BlockedCOO
    from hpfrec_jax.ops.ell import build_ell, device_ell
    from hpfrec_jax.ops.metrics import ell_train_llk_rmse, train_llk_rmse
    from hpfrec_jax.utils.data import block_coo

    rng = np.random.default_rng(3)
    nU, nI, k = 150, 90, 8
    y, iu, ii = synth_counts(nU, nI, nnz=2500, seed=4)
    Theta = jnp.asarray(rng.random((nU, k)).astype(np.float32))
    Beta = jnp.asarray(rng.random((nI, k)).astype(np.float32))

    blk = block_coo(y, iu, ii, block_size=512)
    data = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u), jnp.asarray(blk.ix_i))
    ref_llk, ref_rmse = train_llk_rmse(Theta, Beta, data, len(y))

    indptr, indices, dat = _csr(y, iu, ii, nU)
    for chunk in (None, 23):
        lay = device_ell(build_ell(indptr, indices, dat, nU, max_width=32,
                                   col_chunk_rows=chunk,
                                   n_cols=nI if chunk else None))
        llk, rmse = ell_train_llk_rmse(Theta, Beta, lay, len(y))
        assert abs(llk - ref_llk) / abs(ref_llk) < 1e-5, (llk, ref_llk)
        assert abs(rmse - ref_rmse) / ref_rmse < 1e-5

    # full_llk variant too
    ref_llk2, _ = train_llk_rmse(Theta, Beta, data, len(y), full_llk=True)
    lay = device_ell(build_ell(indptr, indices, dat, nU, max_width=32))
    llk2, _ = ell_train_llk_rmse(Theta, Beta, lay, len(y), full_llk=True)
    assert abs(llk2 - ref_llk2) / abs(ref_llk2) < 1e-5


def test_sharded_tiled_ell_matches_single_device():
    """Column tiling + data-parallel sharding compose: the shard_map path
    must slice the replicated table per bucket span exactly like the
    single-device path."""
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, cavi_step_ell, device_ell
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.parallel.engine import (make_sharded_ell_phi_sums,
                                            shard_ell_layout)

    nU, nI, k = 80, 50, 7
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=3)
    hp = Hyperparams(k=k)
    indptr_u, ind_u, dat_u = _csr(y, iu, ii, nU)
    indptr_i, ind_i, dat_i = _csr(y, ii, iu, nI)

    ref = cavi_step_ell(
        initialize_state(nU, nI, hp, 21),
        device_ell(build_ell(indptr_u, ind_u, dat_u, nU)),
        device_ell(build_ell(indptr_i, ind_i, dat_i, nI)), hp)

    mesh = make_mesh()
    lu8 = shard_ell_layout(build_ell(indptr_u, ind_u, dat_u, nU, pad_shards=8,
                                     col_chunk_rows=13, n_cols=nI), mesh)
    li8 = shard_ell_layout(build_ell(indptr_i, ind_i, dat_i, nI, pad_shards=8,
                                     col_chunk_rows=17, n_cols=nU), mesh)
    assert lu8.col_spans is not None and li8.col_spans is not None
    fn_u = make_sharded_ell_phi_sums(mesh, len(lu8.buckets), col_spans=lu8.col_spans)
    fn_i = make_sharded_ell_phi_sums(mesh, len(li8.buckets), col_spans=li8.col_spans)

    def phi_sums_fn(t_self, t_other, layout, side):
        return (fn_u if side == "user" else fn_i)(t_self, t_other, layout)

    out = jax.jit(lambda st: cavi_step_ell(st, lu8, li8, hp,
                                           phi_sums_fn=phi_sums_fn))(
        initialize_state(nU, nI, hp, 21))

    np.testing.assert_allclose(np.asarray(out.G_shp), np.asarray(ref.G_shp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.L_shp), np.asarray(ref.L_shp),
                               rtol=1e-5, atol=1e-6)


def _square_coincident_ladder_data():
    """nU == nI == 128 with col chunks of 64 engineered so BOTH sides pack
    into 3 buckets with the SAME widths but DIFFERENT col-span sequences:
    user side {(c0,w8),(c0,w48),(c1,w8)} vs item side
    {(c0,w8),(c1,w8),(c1,w48)}.  The widths 8 and 48 within one chunk do
    not merge (48 > 4*8)."""
    rows, cols = [], []
    for u in range(64):                      # A users: 6 X-items each
        for j in range(6):
            rows.append(u); cols.append((u + j) % 64)
    for u in range(64, 128):                 # B users: 40 X-items + 2 Y-items
        for j in range(40):
            rows.append(u); cols.append(((u - 64) + j) % 64)
        base = 64 + ((u - 64) * 2) % 64
        rows += [u, u]; cols += [base, base + 1]
    iu = np.array(rows, np.int32)
    ii = np.array(cols, np.int32)
    y = (1.0 + (iu + ii) % 3).astype(np.float32)
    return y, iu, ii


def test_sharded_dispatch_square_coincident_buckets(monkeypatch):
    """Regression (round-1 verdict): with nusers == nitems and coincident
    bucket ladders but different col-span sequences, shape-based user/item
    dispatch handed the item layout the user-side col_spans -> wrong static
    slices, silently wrong results.  The explicit ``side`` flag threaded
    through ``run_cavi_block_ell`` must keep the mesh fit equal to the
    single-device fit."""
    import jax
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.ops import ell as ell_mod
    from hpfrec_jax.parallel import make_mesh
    from hpfrec_jax.utils.data import build_csr

    N, C = 128, 64
    y, iu, ii = _square_coincident_ladder_data()

    # precondition: the hazard is realized (equal bucket counts, square
    # tables, differing span tuples) -- if layout changes break this, the
    # test is no longer testing anything
    ipu, inu, dau = build_csr(iu, ii, y, N, N)
    ipi, ini, dai = build_csr(ii, iu, y, N, N)
    lu = ell_mod.build_ell(ipu, inu, dau, N, col_chunk_rows=C, n_cols=N)
    li = ell_mod.build_ell(ipi, ini, dai, N, col_chunk_rows=C, n_cols=N)
    assert len(lu.buckets) == len(li.buckets) == 3
    assert lu.col_spans != li.col_spans

    # force column tiling at toy scale inside HPF._make_runner
    monkeypatch.setattr(ell_mod, "plan_col_tiling", lambda *a, **k: C)

    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    kw = dict(k=5, maxiter=6, check_every=3, stop_crit="maxiter",
              random_seed=11, verbose=False)
    m1 = HPF(mesh=make_mesh(jax.devices()[:1]), **kw)
    m1.fit(df.copy())
    assert m1.nusers == m1.nitems == N
    m8 = HPF(mesh=make_mesh(), **kw)
    m8.fit(df.copy())
    np.testing.assert_allclose(m8.Theta, m1.Theta, rtol=1e-5)
    np.testing.assert_allclose(m8.Beta, m1.Beta, rtol=1e-5)


def test_ladder_variants_numerically_inert(monkeypatch):
    """The width ladder / merge threshold change only the layout, never the
    math: fits under each knob setting must agree to float tolerance."""
    import pandas as pd

    from hpfrec_jax import HPF
    from hpfrec_jax.ops import ell as ell_mod

    rng = np.random.default_rng(5)
    df = pd.DataFrame({"UserId": rng.integers(0, 90, 2000),
                       "ItemId": rng.integers(0, 70, 2000),
                       "Count": rng.poisson(2.0, 2000) + 1.0}
                      ).drop_duplicates(["UserId", "ItemId"])

    results = {}
    for lad, merge in (("half", "20"), ("quarter", "17"), ("eighth", "1")):
        monkeypatch.setenv("HPFREC_ELL_LADDER", lad)
        monkeypatch.setenv("HPFREC_ELL_MERGE_LOG2", merge)
        ell_mod._ladder_cache.clear()
        m = HPF(k=6, maxiter=8, check_every=4, stop_crit="train-llk",
                stop_thr=1e-12, random_seed=4, verbose=False)
        m.fit(df.copy())
        results[lad] = (m.Theta, m.train_llk)
    ell_mod._ladder_cache.clear()
    base_T, base_llk = results["half"]
    for lad in ("quarter", "eighth"):
        T, llk = results[lad]
        np.testing.assert_allclose(T, base_T, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(llk, base_llk, rtol=1e-6)
