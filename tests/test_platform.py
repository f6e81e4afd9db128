"""Platform contract: compile-cache location, pandas-free array paths, the
GPU smoke script's refusal to run elsewhere, the fixed-order split-row
reduction, and (marked ``gpu``) the same checks on an NVIDIA GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from oracle import OracleHPF, synth_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else [
        sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


_CACHE_PROBE = (
    "import jax\n"
    "from hpfrec_jax.utils.profiling import enable_compilation_cache\n"
    "print(enable_compilation_cache(), jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("setting", ["env_dir", "off"])
def test_compilation_cache_honours_env(tmp_path, setting):
    """JAX_COMPILATION_CACHE_DIR is left for JAX to use; HPFREC_XLA_CACHE
    only switches the cache off."""
    extra = ({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if setting == "env_dir"
             else {"HPFREC_XLA_CACHE": "0"})
    r = _run(_CACHE_PROBE, extra, drop=("JAX_COMPILATION_CACHE_DIR",
                                        "HPFREC_XLA_CACHE"))
    assert r.returncode == 0, r.stderr
    active, where = r.stdout.split()
    if setting == "env_dir":
        assert active == "True" and where == str(tmp_path)
    else:
        assert active == "False" and where == "None"


def test_default_compilation_cache_is_fixed_inside_checkout():
    from hpfrec_jax.utils.profiling import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    r = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR", "HPFREC_XLA_CACHE"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", DEFAULT_CACHE_DIR]


@pytest.mark.parametrize("reindex", [True, False])
def test_array_paths_run_without_pandas(monkeypatch, reindex):
    """fit / serving / online updates on ndarray and scipy-COO input never
    import pandas (``import pandas`` raises while the test runs)."""
    from scipy.sparse import coo_array

    from hpfrec_jax import HPF

    monkeypatch.setitem(sys.modules, "pandas", None)
    y, iu, ii = synth_counts(70, 40, nnz=900, seed=4)
    data = np.column_stack([iu, ii, y]).astype(np.int64)
    m = HPF(k=4, maxiter=6, check_every=3, stop_crit="train-llk",
            random_seed=2, verbose=False, reindex=reindex)
    m.fit(data)
    assert np.isfinite(m.train_llk)
    u0 = m.user_mapping_[0] if reindex else 0
    assert len(m.topN(u0, n=5)) == 5
    assert m.topN_batch([u0], n=5).shape == (1, 5)
    assert np.isfinite(m.predict(user=iu[:10], item=ii[:10])).all()
    assert np.isfinite(m.eval_llk(data[:50])["llk"])
    hist = np.column_stack([ii[:6], y[:6]])
    assert np.isfinite(m.predict_factors(hist)).all()
    assert m.add_user(10_000 if reindex else 70, hist)
    if not reindex:
        m.partial_fit(data[data[:, 0] < 5], batch_type="users")
        assert np.isfinite(m.Theta).all()
        mc = HPF(k=4, maxiter=3, check_every=1, random_seed=2, verbose=False)
        mc.fit(coo_array((y, (iu, ii)), shape=(70, 40)))
        assert np.isfinite(mc.Theta).all()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On the CPU platform, and with none of the repository beside it, the
    smoke script exits non-zero and prints no result line."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], cwd=cwd,
             env_extra={"PYTHONPATH": ""} if where == "alone" else None)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert '"phase"' not in r.stdout  # no phase ran


def test_split_tree_sums_deep_rows_in_fixed_order():
    """Rows split into many segments are summed through a multi-level
    tree whose last level holds one row per split row; the reassembled
    sums match a dense numpy segment sum."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.ell import (SPLIT_FANIN, build_ell, device_ell,
                                    segment_table_sums, split_tree)

    rng = np.random.default_rng(5)
    counts = np.array([1, 3, 4, 5, 17, 70])
    levels = split_tree(np.arange(counts.sum()), counts)
    assert len(levels) == 4  # 70 -> 18 -> 5 -> 2 -> 1
    assert levels[-1].shape == (len(counts), SPLIT_FANIN)

    nU, nI = 40, 300
    iu = np.concatenate([np.zeros(250, np.int64), rng.integers(1, nU, 400)])
    ii = np.concatenate([np.arange(250), rng.integers(0, nI, 400)])
    order = np.argsort(iu, kind="stable")
    iu, ii = iu[order], ii[order]
    deg = np.bincount(iu, minlength=nU)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    vals = rng.random(len(iu)).astype(np.float32) + 0.5
    lay = build_ell(indptr, ii.astype(np.int32), vals, nU, min_width=1,
                    max_width=4)
    assert len(lay.split_seg_pos) >= 3  # row 0 has 63 extra segments
    assert len(np.unique(lay.split_rows)) == len(lay.split_rows)
    seg = np.concatenate([(b.vals[:, :, None] * np.ones((1, 1, 3)))
                          .sum(axis=1) for b in lay.buckets])
    out = np.asarray(segment_table_sums(jnp.asarray(seg), device_ell(lay)))
    ref = np.zeros((nU, 3))
    np.add.at(ref, iu, vals[:, None].astype(np.float64))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("shard_tables", [False, True])
def test_mesh_fit_compiles_iteration_program_once(shard_tables):
    """The state starts in the sharding the mesh engines return it in, so
    the dispatches after the first reuse its compiled program."""
    import logging
    import re

    import jax

    from hpfrec_jax import HPF
    from hpfrec_jax.parallel import make_mesh

    compiled = []

    class _Compiles(logging.Handler):
        def emit(self, record):
            m = re.match(r"Compiling (\S+) with", record.getMessage())
            if m:
                compiled.append(m.group(1))

    # shapes no other test uses, so no earlier compile is reused
    y, iu, ii = synth_counts(311, 127, nnz=4000, seed=6)
    data = np.column_stack([iu, ii, y]).astype(np.int64)
    model = HPF(k=3, maxiter=6, check_every=2, stop_crit="train-llk",
                random_seed=1, verbose=False, reindex=False,
                mesh=make_mesh(jax.devices()[:4]), shard_tables=shard_tables)
    handler, logger = _Compiles(), logging.getLogger("jax")
    logger.addHandler(handler)
    try:
        with jax.log_compiles(True):
            model.fit(data)
    finally:
        logger.removeHandler(handler)
    program = "jit(_run)" if shard_tables else "jit(run_cavi_block_ell)"
    assert compiled.count(program) == 1, compiled


def _oracle_step_setup(nU, nI, nnz, k, seed=3):
    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.ell import build_ell, device_ell
    from hpfrec_jax.utils.data import build_csr

    y, iu, ii = synth_counts(nU, nI, nnz, seed=seed)
    hp = Hyperparams(k=k)
    state = initialize_state(nU, nI, hp, 9)
    ref = OracleHPF(*hp).init(nU, nI, 9, np.float32)
    for name in ("G_shp", "G_rte", "L_shp", "L_rte", "k_rte", "t_rte"):
        setattr(ref, name, getattr(ref, name).astype(np.float64))
    ref.full_step(y.astype(np.float64), iu, ii)
    ell_u = device_ell(build_ell(*build_csr(iu, ii, y, nU, nI), nU))
    ell_i = device_ell(build_ell(*build_csr(ii, iu, y, nI, nU), nI))
    return state, ell_u, ell_i, hp, ref


@pytest.mark.gpu
def test_gpu_ell_step_matches_float64_oracle(gpu):
    """One float32 ELL iteration at k=50 on the GPU stays within the CPU
    suite's 2e-4 of the float64 oracle (no TF32 in the contractions)."""
    from hpfrec_jax.ops.ell import cavi_step_ell

    state, ell_u, ell_i, hp, ref = _oracle_step_setup(4000, 1500, 100_000, 50)
    out = cavi_step_ell(state, ell_u, ell_i, hp)
    for f in ("G_shp", "G_rte", "L_shp", "L_rte", "k_rte", "t_rte"):
        np.testing.assert_allclose(np.asarray(getattr(out, f)), getattr(ref, f),
                                   rtol=2e-4, atol=2e-4, err_msg=f)


@pytest.mark.gpu
def test_gpu_fit_repeats_bit_identical(gpu):
    from hpfrec_jax import HPF

    y, iu, ii = synth_counts(3000, 800, 60_000, seed=8)
    data = np.column_stack([iu, ii, y]).astype(np.int64)
    fits = [HPF(k=20, maxiter=8, random_seed=5, verbose=False,
                reindex=False).fit(data) for _ in range(2)]
    assert np.array_equal(fits[0].Theta, fits[1].Theta)
    assert np.array_equal(fits[0].Beta, fits[1].Beta)
