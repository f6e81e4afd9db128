"""Benchmark: full-batch CAVI nonzero-updates/s on one GPU, synthetic
TasteProfile-like data.

Prints ONE JSON line:
  {"metric": "nonzeros_per_sec_per_chip", "value": N, "unit": "nnz/s",
   "vs_baseline": N / 1.85e6, "device": {...}, "card": [...], ...}

Baseline: the reference's aggregate throughput on the MillionSong
TasteProfile run — 38.7M nonzeros x 110 iterations / 2298 s ≈ 1.85e6
nonzero-updates/s on a 24-core Skylake at k=50 (BASELINE.md).

Timing: after one compiling warm-up dispatch, each repeat runs ``iters``
iterations in one dispatch from a fresh state and waits for the result
(``block_until_ready``); the reported per-iteration time is the median
over repeats, with the interquartile range beside it.  The run refuses
to start without a GPU.
"""

import json
import os
import time

import numpy as np


def synth_powerlaw(nU, nI, nnz, seed=0, dtype=np.float32):
    """User-sorted COO with Zipf-ish item popularity (matches the skewed
    degree profile of TasteProfile/MovieLens better than uniform)."""
    rng = np.random.default_rng(seed)
    iu = np.sort(rng.integers(0, nU, nnz)).astype(np.int32)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int32)
    y = (rng.poisson(2.0, nnz) + 1).astype(dtype)
    return y, iu, ii


SCALES = {
    # headline: the reference's own MillionSong TasteProfile shape
    # (notebook cell 10: 1,019,318 users x 376,768 items, 38.7M train
    # nonzeros, k=50)
    "millionsong": dict(nU=1_019_318, nI=376_768, nnz=38_700_000, k=50,
                        iters=20),
    # secondary: a smaller catalog at the same k
    "medium": dict(nU=200_000, nI=40_000, nnz=10_000_000, k=50, iters=20),
}


def main():
    scale = os.environ.get("BENCH_SCALE", "millionsong")
    cfg = SCALES[scale]
    nU = int(os.environ.get("BENCH_NUSERS", cfg["nU"]))
    nI = int(os.environ.get("BENCH_NITEMS", cfg["nI"]))
    nnz = int(os.environ.get("BENCH_NNZ", cfg["nnz"]))
    k = int(os.environ.get("BENCH_K", cfg["k"]))
    iters = int(os.environ.get("BENCH_ITERS", cfg["iters"]))
    engine = os.environ.get("BENCH_ENGINE", "auto")
    if engine not in ("auto", "ell", "table", "coo"):
        raise SystemExit("BENCH_ENGINE must be one of auto|ell|table|coo, "
                         "got %r" % engine)

    import contextlib

    import jax
    import jax.numpy as jnp

    from chip_smoke import card_info, require_gpus
    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.utils.profiling import enable_compilation_cache

    require_gpus(1)
    enable_compilation_cache()

    # This is a one-card statistic: the ell/auto/coo engines jit unsharded,
    # so on a machine with several devices they are pinned to device 0 and
    # the JSON says so.  The table engine spreads over the mesh.
    flags = []
    n_avail = len(jax.devices())
    pin_ctx = contextlib.nullcontext()
    if n_avail > 1 and engine != "table":
        pin_ctx = jax.default_device(jax.devices()[0])
        flags.append("%d devices present; %s engine pinned to device 0 — "
                     "single-chip statistic, not a machine measurement"
                     % (n_avail, engine))

    hp = Hyperparams(k=k)
    y, iu, ii = synth_powerlaw(nU, nI, nnz)
    prep = lambda st: st  # noqa: E731 — engine-space transform (table mode)

    slots_per_iter = None  # both E-step sides' gather slots (None: COO)
    if engine == "table":
        # the model-parallel engine on a mesh over the available devices
        from hpfrec_jax.ops.ell import gather_table_dtype, layout_slots
        from hpfrec_jax.parallel import make_mesh
        from hpfrec_jax.parallel.table_sharded import (
            make_table_sharded_step, pad_state, permute_state,
            prepare_table_sharded)
        from hpfrec_jax.utils.data import build_csr

        mesh = make_mesh()
        ndev = len(mesh.devices.ravel())
        gd = gather_table_dtype(os.environ.get("BENCH_GATHER_DTYPE", "auto"))
        g_item = 2 if gd is not None else 4
        indptr_u, ind_u, dat_u = build_csr(iu, ii, y, nU, nI)
        indptr_i, ind_i, dat_i = build_csr(ii, iu, y, nI, nU)
        se_u, se_i, plan_u, plan_i, perm_u, perm_i = prepare_table_sharded(
            indptr_u, ind_u, dat_u, indptr_i, ind_i, dat_i, nU, nI, k,
            ndev, g_item)
        nU_p, nI_p = plan_u[0], plan_i[0]
        slots_per_iter = layout_slots(se_u) + layout_slots(se_i)
        runner = make_table_sharded_step(mesh, se_u, se_i, hp, nU, nI,
                                         gather_dtype=gd,
                                         row_ids_u=perm_u, row_ids_i=perm_i)
        # one-time move of a fresh state into the padded+permuted engine
        # space (a shape test cannot detect the permuted space, so this is
        # explicit rather than inferred per call)
        prep = lambda st: permute_state(  # noqa: E731
            pad_state(st, nU_p, nI_p), perm_u, perm_i)
    elif engine in ("auto", "ell"):
        from hpfrec_jax.ops.ell import (build_ell, device_ell, gather_table_dtype,
                                        layout_slots, plan_col_tiling,
                                        run_cavi_block_ell)
        from hpfrec_jax.utils.data import build_csr

        pin_ctx.__enter__()  # device pin for the staging + jit below
        gd = gather_table_dtype(os.environ.get("BENCH_GATHER_DTYPE", "auto"))
        g_item = 2 if gd is not None else 4
        indptr_u, ind_u, dat_u = build_csr(iu, ii, y, nU, nI)
        indptr_i, ind_i, dat_i = build_csr(ii, iu, y, nI, nU)
        ell_u = device_ell(build_ell(indptr_u, ind_u, dat_u, nU,
                                     col_chunk_rows=plan_col_tiling(nI, k, g_item),
                                     n_cols=nI))
        ell_i = device_ell(build_ell(indptr_i, ind_i, dat_i, nI,
                                     col_chunk_rows=plan_col_tiling(nU, k, g_item),
                                     n_cols=nU))
        slots_per_iter = layout_slots(ell_u) + layout_slots(ell_i)
        # layouts as jit args (not closures) so they are buffers, not
        # embedded HLO constants
        jitted = jax.jit(run_cavi_block_ell,
                         static_argnames=("hp", "phi_sums_fn", "gather_dtype",
                                          "phi_pair_fn"))
        runner = lambda st, n: jitted(st, ell_u, ell_i, n, hp=hp,  # noqa: E731
                                      gather_dtype=gd)
    else:
        from hpfrec_jax.ops.cavi import BlockedCOO, run_cavi_block
        from hpfrec_jax.utils.data import block_coo

        pin_ctx.__enter__()  # device pin for the staging + jit below
        blk = block_coo(y, iu, ii)
        data = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u),
                          jnp.asarray(blk.ix_i))
        runner = lambda st, n: run_cavi_block(st, data, n, hp)  # noqa: E731

    t0 = time.perf_counter()
    jax.block_until_ready(runner(prep(initialize_state(nU, nI, hp, 123)),
                                 jnp.asarray(1, jnp.int32)))
    compile_s = time.perf_counter() - t0

    def timed():
        st = jax.block_until_ready(prep(initialize_state(nU, nI, hp, 123)))
        t0 = time.perf_counter()
        st = jax.block_until_ready(runner(st, jnp.asarray(iters, jnp.int32)))
        dt = time.perf_counter() - t0
        assert np.isfinite(float(jnp.sum(st.k_rte))), "bench produced invalid state"
        return dt / iters

    repeats = int(os.environ.get("BENCH_REPEATS", 5))
    per_iters = [timed() for _ in range(repeats)]
    per_iter = float(np.median(per_iters))
    q25, q75 = (float(np.percentile(per_iters, 25)),
                float(np.percentile(per_iters, 75)))

    value = nnz / per_iter
    baseline = 1.85e6
    dev = jax.devices()[0]
    out = {
        "metric": "nonzeros_per_sec_per_chip",
        "value": value,
        "unit": "nnz/s",
        "vs_baseline": value / baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_avail},
        "card": card_info(),
        "config": "%s nU=%d nI=%d nnz=%d k=%d iters=%d engine=%s" % (
            scale, nU, nI, nnz, k, iters, engine),
        "compile_and_first_iter_s": compile_s,
        "repeat_iter_s": per_iters,
        "iter_s_iqr": [q25, q75],
    }
    if slots_per_iter is not None:
        out["slots_per_iter"] = slots_per_iter
        out["slots_per_s"] = slots_per_iter / per_iter
    if flags:
        out["flags"] = flags
    print(json.dumps(out))


if __name__ == "__main__":
    main()
