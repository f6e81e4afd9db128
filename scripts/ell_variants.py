"""Time the full-batch engine's layout variants on one GPU, in one process.

    python scripts/ell_variants.py [--iters 5] [--repeats 2] [--out DIR]

At the MillionSong TasteProfile shape (1,019,318 users x 376,768 items,
38.7M nonzeros, k=50, Zipf item popularity; ``chip_smoke.TASTE``), each
variant of the CAVI iteration is compiled once, then run from the same
seeded state in turns (every variant once, then every variant again in
reverse order), ``--iters`` iterations per timed dispatch after one warm
iteration, ending in ``block_until_ready``:

  a. ELL as shipped before this measurement: column tiling over 48 MB,
     bfloat16 gather tables over 64 MB;
  b. ELL untiled, bfloat16 gather tables;
  c. ELL tiled with float32 gather tables;
  d. the blocked-COO engine (scatter-add E-step);
  f. ELL untiled with float32 gather tables;
  e. f with the float32 contraction precision left to XLA (may be TF32).

``--only e,f`` runs a subset.  Per variant it prints the compile seconds, seconds per iteration of each
turn, the compiled program's memory, the train llk after the run, and
whether two runs from the same state ended bit-identical.  A last line
repeats mini-batch SVI at the medium shape twice and compares the
factors.  Everything is printed as JSON lines and written to
``DIR/ell_variants.json`` (default ``measurements/``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(rec, sink):
    sink.append(rec)
    print(json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "measurements"))
    ap.add_argument("--only", default="",
                    help="comma-separated variant letters, e.g. 'e,f'")
    ap.add_argument("--no-svi", action="store_true",
                    help="skip the SVI repeat")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import hpfrec_jax.ops.ell as ell
    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops import metrics as M
    from hpfrec_jax.ops.cavi import BlockedCOO, run_cavi_block
    from hpfrec_jax.utils.data import block_coo, build_csr

    out = []
    dev = chip_smoke.require_gpus(1)[0]
    log({"device": dev.device_kind, "platform": dev.platform,
         "nvidia_smi": chip_smoke.card_info(),
         "pandas": _has("pandas"), "native": _native_ok()}, out)

    nU, nI, nnz = (chip_smoke.TASTE[k] for k in ("n_users", "n_items", "nnz"))
    k = chip_smoke.K
    hp = Hyperparams(k=k)
    from bench import synth_powerlaw

    y, iu, ii = synth_powerlaw(nU, nI, nnz, seed=0)
    csr_u = build_csr(iu, ii, y, nU, nI)
    csr_i = build_csr(ii, iu, y, nI, nU)

    def layouts(itemsize):
        t = time.time()
        cu = ell.plan_col_tiling(nI, k, itemsize) if itemsize else None
        ci = ell.plan_col_tiling(nU, k, itemsize) if itemsize else None
        lu = ell.device_ell(ell.build_ell(*csr_u, nU, col_chunk_rows=cu, n_cols=nI))
        li = ell.device_ell(ell.build_ell(*csr_i, nI, col_chunk_rows=ci, n_cols=nU))
        jax.block_until_ready((lu, li))
        log({"layout": {"tile_itemsize": itemsize, "chunk_u": cu, "chunk_i": ci},
             "slots": ell.layout_slots(lu) + ell.layout_slots(li),
             "buckets": len(lu.buckets) + len(li.buckets),
             "split_levels": [len(lu.split_seg_pos), len(li.split_seg_pos)],
             "host_pack_s": round(time.time() - t, 3)}, out)
        return lu, li

    untiled = layouts(None)
    wanted = set(args.only.split(",")) if args.only else set("abcdef")
    tiled_bf16 = layouts(2) if "a" in wanted else None
    tiled_f32 = layouts(4) if "c" in wanted else None
    blk = block_coo(y, iu, ii)
    coo = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u), jnp.asarray(blk.ix_i))

    def ell_jit():
        # a fresh function object per variant, so each traces anew (the
        # precision variant changes a module constant, not an argument)
        return jax.jit(lambda *a, **kw: ell.run_cavi_block_ell(*a, **kw),
                       static_argnames=("hp", "gather_dtype"),
                       donate_argnums=(0,))

    variants = {
        "a_tiled_bf16": (ell_jit(), tiled_bf16, jnp.bfloat16, "highest"),
        "b_untiled_bf16": (ell_jit(), untiled, jnp.bfloat16, "highest"),
        "c_tiled_f32": (ell_jit(), tiled_f32, None, "highest"),
        "d_coo": (run_cavi_block, None, None, "highest"),
        "f_untiled_f32": (ell_jit(), untiled, None, "highest"),
        "e_untiled_f32_default_precision": (ell_jit(), untiled, None, None),
    }
    if args.only:
        variants = {n: v for n, v in variants.items()
                    if n.split("_")[0] in args.only.split(",")}

    def fresh():
        return jax.device_put(initialize_state(nU, nI, hp, 123))

    compiled = {}
    for name, (fn, lay, gd, prec) in variants.items():
        ell.PRECISION = prec
        t = time.time()
        if lay is None:
            lowered = fn.lower(fresh(), coo, jnp.asarray(1, jnp.int32), hp)
            dyn = (coo,)
        else:
            lowered = fn.lower(fresh(), lay[0], lay[1], jnp.asarray(1, jnp.int32),
                               hp=hp, gather_dtype=gd)
            dyn = lay
        c = lowered.compile()
        mem = c.memory_analysis()
        compiled[name] = (c, dyn)
        log({"variant": name, "compile_s": round(time.time() - t, 3),
             "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
             "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
             "output_bytes": getattr(mem, "output_size_in_bytes", None)}, out)
    ell.PRECISION = "highest"

    metric = jax.jit(lambda T, B: M.ell_llk_rmse_sums(T, B, untiled[0]))
    results = {name: {"s_per_iter": [], "states": []} for name in variants}
    order = list(variants)
    for turn in range(args.repeats):
        for name in (order if turn % 2 == 0 else order[::-1]):
            c, lay_args = compiled[name]
            st = c(fresh(), *lay_args, jnp.asarray(1, jnp.int32))
            jax.block_until_ready(st)
            t = time.perf_counter()
            st = c(st, *lay_args, jnp.asarray(args.iters, jnp.int32))
            jax.block_until_ready(st)
            dt = (time.perf_counter() - t) / args.iters
            results[name]["s_per_iter"].append(dt)
            results[name]["states"].append(jax.tree.map(np.asarray, st))
            log({"turn": turn, "variant": name, "s_per_iter": dt}, out)

    for name, r in results.items():
        s0, s1 = r["states"][0], r["states"][-1]
        Theta = s1.G_shp / s1.G_rte
        Beta = s1.L_shp / s1.L_rte
        ll, _, _ = metric(jnp.asarray(Theta), jnp.asarray(Beta))
        llk = float(np.asarray(ll, np.float64).sum()) - float(
            Theta.sum(0).astype(np.float64) @ Beta.sum(0).astype(np.float64))
        same = all(np.array_equal(a, b) for a, b in zip(s0, s1))
        t0 = s0.G_shp / s0.G_rte
        log({"variant": name, "s_per_iter_median": float(np.median(r["s_per_iter"])),
             "s_per_iter": r["s_per_iter"], "train_llk": llk,
             "iterations": 1 + args.iters, "repeat_bit_identical": same,
             "repeat_theta_max_rel": float(np.max(np.abs(Theta - t0)
                                                  / np.maximum(np.abs(t0), 1e-30)))}, out)

    log({"peak_bytes_in_use": chip_smoke.peak_bytes()}, out)
    del compiled, results, untiled, tiled_bf16, tiled_f32, coo

    if args.no_svi:
        _write(out, args.out)
        return
    t = time.time()
    svi_data = chip_smoke.powerlaw_counts(**chip_smoke.MEDIUM, seed=1)
    s1 = chip_smoke.fit_svi(svi_data)
    s2 = chip_smoke.fit_svi(svi_data)
    log({"svi_repeat": chip_smoke.MEDIUM, "seconds": round(time.time() - t, 3),
         "bit_identical": bool(np.array_equal(s1.Theta, s2.Theta)
                               and np.array_equal(s1.Beta, s2.Beta)),
         "theta_max_rel": chip_smoke.max_rel_diff(s2.Theta, s1.Theta),
         "train_llk": [s1.train_llk, s2.train_llk],
         "phases_s": s1.fit_stats_.phases}, out)

    _write(out, args.out)


def _write(out, where):
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "ell_variants.json"), "w") as f:
        json.dump(out, f, indent=1)


def _has(mod):
    import importlib.util

    return importlib.util.find_spec(mod) is not None


def _native_ok():
    from hpfrec_jax import _native

    return _native.available()


if __name__ == "__main__":
    main()
