"""Unit tests: JAX CAVI core vs the pure-numpy oracle (SURVEY.md §4 plan (a))."""

import numpy as np
import pytest

from oracle import OracleHPF, synth_counts


def _setup(dtype, k=7, seed=42):
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.cavi import BlockedCOO
    from hpfrec_jax.utils.data import block_coo

    if dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)

    nU, nI = 60, 45
    y, iu, ii = synth_counts(nU, nI, seed=3, dtype=dtype)
    hp = Hyperparams(a=0.3, a_prime=0.3, b_prime=1.0, c=0.3, c_prime=0.3, d_prime=1.0, k=k)
    state = initialize_state(nU, nI, hp, seed, dtype)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, dtype)

    blk = block_coo(y, iu, ii, block_size=128)
    data = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u), jnp.asarray(blk.ix_i))
    return state, oracle, data, (y, iu, ii), hp


def test_init_matches_reference_bitstream():
    """Same seed + dtype must give the same MT19937 init as the reference
    semantics (prior + 0.01*U in G_rte, L_rte, G_shp, L_shp order)."""
    state, oracle, *_ = _setup(np.float32)
    np.testing.assert_array_equal(np.asarray(state.G_shp), oracle.G_shp)
    np.testing.assert_array_equal(np.asarray(state.L_rte), oracle.L_rte)
    np.testing.assert_array_equal(np.asarray(state.k_rte), oracle.k_rte)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4), (np.float64, 1e-10)])
def test_single_step_matches_oracle(dtype, tol):
    from hpfrec_jax.ops.cavi import cavi_step

    state, oracle, data, (y, iu, ii), hp = _setup(dtype)
    new = cavi_step(state, data, hp)
    oracle.full_step(y, iu, ii)
    for ours, ref in [(new.G_shp, oracle.G_shp), (new.G_rte, oracle.G_rte),
                      (new.L_shp, oracle.L_shp), (new.L_rte, oracle.L_rte),
                      (new.k_rte, oracle.k_rte), (new.t_rte, oracle.t_rte)]:
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 3e-3), (np.float64, 1e-8)])
def test_ten_steps_match_oracle(dtype, tol):
    import jax.numpy as jnp

    from hpfrec_jax.ops.cavi import run_cavi_block

    state, oracle, data, (y, iu, ii), hp = _setup(dtype)
    state = run_cavi_block(state, data, jnp.asarray(10, jnp.int32), hp)
    for _ in range(10):
        oracle.full_step(y, iu, ii)
    np.testing.assert_allclose(np.asarray(state.Theta), oracle.Theta, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(state.Beta), oracle.Beta, rtol=tol, atol=tol)


def test_llk_matches_oracle():
    from hpfrec_jax.ops.cavi import cavi_step
    from hpfrec_jax.ops.metrics import train_llk_rmse

    state, oracle, data, (y, iu, ii), hp = _setup(np.float32)
    state = cavi_step(state, data, hp)
    oracle.full_step(y, iu, ii)
    llk, rmse = train_llk_rmse(state.Theta, state.Beta, data, len(y))
    ref_llk = oracle.train_llk(y, iu, ii)
    assert abs(llk - ref_llk) / abs(ref_llk) < 1e-4
    yhat = np.einsum("ij,ij->i", oracle.Theta[iu], oracle.Beta[ii])
    ref_rmse = float(np.sqrt(((y - yhat) ** 2).mean()))
    assert abs(rmse - ref_rmse) / ref_rmse < 1e-4


def test_llk_monotone_ascent():
    """CAVI's Poisson llk surrogate should improve over iterations
    (SURVEY.md §4 plan (c))."""
    import jax.numpy as jnp

    from hpfrec_jax.ops.cavi import run_cavi_block
    from hpfrec_jax.ops.metrics import train_llk_rmse

    state, _, data, (y, iu, ii), hp = _setup(np.float32)
    llks = []
    for _ in range(6):
        state = run_cavi_block(state, data, jnp.asarray(5, jnp.int32), hp)
        llk, _ = train_llk_rmse(state.Theta, state.Beta, data, len(y))
        llks.append(llk)
    assert llks[-1] > llks[0]
    # near-monotone: allow tiny numeric wobble late in convergence
    for prev, cur in zip(llks, llks[1:]):
        assert cur >= prev - abs(prev) * 1e-4


def test_sharded_matches_single_device():
    """SPMD data-parallel segment sums == single-device result
    (SURVEY.md §4 plan (d))."""
    import jax
    import jax.numpy as jnp

    from hpfrec_jax.models.state import Hyperparams, initialize_state
    from hpfrec_jax.ops.cavi import BlockedCOO, cavi_step
    from hpfrec_jax.parallel import make_mesh, make_sharded_segment_sums, shard_blocked_data
    from hpfrec_jax.utils.data import block_coo

    assert len(jax.devices()) == 8, "tests must run with 8 virtual CPU devices"
    nU, nI, k = 60, 45, 7
    y, iu, ii = synth_counts(nU, nI, seed=5)
    hp = Hyperparams(k=k)
    blk = block_coo(y, iu, ii, block_size=64, n_shards=8)
    data = BlockedCOO(jnp.asarray(blk.y), jnp.asarray(blk.ix_u), jnp.asarray(blk.ix_i))

    s1 = cavi_step(initialize_state(nU, nI, hp, 7), data, hp)

    mesh = make_mesh()
    fn = make_sharded_segment_sums(mesh)
    sdata = shard_blocked_data(data, mesh)
    s8 = cavi_step(initialize_state(nU, nI, hp, 7), sdata, hp, segment_sums_fn=fn)

    np.testing.assert_allclose(np.asarray(s8.G_shp), np.asarray(s1.G_shp), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s8.L_shp), np.asarray(s1.L_shp), rtol=1e-6)
