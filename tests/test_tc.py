"""Temporal-coherence optimizer: numerics vs a scalar oracle, and a
learning smoke test (TC must learn n=2 at least as fast as SGD)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu2048.agent import td
from tpu2048.config import AgentConfig, TrainConfig
from tpu2048.engine import core as eng
from tpu2048.features import ntuple


@pytest.mark.parametrize("impl", ["index", "fold"])
def test_tc_update_numerics(impl):
    """One train step in TC mode == scalar TC math on the aggregated
    per-entry deltas, for both scatter implementations."""
    ts = ntuple.get_tuple_set(2)
    acfg = AgentConfig(n=2, optimizer="tc", alpha=1.0,
                       sym_mode="scatter", sym_impl=impl,
                       engine_mode="cells")
    tcfg = TrainConfig(num_envs=8, steps_per_call=1, ring_size=64,
                       record_envs=2, max_record_steps=64, seed=0)
    rng = np.random.default_rng(0)
    state = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(0))
    # seed nontrivial E/A so the |E|/A rate is exercised
    e0 = rng.normal(0, 0.1, ts.total).astype(np.float32)
    a0 = np.abs(rng.normal(0, 0.2, ts.total)).astype(np.float32)
    boards = rng.integers(0, 5, (8, 4, 4)).astype(np.int8)
    boards[rng.random((8, 4, 4)) < 0.5] = 0
    prev_flat = rng.integers(0, 5, (8, 16))
    prev_idx = np.asarray(
        ntuple.all_symmetry_indices(ts, jnp.asarray(prev_flat))
    )
    if impl == "index":
        prev_idx_state = prev_idx  # (8, 8, F)
    else:  # fold: identity indices only; the 8-image mass arrives
        # through the dense D4 table transforms
        prev_idx_state = np.asarray(
            ntuple.feature_indices(ts, jnp.asarray(prev_flat))
        )[:, None, :]
    prev_value = rng.random(8).astype(np.float32) * 10
    prev_valid = rng.random(8) < 0.8
    state = state._replace(
        opt_e=jnp.asarray(e0),
        opt_a=jnp.asarray(a0),
        env=eng.EnvState(
            boards=jnp.asarray(boards),
            score=jnp.zeros(8, jnp.int32),
            odometer=jnp.full(8, 3, jnp.int32),
        ),
        prev_idx=jnp.asarray(prev_idx_state),
        prev_value=jnp.asarray(prev_value),
        prev_valid=jnp.asarray(prev_valid),
    )
    step = jax.jit(td.make_train_step(ts, acfg, tcfg))
    out = step(state)

    # scalar oracle
    chosen, best_dir, best_val, best_delta, done = td.select_greedy(
        ts, state.weights, state.env.boards
    )
    td_err = np.where(
        np.asarray(done),
        -prev_value,
        np.asarray(best_delta, np.float32) + np.asarray(best_val)
        - prev_value,
    )
    delta = np.where(prev_valid, td_err, 0.0) / ts.num_feat
    dsum = np.zeros(ts.total, np.float64)
    hits = np.zeros(ts.total, np.float64)
    for i in range(8):
        if not prev_valid[i]:
            continue
        for s in range(8):
            for f in range(ts.num_feat):
                j = prev_idx[i, s, f]
                dsum[j] += delta[i]
                hits[j] += 1.0
    dbar = dsum / np.maximum(hits, 1.0)
    lr = np.where(a0 > 0, np.abs(e0) / np.maximum(a0, 1e-30), 1.0)
    w_expect = np.asarray(state.weights) + 1.0 * lr * dbar
    e_expect = e0 + dbar
    a_expect = a0 + np.abs(dbar)
    np.testing.assert_allclose(np.asarray(out.weights), w_expect,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.opt_e), e_expect,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.opt_a), a_expect,
                               rtol=1e-4, atol=1e-6)
    # alpha schedule is skipped in TC mode
    assert float(np.asarray(out.alpha)) == pytest.approx(1.0)


def test_tc_learns_n2():
    ts = ntuple.get_tuple_set(2)
    acfg = AgentConfig(n=2, optimizer="tc", alpha=1.0,
                       sym_mode="scatter")
    tcfg = TrainConfig(num_envs=128, steps_per_call=64, ring_size=512,
                       record_envs=4, max_record_steps=4096, seed=1)
    st = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(1))
    seg = jax.jit(td.make_train_segment(ts, acfg, tcfg), donate_argnums=0)
    for _ in range(40):
        st = seg(st)
    pos = int(np.asarray(st.metrics.ring_pos))
    take = min(100, pos)
    idx = np.arange(pos - take, pos) % tcfg.ring_size
    ma = float(np.asarray(st.metrics.score_ring)[idx].mean())
    # untrained play averages ~1,100; TC must be clearly learning
    assert ma > 4000, f"TC failed to learn: ma={ma}"


def test_tc_checkpoint_roundtrip(tmp_path):
    from tpu2048.obs.logging import Logger
    from tpu2048.store.artifacts import LocalStore
    from tpu2048.train.loop import Trainer

    store = LocalStore(str(tmp_path / "s"))
    acfg = AgentConfig(n=2, optimizer="tc", alpha=1.0, sym_mode="scatter")
    tcfg = TrainConfig(num_envs=64, episodes=150, steps_per_call=32,
                       ring_size=256, record_envs=2, max_record_steps=2048)
    tr = Trainer("tc_agent", acfg, tcfg, store=store,
                 logger=Logger(console=False))
    tr.run()
    a1 = np.asarray(tr.state.opt_a)
    assert a1.shape == (ts_total(acfg),) and a1.sum() > 0
    tr2 = Trainer("tc_agent", acfg, tcfg, store=store,
                  logger=Logger(console=False), resume=True)
    np.testing.assert_allclose(np.asarray(tr2.state.opt_a), a1, rtol=1e-6)


def ts_total(acfg):
    return ntuple.get_tuple_set(acfg.n).total


@pytest.mark.parametrize("optimizer", ["tc", "sgd"])
def test_segment_matches_direct_steps(optimizer):
    """The canonical segment (a scan of staged steps plus the
    once-per-segment recorder merge) must reproduce K direct unstaged
    steps on every learning leaf."""
    ts = ntuple.get_tuple_set(5)
    acfg = AgentConfig(n=5, table_ops="gather", optimizer=optimizer)
    tcfg = TrainConfig(num_envs=32, steps_per_call=8, ring_size=128,
                       record_envs=4, max_record_steps=512)
    st0 = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(3))
    seg = jax.jit(td.make_train_segment(ts, acfg, tcfg))
    stP = seg(st0)
    step = jax.jit(td.make_train_step(ts, acfg, tcfg, staged=False))
    stU = st0
    for _ in range(tcfg.steps_per_call):
        stU = step(stU)
    np.testing.assert_array_equal(
        np.asarray(stP.env.codes), np.asarray(stU.env.codes))
    np.testing.assert_allclose(
        np.asarray(stP.weights), np.asarray(stU.weights), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(stP.opt_e), np.asarray(stU.opt_e), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(stP.opt_a), np.asarray(stU.opt_a), atol=1e-6)
