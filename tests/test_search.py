"""Expectimax tests: base cases, pruning semantics, dead-child scoring,
statistical agreement with the sequential reference algorithm
(SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu2048.engine import core as engine
from tpu2048.features import ntuple
from tpu2048.search.expectimax import expectimax_value, make_expectimax_estimator


def const_value(c):
    return lambda boards: jnp.full(boards.shape[:-2], c, jnp.float32)


def test_depth_zero_returns_estimator():
    boards = engine.new_boards(8, jax.random.PRNGKey(0))
    v = expectimax_value(const_value(7.0), boards, jax.random.PRNGKey(1),
                         depth=0, width=4, since_empty=6)
    assert np.allclose(np.asarray(v), 7.0)


@pytest.mark.slow
def test_pruning_on_empty_boards():
    """Boards with >= since_empty empties return the raw estimate."""
    boards = engine.new_boards(8, jax.random.PRNGKey(0))  # 14 empties
    v = expectimax_value(const_value(3.5), boards, jax.random.PRNGKey(1),
                         depth=3, width=4, since_empty=6)
    assert np.allclose(np.asarray(v), 3.5)


def test_constant_estimator_fixed_point_on_crowded_boards():
    """With a constant positive estimator and no dead children, the
    expectimax value equals the constant (max over legal = c, avg = c)."""
    rng = np.random.default_rng(0)
    # crowded boards: 2 empties, alive
    boards = []
    while len(boards) < 16:
        b = rng.integers(1, 8, size=(4, 4)).astype(np.int8)
        b[0, 0] = 0
        b[3, 3] = 0
        if not bool(engine.is_terminal(jnp.asarray(b[None]))[0]):
            boards.append(b)
    boards = jnp.asarray(np.stack(boards))
    v = expectimax_value(const_value(5.0), boards, jax.random.PRNGKey(2),
                         depth=2, width=4, since_empty=16)
    # every child either alive (value 5.0) or dead (clipped to 0)
    assert (np.asarray(v) <= 5.0 + 1e-5).all()
    assert (np.asarray(v) >= 0.0).all()


def test_near_dead_board_scores_low():
    """A board whose every spawn kills the game must value 0 (dead
    children clip at 0)."""
    b = np.array(
        [[0, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]], np.int8
    )
    # spawning any tile at (0,0) other than matching neighbors kills it;
    # tiles 1/2 at (0,0): 1 merges with nothing (neighbors 2,2)... board
    # dead unless merge exists: check directly via the engine
    v = expectimax_value(const_value(9.0), jnp.asarray(b[None]),
                         jax.random.PRNGKey(3), depth=1, width=4,
                         since_empty=16)
    val = float(np.asarray(v)[0])
    children = []
    for tile in (1, 2):
        c = b.copy()
        c[0, 0] = tile
        children.append(bool(engine.is_terminal(jnp.asarray(c[None]))[0]))
    if all(children):
        assert val == 0.0
    else:
        assert 0.0 <= val <= 9.0


def test_statistical_agreement_with_sequential_reference():
    """Batched sampled expectimax ~ sequential look_forward in
    expectation (same tree law) for a value-bearing estimator."""
    from tpu2048.engine.parity import ParityGame
    import random as pyrandom

    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(5)) * 100.0
    wnp = np.asarray(w)

    def np_value(board):
        idx = np.asarray(
            ntuple.feature_indices(ts, jnp.asarray(board.reshape(1, 16)))
        )[0]
        return float(wnp[idx].sum())

    rng = np.random.default_rng(1)
    board = np.array(
        [[3, 1, 2, 4], [1, 5, 3, 1], [2, 3, 0, 2], [4, 1, 2, 0]], np.int8
    )
    # sequential estimates (Monte Carlo over the reference algorithm)
    g = ParityGame(row=board.astype(np.int32), rng=pyrandom.Random(0))
    seq = [
        g.look_forward(
            lambda r, s: np_value(np.asarray(r)), board.astype(np.int32), 0,
            depth=1, width=2, since_empty=16,
        )
        for _ in range(300)
    ]
    # batched estimates
    jfn = jax.jit(
        lambda b, k: expectimax_value(
            lambda x: jnp.asarray(
                ntuple.evaluate(ts, w, x.reshape(x.shape[:-2] + (16,)))
            ),
            b, k, depth=1, width=2, since_empty=16,
        )
    )
    batched = [
        float(np.asarray(jfn(jnp.asarray(board[None]), jax.random.PRNGKey(i)))[0])
        for i in range(300)
    ]
    m1, m2 = np.mean(seq), np.mean(batched)
    s = max(np.std(seq), np.std(batched), 1e-9)
    assert abs(m1 - m2) < 4 * s / np.sqrt(300) + 1e-3, (m1, m2)


def test_estimator_wrapper_shapes():
    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0))
    est = make_expectimax_estimator(
        lambda b: ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,))),
        depth=2, width=3, since_empty=6,
    )
    boards = engine.new_boards(12, jax.random.PRNGKey(1))
    v = est(boards, jax.random.PRNGKey(2))
    assert v.shape == (12,)
    assert np.isfinite(np.asarray(v)).all()


@pytest.mark.slow
def test_expectimax_chunked_matches_full():
    """Root-batch chunking (memory bound) is pure plumbing: on boards
    pruned by since_empty the value is the raw estimate and must match
    the unchunked path EXACTLY; on searched boards it stays finite and
    in the estimator's range."""
    import jax

    from tpu2048.features import ntuple
    from tpu2048.search.expectimax import make_expectimax_estimator

    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0)) + 1.0

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    # fresh boards have ~14 empties >= since_empty -> pruned to base
    boards = engine.new_boards(32, jax.random.PRNGKey(5))
    key = jax.random.PRNGKey(3)
    full = make_expectimax_estimator(value_fn, 2, 3, 6)
    chunked = make_expectimax_estimator(value_fn, 2, 3, 6, max_leaves=100)
    vf = np.asarray(full(boards, key))
    vc = np.asarray(chunked(boards, key))
    assert vf.shape == vc.shape == (32,)
    np.testing.assert_allclose(vc, vf, rtol=1e-6)

    # crowded boards actually search through the chunked tree
    rng = np.random.default_rng(0)
    crowd = rng.integers(1, 8, size=(32, 4, 4)).astype(np.int8)
    crowd[:, 0, 0] = 0
    crowd[:, 3, 3] = 0
    vc2 = np.asarray(
        chunked(jnp.asarray(crowd), key)
    )
    assert np.isfinite(vc2).all() and (vc2 >= 0).all()


def test_expectimax_odd_batch_respects_memory_bound():
    """An odd root batch must still be chunked (padded, masked) so the
    max_leaves memory bound is hard, not bypassed (the old power-of-two
    splitter gave up on odd sizes).  Pruned boards must return the raw
    estimate exactly regardless of padding."""
    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0)) + 1.0

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    boards = engine.new_boards(13, jax.random.PRNGKey(7))  # odd batch
    key = jax.random.PRNGKey(3)
    est = make_expectimax_estimator(value_fn, 2, 3, 6, max_leaves=200)
    v = np.asarray(est(boards, key))
    assert v.shape == (13,)
    assert np.isfinite(v).all()
    # fresh boards are pruned (empty >= since_empty) -> exact base value
    base = np.asarray(value_fn(boards))
    np.testing.assert_allclose(v, base, rtol=1e-6)


@pytest.mark.slow
def test_codes_expectimax_matches_cells_exactly():
    """The codes-engine search is an implementation swap, not a
    semantic change: same RNG draw structure, same tree, so values
    must match the cells-engine path BITWISE on crowded boards that
    actually search (and on pruned boards trivially)."""
    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0)) + 1.0

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    rng = np.random.default_rng(7)
    boards = rng.integers(1, 8, size=(24, 4, 4)).astype(np.int8)
    boards[rng.random((24, 4, 4)) < 0.15] = 0  # few empties -> searched
    boards = jnp.asarray(boards)
    key = jax.random.PRNGKey(11)
    for depth, width in ((1, 2), (2, 3), (3, 4)):
        cells_est = make_expectimax_estimator(
            value_fn, depth, width, 6, engine_mode="cells")
        codes_est = make_expectimax_estimator(
            value_fn, depth, width, 6, engine_mode="codes")
        vc = np.asarray(cells_est(boards, key))
        vk = np.asarray(codes_est(boards, key))
        np.testing.assert_array_equal(vc, vk)


def _rand_boards(key, b, crowd=False):
    """Random boards; crowd=True leaves < 6 empties per board."""
    bb = np.asarray(
        jax.random.randint(key, (b, 16), 1, 11, dtype=jnp.int8)
    ).copy()
    if not crowd:
        bb[:, ::2] = 0  # 8 empties -> comfortable (since_empty=6)
    else:
        bb[:, :3] = 0  # exactly 3 empties -> crowded
    return jnp.asarray(bb.reshape(b, 4, 4))


@pytest.mark.slow
def test_compacted_all_comfortable_equals_base():
    """If nothing needs search, the compacted estimator returns the
    raw base values bitwise (the reference's pruning semantics)."""
    from tpu2048.search.expectimax import make_compacted_estimator

    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0))

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    boards = _rand_boards(jax.random.PRNGKey(1), 24)
    need = jnp.zeros(24, bool)
    est = make_compacted_estimator(value_fn, 3, 4, 6, batch=24,
                                   tiers=(8, 16))
    # bitwise claims hold op-by-op (eager); jit may re-fuse the
    # f32 reductions, so assert exactness eagerly and only
    # shape/finite-ness under jit
    out = est(boards, jax.random.PRNGKey(2), need)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(value_fn(boards)))
    jout = jax.jit(est)(boards, jax.random.PRNGKey(2), need)
    assert jout.shape == (24,) and bool(jnp.isfinite(jout).all())


@pytest.mark.slow
def test_compacted_tier_matches_sub_batch_estimator():
    """Searched roots get bitwise the values of the plain estimator
    run on the top-k-compacted sub-batch with the same key."""
    from tpu2048.search.expectimax import make_compacted_estimator

    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0))

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    b = 24
    comfortable = _rand_boards(jax.random.PRNGKey(1), b)
    crowded = _rand_boards(jax.random.PRNGKey(3), b, crowd=True)
    need = jnp.asarray(np.arange(b) % 4 == 1)  # 6 of 24 need search
    boards = jnp.where(need[:, None, None], crowded, comfortable)
    key = jax.random.PRNGKey(5)

    est = make_compacted_estimator(value_fn, 2, 3, 6, batch=b,
                                   tiers=(8, 16))
    out = np.asarray(est(boards, key, need))

    # reproduce the tier-8 compaction independently
    _, idx = jax.lax.top_k(need.astype(jnp.int32), 8)
    plain = make_expectimax_estimator(value_fn, 2, 3, 6)
    sub = np.asarray(plain(boards[idx], key))
    base = np.asarray(value_fn(boards))
    idx = np.asarray(idx)
    need_np = np.asarray(need)
    for slot, i in enumerate(idx):
        if need_np[i]:
            # same algorithm + same RNG draws; tolerance covers f32
            # re-fusion differences between compiled cond branches
            np.testing.assert_allclose(out[i], sub[slot], rtol=1e-5)
    np.testing.assert_allclose(out[~need_np], base[~need_np], rtol=1e-6)


def test_compacted_overflow_falls_back_to_full():
    """More needy roots than any tier -> full-batch tree, with base
    values still returned for the un-needy lanes."""
    from tpu2048.search.expectimax import make_compacted_estimator

    ts = ntuple.get_tuple_set(2)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0))

    def value_fn(b):
        return ntuple.evaluate(ts, w, b.reshape(b.shape[:-2] + (16,)))

    b = 12
    boards = _rand_boards(jax.random.PRNGKey(7), b, crowd=True)
    need = jnp.ones(b, bool).at[0].set(False)
    key = jax.random.PRNGKey(9)
    est = make_compacted_estimator(value_fn, 2, 3, 6, batch=b,
                                   tiers=(4,))
    out = np.asarray(est(boards, key, need))
    plain = make_expectimax_estimator(value_fn, 2, 3, 6)
    full = np.asarray(plain(boards, key))
    base = np.asarray(value_fn(boards))
    np.testing.assert_allclose(out[1:], full[1:], rtol=1e-5)
    np.testing.assert_allclose(out[0], base[0], rtol=1e-6)
