"""Correctness of the one-hot matmul table ops against plain gathers.

The one-hot matmul path must be bit-exact (one-hots are 0/1 and the
matmuls run in full precision), so these compare exactly, not to a
tolerance, wherever only exact-representable arithmetic is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu2048.features import ntuple
from tpu2048.ops import onehot


def _random_boards(key, n):
    return jax.random.randint(key, (n, 16), 0, 12, dtype=jnp.int8)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_onehot_eval_matches_gather(n):
    ts = ntuple.get_tuple_set(n)
    classes = onehot.build_table_classes(ts)
    key = jax.random.PRNGKey(n)
    kw, kb = jax.random.split(key)
    weights = ntuple.init_weights(ts, kw)
    boards = _random_boards(kb, 64)
    idx = ntuple.feature_indices(ts, boards)
    ref = weights[idx].sum(axis=-1)
    got = onehot.onehot_eval(ts, classes, weights, idx)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)


def test_class_partition_covers_all_features():
    for n in (2, 3, 4, 5, 6):
        ts = ntuple.get_tuple_set(n)
        classes = onehot.build_table_classes(ts)
        covered = set(int(f) for f in classes.gather_feats)
        for c in classes.matmul:
            covered.update(range(c.feat0, c.feat0 + c.g))
        assert covered == set(range(ts.num_feat))
        # classes must be contiguous runs in the flat table
        for c in classes.matmul:
            for k in range(c.g):
                assert int(ts.offsets[c.feat0 + k]) == c.start + k * c.h * c.l
                assert int(ts.sizes[c.feat0 + k]) == c.h * c.l


@pytest.mark.parametrize("mean", [False, True])
def test_onehot_update_matches_scatter(mean):
    ts = ntuple.get_tuple_set(4)
    classes = onehot.build_table_classes(ts)
    key = jax.random.PRNGKey(7)
    kw, kb, kd, kv = jax.random.split(key, 4)
    weights = ntuple.init_weights(ts, kw)
    b = 32
    boards = _random_boards(kb, b)
    idx = ntuple.feature_indices(ts, boards)
    dw = jax.random.normal(kd, (b,)) * 0.1
    valid = jax.random.bernoulli(kv, 0.8, (b,))

    # scalar reference: scatter with collision-aware normalization
    dwv = np.where(np.asarray(valid), np.asarray(dw), 0.0)
    cv = np.asarray(valid).astype(np.float32)
    idx_np = np.asarray(idx)
    hits = np.zeros(ts.total, np.float32)
    ref = np.asarray(weights).copy()
    for i in range(b):
        for f in range(ts.num_feat):
            hits[idx_np[i, f]] += cv[i]
    for i in range(b):
        for f in range(ts.num_feat):
            u = dwv[i]
            if mean:
                u = u / max(hits[idx_np[i, f]], 1.0)
            ref[idx_np[i, f]] += u

    got = onehot.onehot_update(ts, classes, weights, idx, dw, valid, mean=mean)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_class_grads_match_numpy_scatter(n):
    """The kept class-grads path sums (dw, valid) into each 16^k class
    block exactly like a scatter-add: hits exact, dsum to f32 order."""
    from tpu2048.ops import dispatch

    ts = ntuple.get_tuple_set(n)
    rng = np.random.default_rng(n)
    b = 256
    boards = rng.integers(0, 8, size=(b, 16)).astype(np.int8)
    boards[rng.random((b, 16)) < 0.4] = 0  # colliding indices
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(boards)))
    dw = rng.normal(size=b).astype(np.float32)
    valid = rng.random(b) < 0.8
    classes, fn = dispatch.make_class_grads(ts, "auto")
    got = jax.jit(fn)(jnp.asarray(idx), jnp.asarray(dw), jnp.asarray(valid))
    assert len(got) == len(classes.matmul) > 0
    for c, (dsum, hits) in zip(classes.matmul, got):
        assert dsum.shape == hits.shape == (c.g, c.h, c.l)
        loc = idx[:, c.feat0: c.feat0 + c.g] - c.start
        want_d = np.zeros(c.g * c.h * c.l)
        want_h = np.zeros(c.g * c.h * c.l)
        np.add.at(want_d, loc, np.where(valid, dw, 0.0)[:, None])
        np.add.at(want_h, loc, valid[:, None].astype(float))
        np.testing.assert_array_equal(np.asarray(hits).reshape(-1), want_h)
        np.testing.assert_allclose(np.asarray(dsum).reshape(-1), want_d,
                                   rtol=1e-6, atol=1e-6)


_BUILDERS = {
    "make_evaluator": lambda d, ts, m: d.make_evaluator(ts, m),
    "make_train_evaluator": lambda d, ts, m: d.make_train_evaluator(ts, m),
    "make_delta_accumulator":
        lambda d, ts, m: d.make_delta_accumulator(ts, m),
    "make_class_grads": lambda d, ts, m: d.make_class_grads(ts, m),
    "make_updater": lambda d, ts, m: d.make_updater(ts, m, mean=True),
}


@pytest.mark.parametrize("mode", ["pallas", "search"])
@pytest.mark.parametrize("builder", sorted(_BUILDERS))
def test_removed_table_ops_raise(builder, mode):
    from tpu2048.ops import dispatch

    with pytest.raises(ValueError, match="valid modes"):
        _BUILDERS[builder](dispatch, ntuple.get_tuple_set(2), mode)
