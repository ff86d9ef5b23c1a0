"""Checks that need the card: each takes the ``gpu`` fixture, which
skips it on any other platform.  ``chip_smoke.py`` runs them on the
GPU in its own process (``pytest -m gpu tests/test_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu2048.features import canonical, ntuple
from tpu2048.ops import dispatch

pytestmark = pytest.mark.gpu


def test_feature_indices_exact_under_tf32_default(gpu):
    """The index matmuls pin Precision.HIGHEST, so a TF32 default
    matmul precision cannot round n=7's indices (up to 16^6 - 1)."""
    ts = ntuple.get_tuple_set(7)
    rng = np.random.default_rng(0)
    boards = rng.integers(0, 16, size=(2048, 16)).astype(np.int8)
    boards[:32] = 15
    x = boards.astype(np.int64)
    v = np.concatenate([x, np.minimum(x, 13)], axis=-1)
    want = v @ ts.matrix.T.astype(np.int64) + ts.offsets
    with jax.default_matmul_precision("tensorfloat32"):
        got = jax.jit(lambda b: ntuple.feature_indices(ts, b))(
            jax.device_put(jnp.asarray(boards), gpu))
        cidx, _ = jax.jit(
            lambda b: canonical.canonical_gather_indices(ts, b)
        )(jax.device_put(jnp.asarray(boards), gpu))
    np.testing.assert_array_equal(np.asarray(got), want)
    assert int(np.asarray(cidx).max()) < ts.total


def test_class_hits_exact_and_repeatable(gpu):
    """Hit counts are small integers, so the card's atomic adds give
    the same exact counts on every run; the f32 sums agree to 1e-6."""
    ts = ntuple.get_tuple_set(5)
    rng = np.random.default_rng(1)
    boards = rng.integers(0, 6, size=(8192, 16)).astype(np.int8)
    idx = ntuple.feature_indices(ts, jnp.asarray(boards))
    dw = jnp.asarray(rng.normal(size=8192).astype(np.float32))
    valid = jnp.ones(8192, bool)
    _classes, fn = dispatch.make_class_grads(ts, "auto")
    f = jax.jit(fn)
    a, b = f(idx, dw, valid), f(idx, dw, valid)
    for (da, ha), (db, hb) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ha), np.asarray(hb))
        np.testing.assert_allclose(np.asarray(da), np.asarray(db),
                                   rtol=1e-6, atol=1e-6)
        assert float(np.asarray(ha).sum()) == 8192 * ha.shape[0]


def test_train_step_compiles_within_memory(gpu):
    """The n=6 train segment's compiled buffers fit the card."""
    from tpu2048.agent import td
    from tpu2048.config import AgentConfig, TrainConfig

    ts = ntuple.get_tuple_set(6)
    acfg = AgentConfig(n=6)
    tcfg = TrainConfig(num_envs=8192, steps_per_call=64)
    shapes = jax.eval_shape(
        lambda k: td.init_td_state(ts, acfg, tcfg, k),
        jax.random.PRNGKey(0),
    )
    mem = jax.jit(td.make_train_segment(ts, acfg, tcfg)).lower(
        shapes).compile().memory_analysis()
    need = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    limit = gpu.memory_stats()["bytes_limit"]
    assert need < limit, (need, limit)
