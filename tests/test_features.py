"""N-tuple feature engine tests: geometry counts/sizes vs the reference
registry, golden packing values, D4 symmetry closure, matmul-index
exactness (SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu2048.features import ntuple

# Reference parameter registry (r_learning.py:88) — num_feat per n and
# flat-table sizes implied by the mixed weight signatures
# (r_learning.py:136-149).
REF_COUNTS = {2: 24, 3: 52, 4: 17, 5: 21, 6: 33}
REF_TOTALS = {
    2: 24 * 16**2,
    3: 52 * 16**3,
    4: 17 * 16**4,
    5: 17 * 16**4 + 4 * 16**5,
    6: 17 * 16**4 + 4 * 16**5 + 12 * 14**6,
}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_counts_and_sizes(n):
    ts = ntuple.get_tuple_set(n)
    assert ts.num_feat == REF_COUNTS[n]
    assert ts.total == REF_TOTALS[n]
    assert ts.offsets[0] == 0
    assert (np.diff(ts.offsets) == ts.sizes[:-1]).all()


def pack_features_directly(board, n):
    """Independent scalar packing of the reference tuple geometries."""
    x = board
    out = []
    if n == 2:
        for i in range(3):
            for j in range(4):
                out.append((x[i, j] << 4) + x[i + 1, j])
        for i in range(4):
            for j in range(3):
                out.append((x[i, j] << 4) + x[i, j + 1])
    elif n == 4:
        for j in range(4):
            out.append(
                (x[0, j] << 12) + (x[1, j] << 8) + (x[2, j] << 4) + x[3, j]
            )
        for i in range(4):
            out.append(
                (x[i, 0] << 12) + (x[i, 1] << 8) + (x[i, 2] << 4) + x[i, 3]
            )
        for i in range(3):
            for j in range(3):
                out.append(
                    (x[i, j] << 12)
                    + (x[i + 1, j] << 8)
                    + (x[i, j + 1] << 4)
                    + x[i + 1, j + 1]
                )
    else:
        raise ValueError(n)
    return np.array(out, np.int64)


@pytest.mark.parametrize("n", [2, 4])
def test_golden_local_indices(rng, n):
    ts = ntuple.get_tuple_set(n)
    boards = rng.integers(0, 16, size=(16, 4, 4))
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(boards.reshape(16, 16))))
    for b in range(16):
        expect = pack_features_directly(boards[b], n) + np.asarray(ts.offsets)
        assert (idx[b] == expect).all()


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_indices_in_range(rng, n):
    ts = ntuple.get_tuple_set(n)
    boards = rng.integers(0, 16, size=(64, 16))
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(boards)))
    off = np.asarray(ts.offsets)
    sizes = np.asarray(ts.sizes)
    assert (idx >= off).all()
    assert (idx < off + sizes).all()


def test_matmul_index_exactness_extremes():
    # max-value boards exercise the largest products; must be exact in f32
    for n in (5, 6):
        ts = ntuple.get_tuple_set(n)
        b15 = jnp.full((1, 16), 15, jnp.int32)
        idx = np.asarray(ntuple.feature_indices(ts, b15))
        off = np.asarray(ts.offsets)
        sizes = np.asarray(ts.sizes)
        assert (idx == off + sizes - 1).all()


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_d4_symmetry_closure(rng, n):
    """The multiset of all-symmetry indices is invariant under any D4
    transform of the board (group closure) — the property the reference
    ``update`` relies on (r_learning.py:207-214)."""
    ts = ntuple.get_tuple_set(n)
    board = rng.integers(0, 12, size=(4, 4))
    base = np.sort(
        np.asarray(
            ntuple.all_symmetry_indices(ts, jnp.asarray(board.reshape(1, 16)))
        ).ravel()
    )
    for t in [
        board.T,
        np.rot90(board),
        np.rot90(board, 2),
        np.rot90(board, 3),
        np.rot90(board.T),
    ]:
        got = np.sort(
            np.asarray(
                ntuple.all_symmetry_indices(ts, jnp.asarray(t.reshape(1, 16).copy()))
            ).ravel()
        )
        assert (got == base).all()


def test_sym_perm_identity_first():
    ts = ntuple.get_tuple_set(4)
    assert (ts.sym_perms[0] == np.arange(16)).all()


def test_evaluate_matches_manual_sum(rng):
    ts = ntuple.get_tuple_set(4)
    w = jnp.asarray(rng.random(ts.total).astype(np.float32))
    board = rng.integers(0, 10, size=(1, 16))
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(board)))
    v = ntuple.evaluate(ts, w, jnp.asarray(board))
    assert np.allclose(np.asarray(v)[0], np.asarray(w)[idx[0]].sum(), rtol=1e-6)


def test_f6_indices_exact_and_not_bf16_safe(rng):
    """A reduced default matmul precision rounds operands (bfloat16);
    the base-14 coefficients of the 6-tuples (14^3=2744, 14^5=537824)
    are NOT bf16-representable, so ``feature_indices`` must pin
    ``Precision.HIGHEST``.  (a) demonstrate the hazard is real;
    (b) pin the shipped path against exact integer arithmetic over the
    full exponent range (up to the 2^17 max tile)."""
    import jax.numpy as jnp

    ts = ntuple.get_tuple_set(6)
    # (a) some coefficients lose bits under bf16 rounding
    rounded = np.asarray(jnp.asarray(ts.matrix, jnp.bfloat16),
                         np.float32)
    assert (rounded != ts.matrix).any(), "hazard vanished? check bases"
    # (b) shipped path == integer arithmetic, exponents 0..17
    boards = rng.integers(0, 18, size=(128, 16)).astype(np.int8)
    got = np.asarray(ntuple.feature_indices(ts, jnp.asarray(boards)))
    x = boards.astype(np.int64)
    v = np.concatenate([x, np.minimum(x, 13)], axis=-1)
    want = v @ ts.matrix.T.astype(np.int64) + ts.offsets.astype(np.int64)
    np.testing.assert_array_equal(got, want)
    # and the bf16-rounded matrix would corrupt at least one index
    corrupt = v @ rounded.T.astype(np.int64) + ts.offsets.astype(np.int64)
    assert (corrupt != want).any()


def test_n7_base16_geometry_and_closure():
    """n=7 — the beyond-reference geometry: the n=6 block layout packed
    base 16, UNCLIPPED (the packed engine caps exponents at 15, so
    every digit is valid).  Pins sizes, exact packing incl. exponents
    14/15 that base-14 would have clipped, and D4 closure of the
    canonical orbit indices."""
    import jax.numpy as jnp

    from tpu2048.features import canonical as canon
    from tpu2048.features.ntuple import _cell_tuples

    ts = ntuple.get_tuple_set(7)
    assert ts.num_feat == 33
    assert ts.total == 5_308_416 + 12 * 16 ** 6
    rng = np.random.default_rng(3)
    b = rng.integers(0, 16, size=(32, 16)).astype(np.int8)  # incl 14/15
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(b)))
    for f, (cells, base) in enumerate(_cell_tuples(7)):
        k = len(cells)
        assert base == 16
        for i in range(8):
            v = 0
            for j, (r, c) in enumerate(cells):
                v += int(b[i, r * 4 + c]) * base ** (k - 1 - j)
            assert idx[i, f] == ts.offsets[f] + v
    ci, mu = canon.canonical_gather_indices(ts, jnp.asarray(b))
    assert ci.shape == (32, 16)
    assert set(np.unique(np.asarray(mu))).issubset({1, 2, 4, 8})
    perm = ts.sym_perms[5]
    ci2, _ = canon.canonical_gather_indices(ts, jnp.asarray(b[:, perm]))
    np.testing.assert_array_equal(
        np.sort(np.asarray(ci), 1), np.sort(np.asarray(ci2), 1))
