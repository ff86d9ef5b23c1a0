"""N-tuple feature index engine.

Same tuple geometries and bit-packings as the reference feature
functions ``f_2``..``f_6`` (``/root/reference/game2048/r_learning.py:17-69``),
but re-designed for an accelerator: the index of every feature is an
integer linear function of the 16 cell exponents, so the whole index
vector for a batch of boards is ONE small matmul (exact in float32 since
all values are < 2^24), and the mixed-size per-tuple tables live at
offsets in ONE flat weight vector in device memory.

The D4 symmetry group (reference ``update``, ``r_learning.py:207-214``)
is realized as 8 precomputed 16-cell permutations, so computing the
feature indices of all 8 symmetric images costs one gather + one matmul
instead of 8 Python board transforms.

Geometry summary (tile exponents are nibbles; 6-tuples clip exponents at
13 and pack base-14, as in the reference):
    n=2: 24 adjacent pairs                      -> 16^2 entries each
    n=3: 52 adjacent triples                    -> 16^3
    n=4: 4 rows + 4 cols + 9 2x2 squares (17)   -> 16^4
    n=5: n=4 set + 4 five-cell crosses          -> 16^4 / 16^5 mixed
    n=6: n=5 set + 12 2x3/3x2 blocks            -> + 14^6 each
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Cell = Tuple[int, int]


class TupleSet(NamedTuple):
    n: int
    num_feat: int  # number of tuples
    matrix: np.ndarray  # (num_feat, 32) float32; cols 0-15 raw, 16-31 clipped@13
    offsets: np.ndarray  # (num_feat,) int32 offsets into the flat table
    sizes: np.ndarray  # (num_feat,) int32 table size per tuple
    total: int  # flat weight-table length
    sym_perms: np.ndarray  # (8, 16) int32 D4 cell permutations


def _cell_tuples(n: int) -> List[Tuple[List[Cell], int]]:
    """Tuple definitions as (ordered cells, base).

    Cell order encodes the packing: index = sum cell_value * base^(k-1-j).
    The sets and orderings mirror the reference's f_2..f_6 slicing so
    that weight tables are interchangeable feature-for-feature.
    """
    t: List[Tuple[List[Cell], int]] = []
    if n == 2:
        # vertical pairs then horizontal pairs (row-major ravel order)
        for i in range(3):
            for j in range(4):
                t.append(([(i, j), (i + 1, j)], 16))
        for i in range(4):
            for j in range(3):
                t.append(([(i, j), (i, j + 1)], 16))
    elif n == 3:
        for i in range(2):
            for j in range(4):
                t.append(([(i, j), (i + 1, j), (i + 2, j)], 16))
        for i in range(4):
            for j in range(2):
                t.append(([(i, j), (i, j + 1), (i, j + 2)], 16))
        # bent triples per 2x2 square, excluding one corner each
        for i in range(3):
            for j in range(3):
                t.append(([(i + 1, j), (i + 1, j + 1), (i, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i + 1, j), (i + 1, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i, j + 1), (i + 1, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i + 1, j), (i, j + 1)], 16))
    elif n in (4, 5, 6, 7):
        for j in range(4):  # columns
            t.append(([(0, j), (1, j), (2, j), (3, j)], 16))
        for i in range(4):  # rows
            t.append(([(i, 0), (i, 1), (i, 2), (i, 3)], 16))
        for i in range(3):  # 2x2 squares
            for j in range(3):
                t.append(
                    ([(i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1)], 16)
                )
        if n >= 5:
            # 4 five-cell crosses around the middle cells
            for a in range(2):
                for b in range(2):
                    t.append(
                        (
                            [
                                (1 + a, 1 + b),
                                (a, 1 + b),
                                (1 + a, b),
                                (2 + a, 1 + b),
                                (1 + a, 2 + b),
                            ],
                            16,
                        )
                    )
        if n >= 6:
            # Six-cell blocks.  n=6: base 14 with exponents clipped at
            # 13, the reference's packing (r_learning.py:58-69) — its
            # own documented representational ceiling past the 8192
            # tile.  n=7 (beyond the reference): the SAME 12 block
            # geometries packed base 16, unclipped — the packed-code
            # engine caps exponents at 15 (4-bit nibbles), so every
            # digit is valid and tiles up to 32768 stay distinguishable
            # at the cost of a 16.8M-entry table per block (12x16^6 +
            # the n=5 set = 206.7M weights).
            base6 = 14 if n == 6 else 16
            # 3x2 vertical blocks
            for a in range(2):
                for b in range(3):
                    t.append(
                        (
                            [
                                (a, b),
                                (a + 1, b),
                                (a + 2, b),
                                (a, b + 1),
                                (a + 1, b + 1),
                                (a + 2, b + 1),
                            ],
                            base6,
                        )
                    )
            # 2x3 horizontal blocks
            for a in range(3):
                for b in range(2):
                    t.append(
                        (
                            [
                                (a, b),
                                (a, b + 1),
                                (a, b + 2),
                                (a + 1, b),
                                (a + 1, b + 1),
                                (a + 1, b + 2),
                            ],
                            base6,
                        )
                    )
    else:
        raise ValueError(f"unsupported tuple order n={n}")
    return t


def _d4_perms() -> np.ndarray:
    """8 cell permutations p with T(b).ravel()[c] == b.ravel()[p[c]]."""
    grid = np.arange(16).reshape(4, 4)
    perms = []
    g = grid
    for _ in range(4):
        perms.append(g.ravel())
        perms.append(g.T.ravel())
        g = np.rot90(g)
    return np.stack(perms).astype(np.int32)


@lru_cache(maxsize=None)
def get_tuple_set(n: int) -> TupleSet:
    tuples = _cell_tuples(n)
    num_feat = len(tuples)
    matrix = np.zeros((num_feat, 32), dtype=np.float32)
    sizes = np.zeros(num_feat, dtype=np.int64)
    for f, (cells, base) in enumerate(tuples):
        k = len(cells)
        col0 = 0 if base == 16 else 16  # clipped values live in cols 16-31
        for j, (i, jj) in enumerate(cells):
            matrix[f, col0 + i * 4 + jj] += float(base ** (k - 1 - j))
        sizes[f] = base**k
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    total = int(sizes.sum())
    assert total < 2**31, "flat table must be int32-indexable"
    # the f32 index matmuls (feature_indices, canonical._orbit_pack)
    # are exact only while every PER-CLASS packed index stays at or
    # below the f32 exact-integer boundary 2^24 - 1 (n=7's base-16
    # six-tuples sit exactly there); a future base/arity bump past it
    # would silently wrap indices, so fail loudly here instead
    assert int(sizes.max()) - 1 <= 2**24 - 1, (
        f"per-class packed index max {int(sizes.max()) - 1} exceeds the "
        "f32 exact-integer range; the index matmul would corrupt indices"
    )
    return TupleSet(
        n=n,
        num_feat=num_feat,
        matrix=matrix,
        offsets=offsets.astype(np.int32),
        sizes=sizes.astype(np.int32),
        total=total,
        sym_perms=_d4_perms(),
    )


def feature_indices(ts: TupleSet, flat_boards: jax.Array) -> jax.Array:
    """(..., 16) exponent vectors -> (..., num_feat) int32 flat-table indices.

    One float32 matmul; exact because indices < 2^24 — but ONLY at full
    float32 precision: a reduced default matmul precision (TF32 on an
    NVIDIA GPU keeps 10 mantissa bits, bf16 keeps 7) rounds operands and
    products, and the base-14 coefficients of the 6-tuples (14^3 = 2744,
    14^5 = 537824) and the sums up to 16^6 - 1 at n=7 need all 24 bits.
    ``Precision.HIGHEST`` forces the exact f32 path on every backend.
    """
    x = flat_boards.astype(jnp.float32)
    xc = jnp.minimum(x, 13.0)
    v = jnp.concatenate([x, xc], axis=-1)  # (..., 32)
    local = jnp.dot(
        v,
        jnp.asarray(ts.matrix).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return local.astype(jnp.int32) + jnp.asarray(ts.offsets)


def all_symmetry_indices(ts: TupleSet, flat_boards: jax.Array) -> jax.Array:
    """(..., 16) -> (..., 8, num_feat) indices for all D4 board images."""
    permuted = flat_boards[..., jnp.asarray(ts.sym_perms)]  # (..., 8, 16)
    return feature_indices(ts, permuted)


def init_weights(ts: TupleSet, key: jax.Array) -> jax.Array:
    """U[0, 0.01) init, matching the reference (``r_learning.py:136-149``)."""
    return jax.random.uniform(key, (ts.total,), jnp.float32) * 0.01


def evaluate(ts: TupleSet, weights: jax.Array, flat_boards: jax.Array) -> jax.Array:
    """V(s) = sum of the num_feat gathered weights (``r_learning.py:202-203``)."""
    idx = feature_indices(ts, flat_boards)
    return weights[idx].sum(axis=-1)
