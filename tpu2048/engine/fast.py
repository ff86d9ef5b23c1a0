"""Packed row-code engine: boards as (N, 4) int32 row codes.

The cells engine (``core.py``) mirrors the board layout of the
reference; this variant is the bandwidth-lean device representation: each
board is 4 packed 16-bit row codes, so

  * left/right moves are single LUT gathers on the codes themselves —
    no rot90 relayouts, no (N, 4, 4) int8 materialization; the right
    tables are pre-composed reversals (rev . left . rev), so neither
    direction flips anything at runtime;
  * up/down transpose the 4 codes with pure integer nibble arithmetic
    (shifts/masks) and use the same left/right tables, with the
    result kept in TRANSPOSED orientation: the n-tuple feature matmul
    for those directions simply uses a column-permuted matrix, which
    yields bit-identical CANONICAL feature indices — only the one
    chosen afterstate is ever transposed back;
  * new-code + changed-bit are packed in one int32 LUT
    (``code | changed << 16``), halving engine gather traffic vs the
    cells/score/changed triple.

Per step this costs 16 two-table gathers per board (the theoretical
floor for 4-direction LUT resolution) and ~30 VPU integer ops; it is
numerically and RNG-trajectory identical to the cells engine (tests
assert bitwise-equal rollouts).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lut import RowTables, build_row_tables, pack_row_np


class CodeTables(NamedTuple):
    left_nc: np.ndarray  # (65536,) int32: newcode | changed << 16
    left_sc: np.ndarray  # (65536,) int32: score
    right_nc: np.ndarray
    right_sc: np.ndarray
    dir_sc: np.ndarray  # (131072,) int32: [left_sc; right_sc] concatenated
    quad: np.ndarray  # (65536, 4) int32: [l_nc, r_nc, l_sc, r_sc] rows


@lru_cache(maxsize=None)
def build_code_tables() -> CodeTables:
    t: RowTables = build_row_tables()
    codes = np.arange(65536, dtype=np.int64)
    nibbles = np.stack([(codes >> s) & 0xF for s in (12, 8, 4, 0)], axis=1)
    rev = pack_row_np(nibbles[:, ::-1]).astype(np.int64)
    left_nc = (t.codes.astype(np.int64) | (t.changed.astype(np.int64) << 16)
               ).astype(np.int32)
    left_sc = t.score.astype(np.int32)
    # right = rev . left . rev, fully precomposed
    r_cells = t.cells[rev][:, ::-1]
    r_codes = pack_row_np(r_cells.astype(np.int64))
    right_nc = (r_codes | (t.changed[rev].astype(np.int64) << 16)
                ).astype(np.int32)
    right_sc = t.score[rev].astype(np.int32)
    # one table addressable as dir_sc[family << 16 | code] so the score
    # of the one CHOSEN direction costs 4 gathers instead of 16
    dir_sc = np.concatenate([left_sc, right_sc])
    # row-fused layout: one 16-byte slice per row code resolves BOTH
    # directions and both scores — the whole 4-direction expansion of a
    # board costs 8 sliced gathers (4 rows x 2 orientations) instead of
    # 16-32 scalar gathers (fewer, wider fetches)
    quad = np.stack([left_nc, right_nc, left_sc, right_sc], axis=1)
    return CodeTables(left_nc, left_sc, right_nc, right_sc, dir_sc, quad)


_CT = build_code_tables()


class EnvStateC(NamedTuple):
    """Lockstep env batch in packed form (a pytree)."""

    codes: jax.Array  # (N, 4) int32 row codes
    score: jax.Array  # (N,) int32
    odometer: jax.Array  # (N,) int32


# -- representation conversions ---------------------------------------------


def codes_from_boards(boards: jax.Array) -> jax.Array:
    b = boards.astype(jnp.int32)
    return (b[..., 0] << 12) | (b[..., 1] << 8) | (b[..., 2] << 4) | b[..., 3]


def boards_from_codes(codes: jax.Array) -> jax.Array:
    n = [(codes >> s) & 0xF for s in (12, 8, 4, 0)]
    return jnp.stack(n, axis=-1).astype(jnp.int8)


def cells_from_codes(codes: jax.Array) -> jax.Array:
    """(..., 4) codes -> (..., 16) int32 cell exponents (row-major)."""
    parts = [(codes >> s) & 0xF for s in (12, 8, 4, 0)]
    return jnp.stack(parts, axis=-1).reshape(codes.shape[:-1] + (16,))


def transpose_codes(codes: jax.Array) -> jax.Array:
    """Board transpose in code space (pure integer shifts/masks)."""
    c0 = codes[..., 0]
    c1 = codes[..., 1]
    c2 = codes[..., 2]
    c3 = codes[..., 3]
    out = []
    for j in range(4):
        sh = 12 - 4 * j
        t = (
            (((c0 >> sh) & 0xF) << 12)
            | (((c1 >> sh) & 0xF) << 8)
            | (((c2 >> sh) & 0xF) << 4)
            | ((c3 >> sh) & 0xF)
        )
        out.append(t)
    return jnp.stack(out, axis=-1)


# -- move resolution --------------------------------------------------------


def afterstates_codes(
    codes: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """All 4 afterstates of a (N, 4) code batch.

    Returns:
        aft    (4, N, 4) int32 — afterstate codes; directions 1 (up)
               and 3 (down) are in TRANSPOSED orientation
        delta  (4, N) int32
        legal  (4, N) bool
    Direction encoding matches the reference: 0 left, 1 up, 2 right,
    3 down (up/down = left/right on the transposed board).

    Implementation: one 16-byte sliced gather per row from the fused
    quad table resolves both direction families and both scores — 8
    gathers per board for the full 4-direction expansion.
    """
    quad = jnp.asarray(_CT.quad)
    tcodes = transpose_codes(codes)

    def resolve(c):
        q = quad[c]  # (N, 4, 4): [l_nc, r_nc, l_sc, r_sc] per row
        l_new = q[..., 0] & 0xFFFF
        r_new = q[..., 1] & 0xFFFF
        l_ch = (q[..., 0] >> 16).astype(bool).any(axis=-1)
        r_ch = (q[..., 1] >> 16).astype(bool).any(axis=-1)
        l_d = q[..., 2].sum(axis=-1)
        r_d = q[..., 3].sum(axis=-1)
        return l_new, r_new, l_ch, r_ch, l_d, r_d

    l_new, r_new, l_ch, r_ch, l_d, r_d = resolve(codes)
    u_new, d_new, u_ch, d_ch, u_d, d_d = resolve(tcodes)
    aft = jnp.stack([l_new, u_new, r_new, d_new])
    delta = jnp.stack([l_d, u_d, r_d, d_d])
    legal = jnp.stack([l_ch, u_ch, r_ch, d_ch])
    return aft, delta, legal


def afterstates_nc(
    codes: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """All 4 afterstates WITHOUT score resolution: 16 gathers total,
    the floor for 4-direction LUT resolution.

    Greedy selection never consumes the scores of unchosen moves, so
    a score-light caller can pair this with ``chosen_delta`` (4 more
    gathers for the one move taken) instead of the 16 score gathers
    of ``afterstates_codes``.  The shipped train step instead uses
    ``afterstates_full`` (fused quad tables: afterstates, legality
    AND all scores in 8 sliced gathers — cheaper than 16+4), so this
    pairing survives as the portable non-quad formulation and for
    callers that want the absolute-minimum gather count per move.

    Returns (aft (4, N, 4), legal (4, N), tcodes (N, 4)); directions
    1/3 are in TRANSPOSED orientation, as in ``afterstates_codes``.
    """
    lnc = jnp.asarray(_CT.left_nc)
    rnc = jnp.asarray(_CT.right_nc)
    tcodes = transpose_codes(codes)

    def resolve(nc, c):
        packed = nc[c]  # (N, 4)
        new = packed & 0xFFFF
        changed = (packed >> 16).astype(bool).any(axis=-1)
        return new, changed

    l_new, l_ch = resolve(lnc, codes)
    r_new, r_ch = resolve(rnc, codes)
    u_new, u_ch = resolve(lnc, tcodes)
    d_new, d_ch = resolve(rnc, tcodes)
    aft = jnp.stack([l_new, u_new, r_new, d_new])
    legal = jnp.stack([l_ch, u_ch, r_ch, d_ch])
    return aft, legal, tcodes


def afterstates_full(
    codes: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """``afterstates_codes`` + the transposed codes (saves recomputing
    them for ``canonicalize``-style consumers): (aft, delta, legal,
    tcodes).  This is the production hot path — 8 sliced gathers."""
    quad = jnp.asarray(_CT.quad)
    tcodes = transpose_codes(codes)

    def resolve(c):
        q = quad[c]  # (N, 4, 4)
        return (q[..., 0] & 0xFFFF, q[..., 1] & 0xFFFF,
                (q[..., 0] >> 16).astype(bool).any(axis=-1),
                (q[..., 1] >> 16).astype(bool).any(axis=-1),
                q[..., 2].sum(axis=-1), q[..., 3].sum(axis=-1))

    l_new, r_new, l_ch, r_ch, l_d, r_d = resolve(codes)
    u_new, d_new, u_ch, d_ch, u_d, d_d = resolve(tcodes)
    aft = jnp.stack([l_new, u_new, r_new, d_new])
    delta = jnp.stack([l_d, u_d, r_d, d_d])
    legal = jnp.stack([l_ch, u_ch, r_ch, d_ch])
    return aft, delta, legal, tcodes


def chosen_delta(
    codes: jax.Array, tcodes: jax.Array, best_dir: jax.Array
) -> jax.Array:
    """Score delta of ONLY the chosen direction (4 gathers).

    Directions 0/2 score the original codes through the left/right
    tables; 1/3 score the transposed codes.  The left/right family
    selects the half of the combined ``dir_sc`` table.
    """
    dsc = jnp.asarray(_CT.dir_sc)
    cot = jnp.where((best_dir % 2 == 1)[:, None], tcodes, codes)
    fam = (best_dir >= 2).astype(jnp.int32)[:, None] << 16
    return dsc[cot | fam].sum(axis=-1)


def canonicalize_chosen(aft_codes: jax.Array, best_dir: jax.Array
                        ) -> jax.Array:
    """Transpose the chosen afterstate back when it came from up/down."""
    t = transpose_codes(aft_codes)
    need_t = ((best_dir % 2) == 1)[:, None]
    return jnp.where(need_t, t, aft_codes)


# -- stochastic spawn / reset ----------------------------------------------


def spawn_codes(
    codes: jax.Array, key: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Same spawn law and RNG draw structure as ``core.spawn`` —
    rollouts are bitwise-identical to the cells engine."""
    n = codes.shape[0]
    flat = cells_from_codes(codes)  # (N, 16)
    empty = flat == 0
    cnt = empty.sum(axis=1)
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (n,))
    tgt = jnp.minimum((u * cnt).astype(jnp.int32), jnp.maximum(cnt - 1, 0))
    cum = jnp.cumsum(empty, axis=1)
    pos = jnp.argmax((cum == tgt[:, None] + 1) & empty, axis=1).astype(
        jnp.int32
    )
    val = jnp.where(jax.random.uniform(kv, (n,)) < 0.9, 1, 2).astype(
        jnp.int32
    )
    has = cnt > 0
    row, col = pos // 4, pos % 4
    add = jnp.where(has, val << ((3 - col) * 4), 0)
    one_hot_row = row[:, None] == jnp.arange(4)[None, :]
    codes_out = codes + jnp.where(one_hot_row, add[:, None], 0)
    return codes_out, pos, jnp.where(has, val, 0)


def new_codes(n: int, key: jax.Array) -> jax.Array:
    """Fresh starting boards: two random tiles each.

    Same law as two sequential ``spawn_codes`` on an empty board
    (first tile uniform over 16 cells, second uniform over the 15
    remaining, values 2/4 at 0.9/0.1) but placed DIRECTLY: no empty
    masks, cumsums, or argmax chains.  ``reset_where_codes`` runs this
    on the full batch every step, so it is hot.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    p1 = jax.random.randint(k1, (n,), 0, 16)
    v1 = jnp.where(jax.random.uniform(k2, (n,)) < 0.9, 1, 2)
    p2r = jax.random.randint(k3, (n,), 0, 15)
    p2 = p2r + (p2r >= p1)
    v2 = jnp.where(jax.random.uniform(k4, (n,)) < 0.9, 1, 2)
    rows = jnp.arange(4)[None, :]
    add1 = jnp.where(rows == (p1 // 4)[:, None],
                     (v1 << ((3 - p1 % 4) * 4))[:, None], 0)
    add2 = jnp.where(rows == (p2 // 4)[:, None],
                     (v2 << ((3 - p2 % 4) * 4))[:, None], 0)
    return (add1 + add2).astype(jnp.int32)


def reset_where_codes(
    state: EnvStateC, done: jax.Array, key: jax.Array
) -> EnvStateC:
    n = state.codes.shape[0]
    fresh = new_codes(n, key)
    codes = jnp.where(done[:, None], fresh, state.codes)
    return EnvStateC(
        codes=codes,
        score=jnp.where(done, 0, state.score),
        odometer=jnp.where(done, 0, state.odometer),
    )


def init_env_codes(n: int, key: jax.Array) -> EnvStateC:
    return EnvStateC(
        codes=new_codes(n, key),
        score=jnp.zeros(n, jnp.int32),
        odometer=jnp.zeros(n, jnp.int32),
    )


def max_tile_codes(codes: jax.Array) -> jax.Array:
    return cells_from_codes(codes).max(axis=-1).astype(jnp.int32)
