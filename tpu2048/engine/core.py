"""Vectorized lockstep 2048 environment.

Accelerator counterpart of the reference's stateful single-board ``Game``
class (``/root/reference/game2048/game_logic.py:48-148``): boards are a
``(N, 4, 4) int8`` batch of tile exponents, every operation is a pure
function over the whole batch, and all control flow is compiler-friendly
(static shapes, no data-dependent Python branching), so the step runs
under ``jax.jit`` across thousands of environments in lockstep.

Move resolution: each of the 4 rows is packed into a 16-bit code and the
result is gathered from the precomputed row tables (``lut.py``).  A move
in direction ``d`` is rot90^d -> slide-left -> rot90^-d, the same board
orientation trick the reference uses (``game_logic.py:136-142``) but on
the whole batch at once.  Direction encoding matches the reference:
0 = left, 1 = up, 2 = right, 3 = down.

Stochastic spawn semantics match ``game_logic.py:112-117``: new tile is
exponent 1 (tile 2) with p = 0.9 else exponent 2 (tile 4), placed
uniformly over empty cells — here with counter-based ``jax.random``
keys, one key per batched step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lut import build_row_tables

# Direction names, matching the reference's Game.actions.
ACTIONS = {0: "left", 1: "up", 2: "right", 3: "down"}

_T = build_row_tables()
# Closed over by jitted functions as constants; XLA hoists them to device.
LUT_CELLS = _T.cells  # (65536, 4) int8
LUT_SCORE = _T.score  # (65536,) int32
LUT_CHANGED = _T.changed  # (65536,) bool


class EnvState(NamedTuple):
    """Lockstep environment batch state (a pytree)."""

    boards: jax.Array  # (N, 4, 4) int8 tile exponents
    score: jax.Array  # (N,) int32 current score
    odometer: jax.Array  # (N,) int32 moves made this episode


def pack_rows(boards: jax.Array) -> jax.Array:
    """Pack (..., 4, 4) boards into (..., 4) int32 row codes."""
    b = boards.astype(jnp.int32)
    return (b[..., 0] << 12) | (b[..., 1] << 8) | (b[..., 2] << 4) | b[..., 3]


def _slide_left(boards: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Slide every row of every board left via the LUT gather.

    Returns (new_boards, score_delta (...,), changed (...,)).
    """
    codes = pack_rows(boards)  # (..., 4)
    new_boards = jnp.asarray(LUT_CELLS)[codes]  # (..., 4, 4)
    score_delta = jnp.asarray(LUT_SCORE)[codes].sum(axis=-1)
    changed = jnp.asarray(LUT_CHANGED)[codes].any(axis=-1)
    return new_boards, score_delta, changed


def move(boards: jax.Array, direction: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Apply one move direction (static int) to a (N, 4, 4) batch.

    Returns (new_boards, score_delta, changed) — the batched analogue of
    the reference's ``pre_move`` (``game_logic.py:136-142``).
    """
    ob = jnp.rot90(boards, direction, axes=(-2, -1)) if direction else boards
    nb, score_delta, changed = _slide_left(ob)
    if direction:
        nb = jnp.rot90(nb, 4 - direction, axes=(-2, -1))
    return nb, score_delta, changed


def afterstates(
    boards: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """All 4 afterstates of a (N, 4, 4) batch.

    Returns:
        aft    (4, N, 4, 4) int8 — board after each move (pre-spawn)
        delta  (4, N) int32      — score gained by each move
        legal  (4, N) bool       — whether each move changes the board
    """
    outs = [move(boards, d) for d in range(4)]
    aft = jnp.stack([o[0] for o in outs])
    delta = jnp.stack([o[1] for o in outs])
    legal = jnp.stack([o[2] for o in outs])
    return aft, delta, legal


def is_terminal(boards: jax.Array) -> jax.Array:
    """(N,) bool: no empty cell and no equal adjacent pair.

    Cheap direct test equivalent to the reference's ``game_over``
    (``game_logic.py:101-110``); also equals "no legal move".
    """
    full = (boards != 0).all(axis=(-2, -1))
    no_h = (boards[..., :, :3] != boards[..., :, 1:]).all(axis=(-2, -1))
    no_v = (boards[..., :3, :] != boards[..., 1:, :]).all(axis=(-2, -1))
    return full & no_h & no_v


def spawn(
    boards: jax.Array, key: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Place one random tile on each board of the batch.

    Tile exponent 1 with p=0.9 else 2; position uniform over empty
    cells (semantics of ``game_logic.py:112-117``).  Boards with no
    empty cell are returned unchanged (their reported value is 0).

    Returns (new_boards, pos (N,) int32 flat cell index, val (N,) int32).
    """
    n = boards.shape[0]
    flat = boards.reshape(n, 16)
    empty = flat == 0
    cnt = empty.sum(axis=1)
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (n,))
    tgt = jnp.minimum((u * cnt).astype(jnp.int32), jnp.maximum(cnt - 1, 0))
    cum = jnp.cumsum(empty, axis=1)
    pos = jnp.argmax((cum == tgt[:, None] + 1) & empty, axis=1).astype(jnp.int32)
    val = jnp.where(jax.random.uniform(kv, (n,)) < 0.9, 1, 2).astype(jnp.int32)
    has = cnt > 0
    rows = jnp.arange(n)
    cur = flat[rows, pos]
    newflat = flat.at[rows, pos].set(
        jnp.where(has, val.astype(boards.dtype), cur)
    )
    val_out = jnp.where(has, val, 0)
    return newflat.reshape(boards.shape), pos, val_out


def new_boards(n: int, key: jax.Array) -> jax.Array:
    """Fresh starting boards: two random tiles each (``game_logic.py:61-66``).

    Direct placement with the same law (and the same RNG draws) as
    ``fast.new_codes``, so codes-mode and cells-mode rollouts stay
    bitwise-identical; equals two sequential ``spawn`` calls on an
    empty board in distribution, without their cumsum/argmax chains.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    p1 = jax.random.randint(k1, (n,), 0, 16)
    v1 = jnp.where(jax.random.uniform(k2, (n,)) < 0.9, 1, 2)
    p2r = jax.random.randint(k3, (n,), 0, 15)
    p2 = p2r + (p2r >= p1)
    v2 = jnp.where(jax.random.uniform(k4, (n,)) < 0.9, 1, 2)
    cells = jnp.arange(16)[None, :]
    flat = (
        jnp.where(cells == p1[:, None], v1[:, None], 0)
        + jnp.where(cells == p2[:, None], v2[:, None], 0)
    ).astype(jnp.int8)
    return flat.reshape(n, 4, 4)


def reset_where(
    state: EnvState, done: jax.Array, key: jax.Array
) -> EnvState:
    """Reset finished environments in place (lockstep auto-reset)."""
    n = state.boards.shape[0]
    fresh = new_boards(n, key)
    mask = done[:, None, None]
    boards = jnp.where(mask, fresh, state.boards)
    score = jnp.where(done, 0, state.score)
    odometer = jnp.where(done, 0, state.odometer)
    return EnvState(boards=boards, score=score, odometer=odometer)


def init_env(n: int, key: jax.Array) -> EnvState:
    """Fresh batch of n environments."""
    return EnvState(
        boards=new_boards(n, key),
        score=jnp.zeros(n, dtype=jnp.int32),
        odometer=jnp.zeros(n, dtype=jnp.int32),
    )


def max_tile(boards: jax.Array) -> jax.Array:
    """(N,) int32 maximum tile exponent per board."""
    return boards.max(axis=(-2, -1)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Numpy single-board helpers (host-side utilities: replay, UIs, tests).
# These share the LUT but run on the host without JAX.
# ---------------------------------------------------------------------------


def np_move(board: np.ndarray, direction: int) -> Tuple[np.ndarray, int, bool]:
    """Host-side single-board move with identical semantics."""
    ob = np.rot90(board, direction) if direction else board
    codes = pack_row_np_board(ob)
    cells = _T.cells[codes]
    delta = int(_T.score[codes].sum())
    changed = bool(_T.changed[codes].any())
    nb = np.rot90(cells, 4 - direction) if direction else cells
    return nb.astype(board.dtype), delta, changed


def pack_row_np_board(board: np.ndarray) -> np.ndarray:
    b = board.astype(np.int64)
    return (b[:, 0] << 12) | (b[:, 1] << 8) | (b[:, 2] << 4) | b[:, 3]
