"""Batched evaluation driver.

Capability parity with ``QAgent.trial``
(``/root/reference/game2048/r_learning.py:348-406``): play N full games
with a trained agent (optionally deepened by expectimax), then report
average score, tile-reach percentages, top-3 final boards, timing and
per-move cost, and save the best game — but the N games run in lockstep
on device, each played exactly once (active-mask, no auto-reset), with
move/spawn logs recorded for replay.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..agent import td
from ..config import SearchConfig
from ..engine import core as engine
from ..features import ntuple
from ..obs.logging import Logger
from ..search.expectimax import make_compacted_estimator


class TrialResult(NamedTuple):
    scores: np.ndarray  # (N,) final scores
    tiles: np.ndarray  # (N,) final max-tile exponents
    odometers: np.ndarray  # (N,) moves per game
    final_boards: np.ndarray  # (N,4,4)
    elapsed: float
    report: str
    best_game: Optional[Dict[str, Any]]  # replayable record


class _EvalState(NamedTuple):
    codes: jax.Array  # (N, 4) int32 packed row codes
    score: jax.Array
    odometer: jax.Array
    active: jax.Array
    key: jax.Array
    moves: jax.Array  # (N,S) int8
    spawns: jax.Array  # (N,S) int8


# transposed-cell -> canonical-cell permutation (see agent/td.py)
_TPERM = np.arange(16).reshape(4, 4).T.reshape(16)


def _make_eval_segment(ts, scfg: SearchConfig, n: int, s_cap: int,
                       k: int, limit_tile: int, table_ops: str = "auto",
                       policy: str = "value"):
    """Eval step on the packed row-code engine (``engine/fast.py``):
    8 sliced LUT gathers resolve the full 4-direction expansion with
    scores and legality, no rot90 relayouts — the same representation
    as the training hot path (~2x the cells-engine throughput)."""
    from ..engine import fast as engf
    from ..ops import dispatch as table_dispatch

    if policy == "value":
        eval_fn = table_dispatch.make_evaluator(ts, table_ops)
    elif policy not in ("random", "score"):
        raise ValueError(f"unknown policy: {policy}")
    tperm = jnp.asarray(_TPERM)

    # ``weights`` is threaded through as a jit ARGUMENT, never a
    # closure: a closed-over jax.Array lowers as an embedded HLO
    # constant, and the n=6 table (12*14^6 f32 entries, ~0.4 GB)
    # would bloat the compile payload and executable for every
    # geometry.
    def step(st: _EvalState, weights) -> _EvalState:
        key, k_est, k_spawn = jax.random.split(st.key, 3)
        aft, delta, legal, _t = engf.afterstates_full(st.codes)
        # canonical cells for all 4 afterstates (up/down come back
        # transposed; a cell permutation restores canonical order)
        cells4 = engf.cells_from_codes(aft)  # (4, N, 16)
        cells4 = jnp.stack(
            [cells4[0], cells4[1][..., tperm],
             cells4[2], cells4[3][..., tperm]]
        )
        if policy == "random":
            # the reference's random_eval baseline (game_logic.py:5-6):
            # a uniform value per candidate move
            vals = jax.random.uniform(k_est, (4, n))
        elif policy == "score":
            # score_eval (game_logic.py:9-10): greedy on immediate reward
            vals = delta.astype(jnp.float32)
        else:
            def value_fn(b):
                return eval_fn(weights, b.reshape(b.shape[:-2] + (16,)))

            if scfg.depth == 0:
                vals = eval_fn(weights, cells4)  # (4, N)
            else:
                # root compaction: only legal afterstates of still-
                # active games that are crowded enough to search
                # (empty < since_empty) enter the tree; everything
                # else takes its base estimate, which is exactly what
                # the reference's pruning returns for them anyway.
                aftc = jnp.stack([
                    aft[0], engf.transpose_codes(aft[1]),
                    aft[2], engf.transpose_codes(aft[3]),
                ]).reshape(4 * n, 4)  # canonical codes
                empty_cnt = (cells4.reshape(4 * n, 16) == 0).sum(axis=1)
                act = jnp.broadcast_to(
                    st.active[None, :], (4, n)
                ).reshape(4 * n)
                need = (
                    legal.reshape(4 * n)
                    & act
                    & (empty_cnt < scfg.since_empty)
                )
                estimator = make_compacted_estimator(
                    value_fn, scfg.depth, scfg.width, scfg.since_empty,
                    batch=4 * n, input_rep="codes",
                )
                vals = estimator(aftc, k_est, need).reshape(4, n)
        masked = jnp.where(legal, vals, -jnp.inf)
        best_dir = jnp.argmax(masked, axis=0).astype(jnp.int32)
        ar = jnp.arange(n)
        # 4-way masked merge instead of a batched gather select (same
        # elements; measured faster in-scan — see agent/td.py ``_sel``)
        aft_sel = aft[0]
        best_delta = delta[0]
        for d in (1, 2, 3):
            h = best_dir == d
            aft_sel = jnp.where(h[:, None], aft[d], aft_sel)
            best_delta = jnp.where(h, delta[d], best_delta)
        chosen = engf.canonicalize_chosen(aft_sel, best_dir)
        done = ~legal.any(axis=0)
        stepping = st.active & ~done
        moved = jnp.where(stepping[:, None], chosen, st.codes)
        spawned, pos, val = engf.spawn_codes(moved, k_spawn)
        codes = jnp.where(stepping[:, None], spawned, st.codes)
        # drop-mode writes: non-stepping lanes target slot s_cap (out
        # of range, silently dropped) — no read-modify-write gathers
        sp = (pos | ((val - 1) << 4)).astype(jnp.int8)
        wslot = jnp.where(
            stepping, jnp.minimum(st.odometer, s_cap - 1), s_cap
        )
        moves = st.moves.at[ar, wslot].set(
            best_dir.astype(jnp.int8), mode="drop"
        )
        spawns = st.spawns.at[ar, wslot].set(sp, mode="drop")
        score = jnp.where(stepping, st.score + best_delta, st.score)
        odometer = jnp.where(stepping, st.odometer + 1, st.odometer)
        active = st.active & ~done
        if limit_tile:
            active = active & (engf.max_tile_codes(codes) < limit_tile)
        return _EvalState(codes, score, odometer, active, key, moves, spawns)

    def segment(st: _EvalState, weights) -> _EvalState:
        def body(s, _):
            return step(s, weights), None

        out, _ = jax.lax.scan(body, st, None, length=k)
        return out

    return segment


def trial(
    ts: ntuple.TupleSet,
    weights: Optional[jax.Array],
    num: int = 20,
    seed: int = 0,
    search: Optional[SearchConfig] = None,
    limit_tile: int = 0,
    step_cap: int = 32768,
    steps_per_call: int = 256,
    logger: Optional[Logger] = None,
    game_init: Optional[np.ndarray] = None,
    progress_cb=None,
    stop_cb=None,
    policy: str = "value",
    table_ops: str = "auto",
) -> TrialResult:
    """Play ``num`` games to completion; aggregate statistics.

    ``policy`` selects the estimator: "value" (the trained n-tuple
    table, optionally deepened by expectimax), or the reference's
    baselines "random" / "score" (``game_logic.py:5-10``) — weights
    may be None for those.
    """
    scfg = search or SearchConfig(depth=0)
    log = logger or Logger(console=False)
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    from ..engine import fast as engf

    if game_init is not None:
        codes = jnp.broadcast_to(
            engf.codes_from_boards(jnp.asarray(game_init, jnp.int8)),
            (num, 4),
        )
    else:
        codes = engf.new_codes(num, k_init)  # same draws as new_boards
    st = _EvalState(
        codes=codes,
        score=jnp.zeros(num, jnp.int32),
        odometer=jnp.zeros(num, jnp.int32),
        active=jnp.ones(num, bool),
        key=key,
        moves=jnp.zeros((num, step_cap), jnp.int8),
        spawns=jnp.zeros((num, step_cap), jnp.int8),
    )
    starts = np.asarray(engf.boards_from_codes(st.codes), np.int8)
    if weights is None:
        weights = jnp.zeros((0,), jnp.float32)  # baselines ignore it
    seg = jax.jit(
        _make_eval_segment(
            ts, scfg, num, step_cap, steps_per_call, limit_tile,
            table_ops=table_ops, policy=policy,
        ),
        donate_argnums=0,
    )
    t0 = time.time()
    prev_active = np.ones(num, bool)
    while True:
        if stop_cb is not None and stop_cb():
            break
        st = seg(st, weights)
        active_np = np.asarray(st.active)
        n_active = int(active_np.sum())
        # per-game completion log, the reference's live trial progress
        # (``r_learning.py:374-375``): each game's score/moves as it
        # finishes, plus a running average over completed games
        newly = np.nonzero(prev_active & ~active_np)[0]
        if newly.size:
            scores_np = np.asarray(st.score)
            odos_np = np.asarray(st.odometer)
            for i in newly:
                log.add(
                    f"game {int(i) + 1}/{num}: score = "
                    f"{int(scores_np[i])}, moves = {int(odos_np[i])}"
                )
            done_mask = ~active_np
            log.add(
                f"-- {int(done_mask.sum())}/{num} games done, running "
                f"average = {float(scores_np[done_mask].mean()):.1f}, "
                f"{round(time.time() - t0, 1)} s elapsed"
            )
        prev_active = active_np
        if progress_cb is not None:
            progress_cb(st)
        if n_active == 0:
            break
        if int(np.asarray(st.odometer.max())) >= step_cap:
            log.add(f"step cap {step_cap} reached with {n_active} active")
            break
    elapsed = time.time() - t0

    scores = np.asarray(st.score)
    tiles = np.asarray(engf.max_tile_codes(st.codes))
    odos = np.asarray(st.odometer)
    finals = np.asarray(engf.boards_from_codes(st.codes))
    order = np.argsort(-scores)

    def share(exp: int) -> float:
        return float((tiles >= exp).mean() * 100)

    lines = ["\nBest games:"]
    for i in order[:3]:
        for row in finals[i]:
            lines.append(
                "".join(f"{(1 << int(v)) if v else 0}".ljust(7) for v in row)
            )
        lines.append(f"score = {scores[i]} moves = {odos[i]} "
                     f"reached {1 << int(tiles[i])}\n")
    total_moves = int(odos.sum())
    # "shuffle" statistics, the reference's Game.counter perf report
    # (``r_learning.py:396-398`` / ``game_logic.py:52,137``): one
    # shuffle = one row-LUT move resolution (pre_move equivalent).
    # Each move resolves the 4 root afterstates, and with search each
    # chance child resolves 4 more at every level.  This counts the
    # FULL fixed-shape tree and is therefore an UPPER BOUND on executed
    # work: root compaction dispatches only the roots that need search
    # into the tree, so most moves skip it entirely (the report labels
    # the figures accordingly).
    expand = 0  # pre_move-equivalents per searched board
    for _ in range(scfg.depth):
        expand = scfg.width * (4 + 4 * expand)
    shuffles_per_move = 4 + 4 * expand
    total_shuffles = total_moves * shuffles_per_move
    lines += [
        f"average score of {num} runs = {round(float(scores.mean()), 3)}",
        f"16384 reached in {share(14)}%",
        f"8192 reached in {share(13)}%",
        f"4096 reached in {share(12)}%",
        f"2048 reached in {share(11)}%",
        f"1024 reached in {share(10)}%",
        f"total time = {round(elapsed, 2)}",
        f"average time per move = "
        f"{round(elapsed / max(total_moves, 1) * 1000, 3)} ms",
        f"total env-moves = {total_moves}",
        f"total shuffles = {total_shuffles} "
        f"({shuffles_per_move} per move"
        + (", upper bound: compacted roots skip the tree)"
           if scfg.depth > 0 else ")"),
        f"average time per shuffle = "
        f"{round(elapsed / max(total_shuffles, 1) * 1000, 4)} ms"
        + (" (lower bound)" if scfg.depth > 0 else ""),
    ]
    report = "\n".join(lines)
    log.add(report)

    best = int(order[0])
    if int(odos[best]) >= step_cap:
        best_game = None  # log overflowed; replay would be wrong
    else:
        best_game = _game_record(
            starts[best],
            np.asarray(st.moves)[best],
            np.asarray(st.spawns)[best],
            int(odos[best]),
        )
    return TrialResult(
        scores=scores,
        tiles=tiles,
        odometers=odos,
        final_boards=finals,
        elapsed=elapsed,
        report=report,
        best_game=best_game,
    )


def _game_record(start, moves, spawns, length) -> Dict[str, Any]:
    """Replay device logs into a portable game record."""
    board = np.asarray(start, np.int8).copy()
    score = 0
    tiles: List = []
    length = min(length, len(moves))
    for t in range(length):
        nb, delta, _ = engine.np_move(board, int(moves[t]))
        score += delta
        sp = int(spawns[t]) & 0xFF
        pos, val = sp & 0xF, (sp >> 4) + 1
        nb = nb.reshape(16).copy()
        nb[pos] = val
        board = nb.reshape(4, 4)
        tiles.append((val, pos // 4, pos % 4))
    return {
        "starting_position": np.asarray(start, np.int8),
        "moves": np.asarray(moves[:length], np.int8),
        "tiles": np.asarray(tiles, np.int8).reshape(-1, 3),
        "score": score,
        "odometer": length,
        "final_board": board,
    }
