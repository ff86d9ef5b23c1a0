"""On-device TD(0) n-tuple actor–learner.

Capability parity with the reference ``QAgent`` (``/root/reference/
game2048/r_learning.py:85-346``), re-designed for an accelerator:
instead of one sequential game with per-move Python list updates, N
environments step in lockstep under ``jit``; afterstate values are
weight-table gathers, greedy action selection is a masked argmax over
the 4 afterstates, and the TD update is a batched scatter-add over the
feature indices of all 8 D4-symmetric board images.

Semantics preserved from the reference ``episode`` loop
(``r_learning.py:224-252``):
  * gamma = 1, epsilon = 0 (greedy, no exploration);
  * per move, the update to the PREVIOUS afterstate is
    ``dw = (reward + V(s'_best) - V(s_prev)) * alpha / num_feat`` where
    the reward is the score delta of the chosen move and ``V(s'_best)``
    is evaluated with the weights BEFORE this step's update;
  * at game over the last afterstate gets ``dw = -V(s_last) * alpha /
    num_feat``;
  * the same ``dw`` is added to the features of all 8 symmetric images;
  * alpha decays by ``decay`` every ``decay_step`` episodes and whenever
    a new maximum tile is reached, floored at ``low_alpha_limit``
    (``r_learning.py:257-261, 292-294, 310-313``).

Documented semantic delta (SURVEY §7 hard part 2): the reference
updates the table after every single move of ONE game; the lockstep
batch applies the updates of N in-flight games at once (mini-batch
TD(0), index collisions summed).  Update numerics are pinned against
scalar re-derivations in ``tests/test_td.py`` and against the explicit
8-image scatter in ``tests/test_canonical.py``; learning-curve quality
is documented in ``QUALITY.md``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AgentConfig, TrainConfig
from ..engine import core as engine
from ..features import ntuple


class Metrics(NamedTuple):
    """Device-resident episode statistics (host reads periodically)."""

    episodes: jax.Array  # i32 scalar, completed episodes
    score_ring: jax.Array  # (R+1,) i32 completed-episode scores (slot R = trash)
    tile_ring: jax.Array  # (R+1,) i32 max tile exponent at completion
    ring_pos: jax.Array  # i32 monotonic write counter
    best_score: jax.Array  # i32 best completed-episode score


class Recorder(NamedTuple):
    """Trajectory capture for a subset of envs + best-game snapshot.

    Replaces the reference's per-game ``moves``/``tiles`` logs
    (``game_logic.py:55-70``) with fixed-shape device buffers; the best
    finished recorded game is kept replayable (SURVEY §7 hard part 5).
    Spawn byte layout: ``pos | (val-1) << 4``.
    """

    moves: jax.Array  # (R_env, S) i8
    spawns: jax.Array  # (R_env, S) i8
    starts: jax.Array  # (R_env, 4, 4) i8
    overflow: jax.Array  # (R_env,) bool — game outran S; not replayable
    best_moves: jax.Array  # (S,) i8
    best_spawns: jax.Array  # (S,) i8
    best_start: jax.Array  # (4, 4) i8
    best_len: jax.Array  # i32
    best_score: jax.Array  # i32


def record_env_count(tcfg: TrainConfig) -> int:
    """Number of envs with trajectory recording: ``record_envs`` <= 0
    means ALL envs (true best-game capture, the default)."""
    n = tcfg.num_envs
    r = tcfg.record_envs
    return n if r <= 0 else max(1, min(r, n))


def _num_sym(acfg: AgentConfig) -> int:
    """Width of the per-step scatter index block: 8 board images only
    for the explicit-index "scatter" implementation; identity for the
    dense-fold / canonical implementations and the "periodic"/"none"
    modes (the 8x coupling arrives through table transforms or
    canonical-orbit indices instead)."""
    if acfg.sym_mode == "scatter" and acfg.sym_impl == "index":
        return 8
    return 1


def _is_canonical(acfg: AgentConfig) -> bool:
    return acfg.sym_mode == "scatter" and acfg.sym_impl == "canonical"


def _canon_feat_count(ts: ntuple.TupleSet, acfg: AgentConfig) -> int:
    """K: gather-class feature count under canonical mode, else 0."""
    if not _is_canonical(acfg):
        return 0
    from ..features.canonical import gather_feat_count

    return gather_feat_count(ts)


class TDState(NamedTuple):
    weights: jax.Array  # (total,) f32 flat n-tuple table
    # temporal-coherence accumulators ((total,) in "tc" mode, (0,)
    # placeholders under "sgd" so the pytree structure is static)
    opt_e: jax.Array  # signed TD-delta sums per weight
    opt_a: jax.Array  # absolute TD-delta sums per weight
    alpha: jax.Array  # f32 scalar
    next_decay: jax.Array  # i32 scalar (episode count of next scheduled decay)
    top_tile: jax.Array  # i32 scalar (exponent; ref starts at 10)
    env: engine.EnvState
    prev_idx: jax.Array  # (N, num_sym, F) i32 features of prev afterstate
    prev_value: jax.Array  # (N,) f32
    prev_valid: jax.Array  # (N,) bool
    key: jax.Array
    metrics: Metrics
    recorder: Recorder
    # canonical-orbit indices/multiplicities of the prev afterstate's
    # gather-class features ((N, K) under sym_impl="canonical", (N, 0)
    # placeholders otherwise — see features/canonical.py)
    prev_cidx: jax.Array
    prev_cmult: jax.Array


def _round4(x: jax.Array) -> jax.Array:
    """Mirror the reference's ``round(alpha, 4)`` (``r_learning.py:258``)."""
    return jnp.round(x * 10000.0) / 10000.0


def evaluate_boards(
    ts: ntuple.TupleSet, weights: jax.Array, boards: jax.Array
) -> jax.Array:
    """V(s) for (..., 4, 4) boards: num_feat gathers + sum."""
    flat = boards.reshape(boards.shape[:-2] + (16,))
    idx = ntuple.feature_indices(ts, flat)
    return weights[idx].sum(axis=-1)


def make_select_greedy(ts: ntuple.TupleSet, eval_fn=None):
    """Build the batched greedy afterstate selector (ref
    ``_find_best_move`` / the argmax in ``episode``,
    ``r_learning.py:229-237``) over a pluggable table evaluator
    (gather / one-hot matmul — see tpu2048/ops/dispatch.py).
    """
    if eval_fn is None:
        def eval_fn(weights, flat_boards):
            return ntuple.evaluate(ts, weights, flat_boards)

    def select(weights: jax.Array, boards: jax.Array):
        """Returns (chosen (N,4,4), best_dir (N,), best_val (N,),
        delta (N,), done (N,)).  ``done`` = no legal move = game over.
        Ties break toward the lowest direction index, like the
        reference's strict ``>`` scan over directions 0..3."""
        aft, delta, legal = engine.afterstates(boards)  # (4,N,...)
        vals = eval_fn(
            weights, aft.reshape(aft.shape[:-2] + (16,))
        )  # (4, N)
        neg = jnp.float32(-jnp.inf)
        masked = jnp.where(legal, vals, neg)
        best_dir = jnp.argmax(masked, axis=0).astype(jnp.int32)
        n = boards.shape[0]
        ar = jnp.arange(n)
        best_val = masked[best_dir, ar]
        best_delta = delta[best_dir, ar]
        chosen = aft[best_dir, ar]
        done = ~legal.any(axis=0)
        return chosen, best_dir, best_val, best_delta, done

    return select


def select_greedy(
    ts: ntuple.TupleSet, weights: jax.Array, boards: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Gather-mode convenience wrapper around ``make_select_greedy``."""
    return make_select_greedy(ts)(weights, boards)


def init_td_state(
    ts: ntuple.TupleSet,
    acfg: AgentConfig,
    tcfg: TrainConfig,
    key: jax.Array,
    weights: Optional[jax.Array] = None,
) -> TDState:
    n, s = tcfg.num_envs, tcfg.max_record_steps
    r_env = record_env_count(tcfg)
    kw, ke = jax.random.split(jax.random.PRNGKey(tcfg.seed) if key is None else key)
    if weights is None:
        weights = ntuple.init_weights(ts, kw)
    if acfg.engine_mode == "codes":
        from ..engine import fast as engf

        env = engf.init_env_codes(n, ke)
        start_boards = engf.boards_from_codes(env.codes[:r_env])
    else:
        env = engine.init_env(n, ke)
        start_boards = env.boards[:r_env]
    rec = Recorder(
        moves=jnp.zeros((r_env, s), jnp.int8),
        spawns=jnp.zeros((r_env, s), jnp.int8),
        starts=start_boards,
        overflow=jnp.zeros((r_env,), bool),
        best_moves=jnp.zeros((s,), jnp.int8),
        best_spawns=jnp.zeros((s,), jnp.int8),
        best_start=jnp.zeros((4, 4), jnp.int8),
        best_len=jnp.int32(0),
        best_score=jnp.int32(0),
    )
    met = Metrics(
        episodes=jnp.int32(0),
        score_ring=jnp.zeros((tcfg.ring_size + 1,), jnp.int32),
        tile_ring=jnp.zeros((tcfg.ring_size + 1,), jnp.int32),
        ring_pos=jnp.int32(0),
        best_score=jnp.int32(0),
    )
    tc = acfg.optimizer == "tc"
    opt_shape = (ts.total,) if tc else (0,)
    kc = _canon_feat_count(ts, acfg)
    return TDState(
        weights=weights,
        opt_e=jnp.zeros(opt_shape, jnp.float32),
        opt_a=jnp.zeros(opt_shape, jnp.float32),
        alpha=jnp.float32(acfg.alpha),
        next_decay=jnp.int32(acfg.decay_step),
        top_tile=jnp.int32(10),  # ref r_learning.py:122
        env=env,
        prev_idx=jnp.zeros((n, _num_sym(acfg), ts.num_feat), jnp.int32),
        prev_value=jnp.zeros((n,), jnp.float32),
        prev_valid=jnp.zeros((n,), bool),
        key=key,
        metrics=met,
        recorder=rec,
        prev_cidx=jnp.zeros((n, kc), jnp.int32),
        prev_cmult=jnp.zeros((n, kc), jnp.int32),
    )


class RecStep(NamedTuple):
    """Per-step recorder payload emitted by the staged train step.

    One row per recorded env; the segment stacks these over its K scan
    steps and merges them into the big ``(R_env, S)`` log buffers ONCE
    per segment (see ``_merge_staged_recorder``): one (K*R)-element
    merge scatter instead of K small scatters into a 100+ MB buffer.
    """

    mv: jax.Array  # (R,) i8 chosen direction
    sp: jax.Array  # (R,) i8 spawn byte pos | (val-1) << 4
    wslot: jax.Array  # (R,) i32 target column (S = drop lane)
    done: jax.Array  # (R,) bool episode completed this step
    cand: jax.Array  # (R,) i32 completed score (or -1): best-game candidate
    odo: jax.Array  # (R,) i32 odometer at step start (= final length on done)
    sb: jax.Array  # (R, 16) i8 completing episode's start board (0 if not done)


def make_train_step(
    ts: ntuple.TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
    staged: bool = False,
):
    """Build the single batched TD(0) train step (pure, jit-friendly).

    With ``staged=True`` the step does NOT scatter into the big
    recorder log buffers or update the best-game snapshot; it returns
    ``(state, RecStep)`` and the caller (``make_train_segment``) merges
    the stacked records once per segment."""

    num_feat = ts.num_feat
    ring = tcfg.ring_size
    r_env = record_env_count(tcfg)
    s_max = tcfg.max_record_steps
    num_sym = _num_sym(acfg)

    from ..ops import dispatch as table_dispatch

    canon_step = _is_canonical(acfg)
    select = make_select_greedy(
        ts,
        table_dispatch.make_evaluator(
            ts, acfg.table_ops, canonical=canon_step
        ),
    )
    tc_mode = acfg.optimizer == "tc"
    # per-step dense symmetrization: scatter identity features into a
    # full-table (dsum, hits) pair and add its 7 D4 table transforms —
    # the same per-move update mass as the explicit 8-image scatter
    # (see features/symmetry.py), minus the 8x latency-bound scatter
    # traffic that dominates the 16^5/14^6 gather-path tables.
    fold_step = acfg.sym_mode == "scatter" and acfg.sym_impl == "fold"
    if fold_step:
        from ..features.symmetry import symmetrize_sum

        def fold_pair(dsum, hits):
            both = symmetrize_sum(ts, jnp.stack([dsum, hits]))
            return both[0], both[1]

    if canon_step:
        # Canonical-index learner (features/canonical.py): per-move D4
        # coupling of the big gather classes rides the INDICES (one
        # sparse gather/scatter at the orbit minimum), so the per-step
        # cost is O(batch); only the small 16^2..16^4 classes still fold
        # densely — class-local, a few MB instead of the whole table.
        from ..features.canonical import canonical_gather_indices
        from ..features.symmetry import symmetrize_class_sum

        classes_c, class_grads = table_dispatch.make_class_grads(
            ts, acfg.table_ops
        )
    elif tc_mode or fold_step:
        accumulate = table_dispatch.make_delta_accumulator(
            ts, acfg.table_ops
        )
    if not tc_mode and not fold_step and not canon_step:
        update = table_dispatch.make_updater(
            ts, acfg.table_ops, mean=(acfg.update_mode == "mean")
        )

    # codes-path evaluator also returns the index tensors so the
    # chosen afterstate's features are SELECTED, not recomputed.
    train_ev = table_dispatch.make_train_evaluator(
        ts, acfg.table_ops, canonical=canon_step
    )
    codes_mode = acfg.engine_mode == "codes"
    if codes_mode:
        from ..engine import fast as engf

        # transposed-cell -> canonical-cell permutation (cell (i,j)
        # of the transposed board is cell (j,i) of the canonical one)
        _tperm = np.arange(16).reshape(4, 4).T.reshape(16)

    def train_step(state: TDState) -> TDState:
        key, k_spawn, k_reset = jax.random.split(state.key, 3)
        score = state.env.score
        n = score.shape[0]
        ar = jnp.arange(n)


        if codes_mode:
            # packed-codes move resolution: up/down come back in
            # transposed orientation; permuting their cells restores
            # canonical feature indices without transposing boards.
            codes = state.env.codes
            # fused quad-table expansion: 8 sliced gathers resolve all
            # 4 afterstates, legality, AND scores
            aftc, delta4, legal, tcodes = engf.afterstates_full(codes)
            cells4 = engf.cells_from_codes(aftc)  # (4, N, 16)
            perm = jnp.asarray(_tperm)
            cells4 = jnp.stack(
                [cells4[0], cells4[1][..., perm],
                 cells4[2], cells4[3][..., perm]]
            )
            with jax.named_scope("actor_eval"):
                vals, idx4, cidx4, mult4 = train_ev(
                    state.weights, cells4
                )  # (4, N), (4, N, F), (4, N, K)|None
            masked = jnp.where(legal, vals, -jnp.inf)
            best_dir = jnp.argmax(masked, axis=0).astype(jnp.int32)

            def _sel(x4):
                # chosen-direction select as a 4-way masked merge: one
                # fused elementwise sweep instead of a batched gather
                out = x4[0]
                for d in (1, 2, 3):
                    h = best_dir == d
                    m = h if x4.ndim == 2 else h.reshape(
                        (-1,) + (1,) * (x4.ndim - 2)
                    )
                    out = jnp.where(m, x4[d], out)
                return out

            best_val = _sel(masked)
            best_delta = _sel(delta4)
            done = ~legal.any(axis=0)
            chosen_cells = _sel(cells4)  # canonical (N, 16)
            chosen_codes = engf.canonicalize_chosen(
                _sel(aftc), best_dir
            )
        else:
            boards = state.env.boards
            chosen, best_dir, best_val, best_delta, done = select(
                state.weights, boards
            )
            chosen_cells = chosen.reshape(n, 16)

        # --- TD update of the previous afterstate -----------------------
        # Collision-aware batched TD ("mean" mode): each entry's summed
        # update is normalized by its hit count this step, so hot
        # entries see the same effective step size as in sequential TD.
        td_err = jnp.where(done, -state.prev_value,
                           best_delta.astype(jnp.float32) + best_val
                           - state.prev_value)
        idx_flat = state.prev_idx.reshape(n * num_sym, num_feat)
        valid_flat = jnp.broadcast_to(
            state.prev_valid[:, None], (n, num_sym)
        ).reshape(-1)
        if canon_step:
            delta = jnp.where(state.prev_valid, td_err, 0.0) / jnp.float32(
                num_feat
            )
            if not tc_mode:
                delta = delta * state.alpha
            weights, opt_e, opt_a = (
                state.weights, state.opt_e, state.opt_a
            )
            # small 16^2..16^4 classes: per-class (dsum, hits) blocks +
            # the class-local D4 fold, then the optimizer rule on the
            # block only (a few MB of traffic, never the full table)
            with jax.named_scope("class_grads"):
                blocks = class_grads(idx_flat, delta, state.prev_valid)
            for c, (dsum_b, hits_b) in zip(classes_c.matmul, blocks):
                size1 = c.h * c.l
                with jax.named_scope("class_fold"):
                    pair = symmetrize_class_sum(
                        ts, c.feat0, c.g,
                        jnp.stack([dsum_b.reshape(c.g, size1),
                                   hits_b.reshape(c.g, size1)]),
                    )
                dsum_f = pair[0].reshape(c.g * size1)
                hits_f = pair[1].reshape(c.g * size1)
                nsz = c.g * size1
                if tc_mode:
                    dbar = dsum_f / jnp.maximum(hits_f, 1.0)
                    w_blk = jax.lax.dynamic_slice(
                        weights, (c.start,), (nsz,)
                    )
                    e_blk = jax.lax.dynamic_slice(opt_e, (c.start,), (nsz,))
                    a_blk = jax.lax.dynamic_slice(opt_a, (c.start,), (nsz,))
                    lr_b = jnp.where(
                        a_blk > 0.0,
                        jnp.abs(e_blk) / jnp.maximum(a_blk, 1e-30),
                        1.0,
                    )
                    w_new = w_blk + state.alpha * lr_b * dbar
                    e_new = e_blk + dbar
                    a_new = a_blk + jnp.abs(dbar)
                    weights = jax.lax.dynamic_update_slice(
                        weights, w_new, (c.start,)
                    )
                    opt_e = jax.lax.dynamic_update_slice(
                        opt_e, e_new, (c.start,)
                    )
                    opt_a = jax.lax.dynamic_update_slice(
                        opt_a, a_new, (c.start,)
                    )
                else:
                    upd = (dsum_f / jnp.maximum(hits_f, 1.0)
                           if acfg.update_mode == "mean" else dsum_f)
                    w_blk = jax.lax.dynamic_slice(
                        weights, (c.start,), (nsz,)
                    )
                    weights = jax.lax.dynamic_update_slice(
                        weights, w_blk + upd, (c.start,)
                    )
            # big gather classes: ONE sparse op set at the canonical
            # orbit indices.  "sum" scatters mult*delta (the exact
            # 8-image totals, orbit-stabilizer).  "mean" divides each
            # hit by the entry's total hit count this step, computed
            # with one dense counting scatter — canonicalization makes
            # collisions COMMON, not rare (near-empty boards share
            # orbits: a board's own 4 crosses often canonicalize to one
            # entry), so per-entry normalization must be exact to match
            # the validated fold/index collision-mean numerics.
            with jax.named_scope("sparse_update"):
                if state.prev_cidx.shape[1]:
                    cidx = state.prev_cidx
                    per = jnp.broadcast_to(delta[:, None], cidx.shape)
                    if acfg.update_mode == "sum":
                        per = per * state.prev_cmult.astype(jnp.float32)
                    per = jnp.where(state.prev_valid[:, None], per, 0.0)
                    if acfg.update_mode == "mean":
                        contrib = jnp.broadcast_to(
                            state.prev_valid[:, None], cidx.shape
                        ).astype(jnp.float32)
                        hits_g = jnp.zeros(
                            (ts.total,), jnp.float32
                        ).at[cidx].add(contrib, mode="drop")
                        per = per / jnp.maximum(hits_g[cidx], 1.0)
                    if tc_mode:
                        e_g = opt_e[cidx]
                        a_g = opt_a[cidx]
                        lr_g = jnp.where(
                            a_g > 0.0,
                            jnp.abs(e_g) / jnp.maximum(a_g, 1e-30),
                            1.0,
                        )
                        weights = weights.at[cidx].add(
                            state.alpha * lr_g * per, mode="drop"
                        )
                        opt_e = opt_e.at[cidx].add(per, mode="drop")
                        opt_a = opt_a.at[cidx].add(
                            jnp.abs(per), mode="drop"
                        )
                    else:
                        weights = weights.at[cidx].add(per, mode="drop")
        elif tc_mode:
            # Temporal coherence (Jaskowski 2016): per-weight rate
            # |E|/A, self-annealing; alpha is a global meta-rate.
            delta = jnp.where(state.prev_valid, td_err, 0.0) / jnp.float32(
                num_feat
            )
            dsum, hits = accumulate(
                state.weights,
                idx_flat,
                jnp.broadcast_to(delta[:, None], (n, num_sym)).reshape(-1),
                valid_flat,
            )
            if fold_step:
                dsum, hits = fold_pair(dsum, hits)
            dbar = dsum / jnp.maximum(hits, 1.0)
            lr = jnp.where(
                state.opt_a > 0.0,
                jnp.abs(state.opt_e) / jnp.maximum(state.opt_a, 1e-30),
                1.0,
            )
            weights = state.weights + state.alpha * lr * dbar
            opt_e = state.opt_e + dbar
            opt_a = state.opt_a + jnp.abs(dbar)
        else:
            dw = jnp.where(state.prev_valid, td_err, 0.0) * (
                state.alpha / jnp.float32(num_feat)
            )
            dw_flat = jnp.broadcast_to(dw[:, None], (n, num_sym)).reshape(-1)
            if fold_step:
                dsum, hits = accumulate(
                    state.weights, idx_flat, dw_flat, valid_flat
                )
                if acfg.update_mode == "mean":
                    dsum, hits = fold_pair(dsum, hits)
                    weights = state.weights + dsum / jnp.maximum(hits, 1.0)
                else:
                    from ..features.symmetry import symmetrize_sum

                    weights = state.weights + symmetrize_sum(ts, dsum)
            else:
                weights = update(
                    state.weights, idx_flat, dw_flat, valid_flat
                )
            opt_e, opt_a = state.opt_e, state.opt_a

        # --- advance the environments -----------------------------------
        new_score = jnp.where(done, score, score + best_delta)
        new_odo = jnp.where(done, state.env.odometer, state.env.odometer + 1)
        if codes_mode:
            moved_c = jnp.where(done[:, None], codes, chosen_codes)
            spawned_c, pos, val = engf.spawn_codes(moved_c, k_spawn)
            spawned_c = jnp.where(done[:, None], codes, spawned_c)
            env = engf.EnvStateC(codes=spawned_c, score=new_score,
                                 odometer=new_odo)
        else:
            moved = jnp.where(done[:, None, None], boards, chosen)
            spawned, pos, val = engine.spawn(moved, k_spawn)
            spawned = jnp.where(done[:, None, None], boards, spawned)
            env = engine.EnvState(boards=spawned, score=new_score,
                                  odometer=new_odo)

        # --- recorder: log (move, spawn) for the recorded subset --------
        # Games longer than s_max are flagged (not silently clobbered
        # into slot S-1): an overflowed log can't reproduce the game,
        # so the env is excluded from best-game capture until it resets.
        rec = state.recorder
        odo_r = state.env.odometer[:r_env]
        overflow = rec.overflow | (~done[:r_env] & (odo_r >= s_max))
        rec_on = ~done[:r_env] & ~overflow
        # drop-mode writes: a non-recording lane targets slot S (out of
        # range, silently dropped), so the (R_env, S) log buffers are
        # written without a read-modify-write — XLA keeps them strictly
        # in-place across the scan (at 8192 recorded envs the two logs
        # are 268 MB; a per-step copy would dominate the train step)
        wslot = jnp.where(rec_on, odo_r, s_max)
        ar_r = jnp.arange(r_env)
        sp_byte = (pos[:r_env] | ((val[:r_env] - 1) << 4)).astype(jnp.int8)
        done_rec = done[:r_env] & ~overflow
        if staged:
            # defer the big-buffer writes + best snapshot to the
            # once-per-segment merge; only the cheap dense per-env
            # state (starts, overflow) advances per step.  ``sb``
            # snapshots the completing episode's start board so the
            # merge can also consider episodes that start AND finish
            # inside the segment (their start position exists only
            # transiently in ``rec.starts`` mid-scan).
            recinfo = RecStep(
                mv=best_dir[:r_env].astype(jnp.int8),
                sp=sp_byte,
                wslot=wslot.astype(jnp.int32),
                done=done[:r_env],
                cand=jnp.where(done_rec, score[:r_env], -1),
                odo=odo_r,
                sb=jnp.where(
                    done_rec[:, None], rec.starts.reshape(r_env, 16), 0
                ).astype(jnp.int8),
            )
        else:
            moves_buf = rec.moves.at[ar_r, wslot].set(
                best_dir[:r_env].astype(jnp.int8), mode="drop"
            )
            spawns_buf = rec.spawns.at[ar_r, wslot].set(sp_byte, mode="drop")

        # --- best finished recorded game snapshot ------------------------
        if not staged:
            cand = jnp.where(done_rec, score[:r_env], -1)
            best_i = jnp.argmax(cand)
            take = cand[best_i] > rec.best_score
            best_moves = jnp.where(take, moves_buf[best_i], rec.best_moves)
            best_spawns = jnp.where(
                take, spawns_buf[best_i], rec.best_spawns
            )
            best_start = jnp.where(take, rec.starts[best_i], rec.best_start)
            best_len = jnp.where(
                take,
                jnp.minimum(state.env.odometer[best_i], s_max),
                rec.best_len,
            )
            rec_best_score = jnp.where(take, cand[best_i], rec.best_score)

        # --- episode-completion metrics ----------------------------------
        met = state.metrics
        n_done = done.sum().astype(jnp.int32)
        order = jnp.cumsum(done.astype(jnp.int32)) - 1
        wpos = jnp.where(done, (met.ring_pos + order) % ring, ring)
        tiles = (engf.max_tile_codes(codes) if codes_mode
                 else engine.max_tile(boards))
        # one stacked scatter fills both rings (lane count is the
        # scatter cost driver; the (2, ring) stack copies are noise)
        rings = jnp.stack([met.score_ring, met.tile_ring])
        rings = rings.at[:, wpos].set(
            jnp.stack([score, tiles]), mode="drop"
        )
        score_ring, tile_ring = rings[0], rings[1]
        ep_best = jnp.where(done, score, 0).max()
        metrics = Metrics(
            episodes=met.episodes + n_done,
            score_ring=score_ring,
            tile_ring=tile_ring,
            ring_pos=met.ring_pos + n_done,
            best_score=jnp.maximum(met.best_score, ep_best),
        )

        # --- alpha schedule (skipped for the self-annealing TC rule) -----
        alpha, next_decay = state.alpha, state.next_decay
        mt_done = jnp.where(done, tiles, 0).max()
        top_tile = jnp.maximum(state.top_tile, mt_done)
        if not tc_mode:
            trig1 = (metrics.episodes > next_decay) & (
                alpha > jnp.float32(acfg.low_alpha_limit)
            )
            alpha = jnp.where(
                trig1,
                _round4(jnp.maximum(alpha * acfg.decay,
                                    acfg.low_alpha_limit)),
                alpha,
            )
            trig2 = mt_done > state.top_tile
            alpha = jnp.where(
                trig2,
                _round4(jnp.maximum(alpha * acfg.decay,
                                    acfg.low_alpha_limit)),
                alpha,
            )
            next_decay = jnp.where(
                trig1 | trig2, metrics.episodes + acfg.decay_step,
                next_decay,
            )

        # --- auto-reset finished envs ------------------------------------
        if codes_mode:
            env = engf.reset_where_codes(env, done, k_reset)
            fresh_boards = engf.boards_from_codes(env.codes[:r_env])
        else:
            env = engine.reset_where(env, done, k_reset)
            fresh_boards = env.boards[:r_env]
        starts = jnp.where(
            done[:r_env, None, None], fresh_boards, rec.starts
        )
        overflow = jnp.where(done[:r_env], False, overflow)

        # --- next-step bootstrap state -----------------------------------
        if num_sym == 8:
            sym_idx = ntuple.all_symmetry_indices(ts, chosen_cells)
        elif codes_mode:
            sym_idx = _sel(idx4)[:, None, :]  # select, no recompute
        else:
            sym_idx = ntuple.feature_indices(ts, chosen_cells)[
                :, None, :
            ]
        prev_idx = jnp.where(done[:, None, None], state.prev_idx, sym_idx)
        prev_value = jnp.where(done, 0.0, best_val)
        prev_valid = ~done
        if canon_step and state.prev_cidx.shape[1]:
            if codes_mode:
                cidx_n, cmult_n = _sel(cidx4), _sel(mult4)
            else:
                cidx_n, cmult_n = canonical_gather_indices(
                    ts, chosen_cells
                )
            prev_cidx = jnp.where(done[:, None], state.prev_cidx, cidx_n)
            prev_cmult = jnp.where(
                done[:, None], state.prev_cmult, cmult_n
            )
        else:
            prev_cidx, prev_cmult = state.prev_cidx, state.prev_cmult

        if staged:
            recorder = rec._replace(starts=starts, overflow=overflow)
        else:
            recorder = Recorder(
                moves=moves_buf,
                spawns=spawns_buf,
                starts=starts,
                overflow=overflow,
                best_moves=best_moves,
                best_spawns=best_spawns,
                best_start=best_start,
                best_len=best_len,
                best_score=rec_best_score,
            )
        out = TDState(
            weights=weights,
            opt_e=opt_e,
            opt_a=opt_a,
            alpha=alpha,
            next_decay=next_decay,
            top_tile=top_tile,
            env=env,
            prev_idx=prev_idx,
            prev_value=prev_value,
            prev_valid=prev_valid,
            key=key,
            metrics=metrics,
            recorder=recorder,
            prev_cidx=prev_cidx,
            prev_cmult=prev_cmult,
        )
        return (out, recinfo) if staged else out

    return train_step


def _merge_staged_recorder(
    rec: Recorder, starts0: jax.Array, recs: RecStep, s_max: int
) -> Recorder:
    """Fold a segment's stacked ``RecStep`` records into the recorder.

    ONE masked scatter per log buffer: writes belonging to each env's
    episode running at segment start (scan steps before its FIRST
    completion) and the episode running at segment END (steps at/after
    the LAST completion) land together, with the start episode's
    low-slot tail masked out so the two slot ranges are provably
    disjoint (see the inline comment — the masked writes belong to an
    episode whose buffer row is never read again).
    Episodes that both start and finish strictly inside one segment
    never materialize in the big buffers, but they are still best-game
    candidates: every completion's score/length/start-board is staged
    (``cand``/``odo``/``sb``), and when an in-segment episode wins, its
    move/spawn log is reconstructed directly from the stacked records
    (its scan-step window ``[k-L, k)`` maps to log slots ``0..L-1``).
    ``starts0`` is the ``starts`` buffer at segment START — the right
    source for a FIRST completion's starting position (that episode
    was already running when the segment began).
    """
    mv, sp, wslot, done_k, cand_k, odo_k, sb_k = recs
    K, R = mv.shape
    kk = jnp.arange(K)[:, None]
    ar_b = jnp.broadcast_to(jnp.arange(R)[None, :], (K, R))
    fdone = jnp.where(done_k, kk, K).min(axis=0)  # first completion
    ldone = jnp.where(done_k, kk, -1).max(axis=0)  # last completion
    ldone_eff = jnp.where(ldone >= 0, ldone, K)

    # ONE scatter per log buffer, with PROVABLY disjoint slots: steps
    # of the episode running at segment START (kk < fdone) write
    # ascending slots [odo0, odo0+fdone); steps of the episode running
    # at segment END (kk >= ldone_eff) write slots [0, end_cnt).  The
    # ranges can overlap when the segment began right after a reset,
    # and XLA leaves duplicate-index ``set`` order unspecified — so
    # start-episode writes into slots BELOW end_cnt are masked out
    # instead.  That is lossless: when fdone < K the start episode
    # COMPLETED this segment, its buffer row is never read again (the
    # best-game snapshot below composes its log from the old buffer +
    # the staged records, both pre-merge), while the end episode's row
    # — the one a later segment keeps extending — always lands intact.
    # When nothing completed (fdone = K), end_cnt = 0 and every write
    # lands.
    end_cnt = jnp.where(ldone >= 0, K - 1 - ldone, 0)
    col = jnp.where(
        kk < fdone[None, :],
        jnp.where(wslot >= end_cnt[None, :], wslot, s_max),
        jnp.where(kk >= ldone_eff[None, :], wslot, s_max),
    )
    moves_f = rec.moves.at[ar_b, col].set(mv, mode="drop")
    spawns_f = rec.spawns.at[ar_b, col].set(sp, mode="drop")

    # best finished game among this segment's first completions: its
    # log = old buffer row (slots [0, L-f)) + this segment's staged
    # window (slots [L-f, L) = scan steps [0, f)), composed by a masked
    # positional gather — no intermediate buffer state needed
    fidx = jnp.minimum(fdone, K - 1)[None, :]
    cand_fd = jnp.take_along_axis(cand_k, fidx, axis=0)[0]
    cand_fd = jnp.where(fdone < K, cand_fd, -1)
    len_fd = jnp.take_along_axis(odo_k, fidx, axis=0)[0]
    best_i = jnp.argmax(cand_fd)
    cand_cross = cand_fd[best_i]
    l_cr = jnp.minimum(len_fd[best_i], s_max)
    f_cr = fdone[best_i]
    off_cr = l_cr - f_cr  # first staged-slot position
    pos = jnp.arange(s_max)
    t_cr = jnp.clip(pos - off_cr, 0, K - 1)
    in_win = (pos >= off_cr) & (pos < l_cr)
    bm_cross = jnp.where(in_win, mv[:, best_i][t_cr], rec.moves[best_i])
    bs_cross = jnp.where(
        in_win, sp[:, best_i][t_cr], rec.spawns[best_i]
    )

    # best among episodes contained ENTIRELY in this segment (started
    # at scan step k - L >= 0): reconstructable from the stacked recs
    in_seg = done_k & (kk - odo_k >= 0)
    cand_in = jnp.where(in_seg, cand_k, -1)
    flat_in = jnp.argmax(cand_in)
    k_in, r_in = flat_in // R, flat_in % R
    cand_ins = cand_in.reshape(-1)[flat_in]
    len_in = odo_k[k_in, r_in]
    w = min(K, s_max)
    pad = jnp.zeros((K,), mv.dtype)
    src = jnp.maximum(k_in - len_in, 0)
    win_mv = jax.lax.dynamic_slice(
        jnp.concatenate([mv[:, r_in], pad]), (src,), (K,)
    )[:w]
    win_sp = jax.lax.dynamic_slice(
        jnp.concatenate([sp[:, r_in], pad]), (src,), (K,)
    )[:w]
    live = jnp.arange(w) < len_in
    bm_in = jnp.zeros((s_max,), mv.dtype).at[:w].set(
        jnp.where(live, win_mv, 0)
    )
    bs_in = jnp.zeros((s_max,), sp.dtype).at[:w].set(
        jnp.where(live, win_sp, 0)
    )
    start_in = sb_k[k_in, r_in].reshape(4, 4)

    use_in = cand_ins > cand_cross
    seg_best = jnp.maximum(cand_ins, cand_cross)
    take = seg_best > rec.best_score
    best_moves = jnp.where(
        take, jnp.where(use_in, bm_in, bm_cross), rec.best_moves
    )
    best_spawns = jnp.where(
        take, jnp.where(use_in, bs_in, bs_cross), rec.best_spawns
    )
    best_start = jnp.where(
        take, jnp.where(use_in, start_in, starts0[best_i]),
        rec.best_start,
    )
    best_len = jnp.where(
        take, jnp.where(use_in, len_in, l_cr), rec.best_len
    )
    best_score = jnp.where(take, seg_best, rec.best_score)
    return rec._replace(
        moves=moves_f,
        spawns=spawns_f,
        best_moves=best_moves,
        best_spawns=best_spawns,
        best_start=best_start,
        best_len=best_len,
        best_score=best_score,
    )


def make_train_segment(
    ts: ntuple.TupleSet, acfg: AgentConfig, tcfg: TrainConfig
):
    """K train steps rolled with ``lax.scan`` (one jit call per segment).

    In "periodic" symmetry mode the segment scatters identity features
    only inside the scan and folds the accumulated weight delta through
    the 7 non-identity D4 table transforms once at the end — the same
    total update as the reference's per-move 8-image scatter, at a
    fraction of the scatter traffic (see features/symmetry.py).

    The recorder is STAGED: steps emit per-env ``RecStep`` rows as scan
    outputs and the segment merges them into the big log buffers once
    (``_merge_staged_recorder``) instead of per-step scatters into the
    100+ MB logs when every env is recorded (the true best-game-capture
    default).
    """
    step = make_train_step(ts, acfg, tcfg, staged=True)

    def segment(state: TDState) -> TDState:
        starts0 = state.recorder.starts

        def body(s, _):
            return step(s)

        out, recs = jax.lax.scan(
            body, state, None, length=tcfg.steps_per_call
        )
        out = out._replace(
            recorder=_merge_staged_recorder(
                out.recorder, starts0, recs, tcfg.max_record_steps
            )
        )
        if acfg.sym_mode == "periodic":
            from ..features.symmetry import symmetrize_table

            # Project onto the D4-symmetric subspace (orbit average).
            # Adding the folded delta at full weight would apply 7x the
            # per-entry mass in one lump without the move-by-move TD
            # feedback the reference's incremental 8-image scatter gets,
            # and diverges; the projection is non-expansive, keeps each
            # board's own per-move learning rate at the reference's
            # alpha, and shares updates across the orbit exactly like
            # the converged reference table (which lives in this
            # subspace up to its asymmetric random init).
            out = out._replace(weights=symmetrize_table(ts, out.weights))
            if acfg.optimizer == "tc":
                # keep the TC accumulators in the same subspace
                out = out._replace(
                    opt_e=symmetrize_table(ts, out.opt_e),
                    opt_a=symmetrize_table(ts, out.opt_a),
                )
        return out

    return segment


