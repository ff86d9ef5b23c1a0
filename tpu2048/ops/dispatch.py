"""Table-op dispatch: gather vs one-hot-XLA paths.

Builds the evaluator / updater pair used by the TD learner
(``tpu2048.agent.td``) for a given tuple set.  Both modes are
numerically interchangeable (same values, same updates); they differ
only in how the table lookups are expressed to XLA:

  "gather":  jnp indexing — XLA gather/scatter (the default; "auto")
  "onehot":  two-level one-hot matmuls in plain XLA (kept as the
             matmul formulation of the same lookups, see ops/onehot.py)

Tables too large for the matmul form (16^5, 14^6) always take the
gather path; "onehot" applies to the 16^2/16^3/16^4 classes.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..features.ntuple import TupleSet, feature_indices
from . import onehot as oh

MODES = ("auto", "gather", "onehot")


def resolve_mode(mode: str) -> str:
    """"auto" -> gather on every backend; an unknown or removed mode
    raises ``ValueError`` naming the valid ones."""
    if mode not in MODES:
        raise ValueError(
            f"unknown table op mode {mode!r}; valid modes: {MODES}"
        )
    return "gather" if mode == "auto" else mode


def _gather_class_values(ts, classes, weights, flat_boards, idx2,
                         canonical: bool):
    """Sum of the gather-path features' weights: identity indices, or
    canonical-orbit indices when the table is in canonical form (see
    features/canonical.py)."""
    if canonical:
        from ..features.canonical import canonical_gather_indices

        shape = flat_boards.shape[:-1]
        b = int(np.prod(shape)) if shape else 1
        cidx, _mult = canonical_gather_indices(ts, flat_boards)
        return weights[cidx.reshape(b, -1)].sum(axis=-1)
    gf = jnp.asarray(classes.gather_feats)
    return weights[idx2[:, gf]].sum(axis=-1)


def make_evaluator(ts: TupleSet, mode: str, canonical: bool = False) -> Callable:
    """Returns eval_fn(weights, flat_boards (..., 16)) -> (...,) f32.

    ``canonical=True`` reads the large gather-path classes at their
    canonical-orbit indices (the representation the canonical-index
    learner trains); the small 16^2..16^4 classes always use identity
    indices in either representation.
    """
    mode = resolve_mode(mode)
    if mode == "gather":
        if canonical:
            classes_g = oh.build_table_classes(ts)

            def eval_gather_canon(weights, flat_boards):
                shape = flat_boards.shape[:-1]
                b = int(np.prod(shape)) if shape else 1
                idx2 = feature_indices(ts, flat_boards).reshape(
                    b, ts.num_feat
                )
                total = jnp.zeros((b,), jnp.float32)
                for c in classes_g.matmul:
                    cols = idx2[:, c.feat0: c.feat0 + c.g]
                    total = total + weights[cols].sum(axis=-1)
                total = total + _gather_class_values(
                    ts, classes_g, weights, flat_boards, idx2, True
                )
                return total.reshape(shape)

            return eval_gather_canon

        def eval_gather(weights, flat_boards):
            idx = feature_indices(ts, flat_boards)
            return weights[idx].sum(axis=-1)

        return eval_gather

    classes = oh.build_table_classes(ts)

    def eval_onehot(weights, flat_boards):
        shape = flat_boards.shape[:-1]
        b = int(np.prod(shape)) if shape else 1
        idx = feature_indices(ts, flat_boards).reshape(b, ts.num_feat)
        total = jnp.zeros((b,), jnp.float32)
        for c in classes.matmul:
            tables = oh._class_tables(weights, c)
            hi, lo = oh._hi_lo(ts, idx, c)
            oh_hi = jax.nn.one_hot(hi, c.h, dtype=jnp.float32)
            m = jnp.einsum(
                "bgh,ghl->bgl",
                oh_hi,
                tables,
                precision=jax.lax.Precision.HIGHEST,
            )
            v = jnp.take_along_axis(m, lo[..., None], axis=-1)[..., 0]
            total = total + v.sum(axis=-1)
        if len(classes.gather_feats):
            total = total + _gather_class_values(
                ts, classes, weights, flat_boards, idx, canonical
            )
        return total.reshape(shape)

    return eval_onehot


def make_delta_accumulator(ts: TupleSet, mode: str) -> Callable:
    """Returns acc_fn(weights_like, idx (B,F), dw (B,), valid (B,))
    -> (dsum, hits) full-table arrays: per-entry summed updates and
    hit counts for this batch.  Used by table-level optimizers
    (collision-mean SGD, temporal coherence)."""
    resolve_mode(mode)

    def acc_gather(weights, idx, dw, valid):
        dwv = jnp.where(valid, dw, 0.0)
        upd = jnp.broadcast_to(dwv[:, None], idx.shape)
        contrib = jnp.broadcast_to(
            valid[:, None], idx.shape
        ).astype(jnp.float32)
        zeros = jnp.zeros_like(weights)
        dsum = zeros.at[idx].add(upd, mode="drop")
        hits = zeros.at[idx].add(contrib, mode="drop")
        return dsum, hits

    return acc_gather


def make_train_evaluator(ts: TupleSet, mode: str, canonical: bool = False):
    """Evaluator that also RETURNS the index tensors it computed, so
    the train step can select the chosen afterstate's features instead
    of recomputing them (one index matmul + one canonical orbit
    reduction per step saved).

    Returns fn(weights, flat_boards (..., 16)) ->
        (values (...,), idx (..., F), cidx (..., K) | None,
         mult (..., K) | None)
    """
    resolve_mode(mode)
    classes = oh.build_table_classes(ts)
    if canonical:
        from ..features.canonical import canonical_gather_indices

    def ev(weights, flat_boards):
        shape = flat_boards.shape[:-1]
        b = int(np.prod(shape)) if shape else 1
        idx = feature_indices(ts, flat_boards)
        idx2 = idx.reshape(b, ts.num_feat)
        total = jnp.zeros((b,), jnp.float32)
        with jax.named_scope("class_eval"):
            for c in classes.matmul:
                cols = idx2[:, c.feat0: c.feat0 + c.g]
                total = total + weights[cols].sum(axis=-1)
        cidx = mult = None
        if len(classes.gather_feats):
            with jax.named_scope("gather_eval"):
                if canonical:
                    cidx, mult = canonical_gather_indices(ts, flat_boards)
                    total = total + weights[cidx.reshape(b, -1)].sum(
                        axis=-1
                    )
                else:
                    gf = jnp.asarray(classes.gather_feats)
                    total = total + weights[idx2[:, gf]].sum(axis=-1)
        return total.reshape(shape), idx, cidx, mult

    return ev


def make_class_grads(ts: TupleSet, mode: str):
    """Per-class (dsum, hits) gradient blocks for the 16^2..16^4
    classes ONLY — never materializes full-table arrays (the canonical
    -index learner handles the big gather classes sparsely instead).

    Returns ``(classes, fn)`` with
    ``fn(idx (B, F), dw (B,), valid (B,)) ->
        [(dsum (g, h, l), hits (g, h, l)), ...]`` aligned with
    ``classes.matmul``.  A scatter-add into each class block: the
    block's dsum is an f32 sum of colliding updates whose order is not
    fixed on a GPU (atomics), so it varies in the last bits from run to
    run; hits are integer counts and exact.
    """
    resolve_mode(mode)
    classes = oh.build_table_classes(ts)

    def fn_scatter(idx, dw, valid):
        dwv = jnp.where(valid, dw, 0.0).astype(jnp.float32)
        cv = valid.astype(jnp.float32)
        out = []
        for c in classes.matmul:
            # the class's g tables are contiguous from c.start, so the
            # flat index minus c.start addresses the (g, h, l) block
            loc = idx[:, c.feat0: c.feat0 + c.g] - c.start
            zeros = jnp.zeros((c.g * c.h * c.l,), jnp.float32)
            dsum = zeros.at[loc].add(
                jnp.broadcast_to(dwv[:, None], loc.shape), mode="drop"
            )
            hits = zeros.at[loc].add(
                jnp.broadcast_to(cv[:, None], loc.shape), mode="drop"
            )
            out.append((dsum.reshape(c.g, c.h, c.l),
                        hits.reshape(c.g, c.h, c.l)))
        return out

    return classes, fn_scatter


def make_updater(ts: TupleSet, mode: str, mean: bool) -> Callable:
    """Returns update_fn(weights, idx (B, F), dw (B,), valid (B,)).

    idx carries GLOBAL flat-table indices; dw is the per-item update
    already scaled by alpha/num_feat; valid masks items out entirely.
    Semantics = scatter-add, with per-entry hit-count normalization
    when mean=True (AgentConfig.update_mode "mean").
    """
    mode = resolve_mode(mode)
    if mode == "gather":

        def upd_gather(weights, idx, dw, valid):
            dwv = jnp.where(valid, dw, 0.0)
            upd = jnp.broadcast_to(dwv[:, None], idx.shape)
            if mean:
                contrib = jnp.broadcast_to(
                    valid[:, None], idx.shape
                ).astype(jnp.float32)
                hits = jnp.zeros_like(weights).at[idx].add(
                    contrib, mode="drop"
                )
                upd = upd / jnp.maximum(hits[idx], 1.0)
            return weights.at[idx].add(upd, mode="drop")

        return upd_gather

    classes = oh.build_table_classes(ts)

    def upd_onehot(weights, idx, dw, valid):
        return oh.onehot_update(
            ts, classes, weights, idx, dw, valid, mean=mean
        )

    return upd_onehot
