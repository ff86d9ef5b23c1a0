"""Two-level one-hot matmul table ops (XLA implementation).

The n-tuple model's evaluation is a sum of table lookups
(reference ``r_learning.py:202-203``).  For a table of size H*L the
lookup ``T[i]`` equals the bilinear form

    T[i] = onehot(i // L, H) @ T.reshape(H, L) @ onehot(i % L, L)

i.e. one (B,H)x(H,L) matmul plus an L-wide masked row-sum — O(H*L)
FLOPs per lookup (131 kFLOP for a 16^4 table).  Tables of the same
size class are stacked into (G, H, L) and evaluated as one batched
matmul; classes too large to be worth it (16^5, 14^6) stay on the
gather path.

The TD scatter-add is the transpose of the same bilinear form:

    dW = sum_b onehot(hi_b)^T (dw_b * onehot(lo_b))    # (H,L) matmul
    hits = sum_b onehot(hi_b)^T (valid_b * onehot(lo_b))

which also yields the collision-aware "mean" update (AgentConfig.
update_mode) as a cheap table-wide elementwise divide instead of the
gather-scatter-gather chain.

``ops/dispatch.py`` selects this formulation with ``table_ops=
"onehot"``; the default is the plain gather/scatter with identical
numerics.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..features.ntuple import TupleSet

# size -> (H, L) two-level decomposition; sizes absent here (16^5, 14^6)
# are evaluated/updated by plain gather/scatter.
CLASS_DECOMP = {
    256: (16, 16),
    4096: (64, 64),
    65536: (256, 256),
}


class TableClass(NamedTuple):
    """A run of same-size tuples, contiguous in the flat table."""

    start: int  # flat-table offset of the first tuple
    g: int  # number of tuples
    h: int
    l: int
    feat0: int  # first feature column in the (…, num_feat) index array


class TableClasses(NamedTuple):
    matmul: Tuple[TableClass, ...]  # 16^2..16^4 classes (matmul form)
    gather_feats: np.ndarray  # (K,) int32 feature columns on the gather path


def build_table_classes(ts: TupleSet) -> TableClasses:
    """Group the tuple set's tables into contiguous same-size runs."""
    sizes = ts.sizes
    offsets = ts.offsets
    classes: List[TableClass] = []
    gather_feats: List[int] = []
    f = 0
    while f < ts.num_feat:
        size = int(sizes[f])
        g = 1
        while f + g < ts.num_feat and int(sizes[f + g]) == size:
            g += 1
        if size in CLASS_DECOMP:
            h, l = CLASS_DECOMP[size]
            classes.append(
                TableClass(start=int(offsets[f]), g=g, h=h, l=l, feat0=f)
            )
        else:
            gather_feats.extend(range(f, f + g))
        f += g
    return TableClasses(
        matmul=tuple(classes),
        gather_feats=np.asarray(gather_feats, np.int32),
    )


def _class_tables(weights: jax.Array, c: TableClass) -> jax.Array:
    return jax.lax.dynamic_slice(
        weights, (c.start,), (c.g * c.h * c.l,)
    ).reshape(c.g, c.h, c.l)


def _hi_lo(ts: TupleSet, idx: jax.Array, c: TableClass) -> Tuple[jax.Array, jax.Array]:
    """Split this class's global indices into (hi, lo) local levels."""
    off = jnp.asarray(ts.offsets[c.feat0 : c.feat0 + c.g])
    local = idx[..., c.feat0 : c.feat0 + c.g] - off
    return local // c.l, local % c.l


def onehot_eval(
    ts: TupleSet,
    classes: TableClasses,
    weights: jax.Array,
    idx: jax.Array,
) -> jax.Array:
    """sum_f weights[idx[..., f]] with the matmul classes as matmuls.

    Exact: one-hots are 0/1 (exact in any float dtype) and the matmul
    runs at HIGHEST precision, so each product term is an exact f32
    weight or zero.
    """
    shape = idx.shape[:-1]
    b = int(np.prod(shape)) if shape else 1
    idx2 = idx.reshape(b, ts.num_feat)
    total = jnp.zeros((b,), jnp.float32)
    for c in classes.matmul:
        tables = _class_tables(weights, c)
        hi, lo = _hi_lo(ts, idx2, c)  # (b, g)
        oh_hi = jax.nn.one_hot(hi, c.h, dtype=jnp.float32)  # (b, g, h)
        m = jnp.einsum(
            "bgh,ghl->bgl",
            oh_hi,
            tables,
            precision=jax.lax.Precision.HIGHEST,
        )
        v = jnp.take_along_axis(m, lo[..., None], axis=-1)[..., 0]  # (b, g)
        total = total + v.sum(axis=-1)
    if len(classes.gather_feats):
        gf = jnp.asarray(classes.gather_feats)
        total = total + weights[idx2[:, gf]].sum(axis=-1)
    return total.reshape(shape)


def onehot_update(
    ts: TupleSet,
    classes: TableClasses,
    weights: jax.Array,
    idx: jax.Array,
    dw: jax.Array,
    valid: jax.Array,
    mean: bool = True,
) -> jax.Array:
    """Apply the batched TD scatter-add through the matmul classes.

    Equivalent to ``weights.at[idx].add(dw/hits)`` with the
    collision-aware mean normalization (AgentConfig.update_mode
    "mean"): for each table entry, the summed update of all batch
    items hitting it this step is divided by the hit count.  ``dw``
    is per-batch-item, already scaled by alpha/num_feat; ``valid``
    masks items with no previous afterstate.
    """
    b = idx.shape[0]
    dwv = jnp.where(valid, dw, 0.0).astype(jnp.float32)
    cv = valid.astype(jnp.float32)
    out = weights
    for c in classes.matmul:
        hi, lo = _hi_lo(ts, idx, c)  # (b, g)
        oh_hi = jax.nn.one_hot(hi, c.h, dtype=jnp.float32)  # (b, g, h)
        oh_lo = jax.nn.one_hot(lo, c.l, dtype=jnp.float32)  # (b, g, l)
        dsum = jnp.einsum(
            "bgh,bgl->ghl",
            oh_hi,
            oh_lo * dwv[:, None, None],
            precision=jax.lax.Precision.HIGHEST,
        )
        if mean:
            hits = jnp.einsum(
                "bgh,bgl->ghl",
                oh_hi,
                oh_lo * cv[:, None, None],
                precision=jax.lax.Precision.HIGHEST,
            )
            dsum = dsum / jnp.maximum(hits, 1.0)
        flat = dsum.reshape(c.g * c.h * c.l)
        cur = jax.lax.dynamic_slice(out, (c.start,), (flat.shape[0],))
        out = jax.lax.dynamic_update_slice(out, cur + flat, (c.start,))
    if len(classes.gather_feats):
        gf = jnp.asarray(classes.gather_feats)
        gidx = idx[:, gf]
        upd = jnp.broadcast_to(dwv[:, None], gidx.shape)
        if mean:
            contrib = jnp.broadcast_to(cv[:, None], gidx.shape)
            hits = jnp.zeros_like(out).at[gidx].add(contrib, mode="drop")
            upd = upd / jnp.maximum(hits[gidx], 1.0)
        out = out.at[gidx].add(upd, mode="drop")
    return out
