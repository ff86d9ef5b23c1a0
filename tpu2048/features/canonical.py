"""Canonical-orbit indices: D4 symmetry as index normalization.

The reference applies every TD update to all 8 D4-symmetric board
images (``/root/reference/game2048/r_learning.py:207-214``).  Because
updates and reads are table lookups, the resulting table is constant
on every orbit of the induced entry permutation group — so the whole
scheme can be re-expressed with ONE representative entry per orbit:

    canon(e) = min over s of flat_index(T_s(e))

Reads go to ``canon(e)`` instead of ``e``; a per-move update adds its
delta once at ``canon(e)`` instead of once at every orbit member.  By
the orbit–stabilizer theorem the 8-image multiset puts exactly
``|stab(e)| = #{s : T_s(e) = canon(e)}`` copies of ``dw`` on each
distinct member, so scattering ``mult * dw`` at the canonical entry
reproduces the reference's "sum" numerics exactly, and scattering
``dw`` reproduces the collision-mean numerics (all 8 images of one
board carry the same ``dw``, so their per-entry mean is ``dw``).

Why this matters: the dense table-transform fold
(``features/symmetry.py``) costs full passes over the weight table per
step (0.38 GB at n=6) — while canonical indices keep the
per-step cost proportional to the BATCH: one extra index matmul and a
min-reduction, then a single sparse gather/scatter.  This is what the
small 16^2..16^4 tables do NOT need (dense per-class blocks plus a
4.5 MB class fold suffice), so the learner canonicalizes only the
large gather-path classes (16^5, 14^6).

The orbit of an entry is computed from the 8 symmetry images' feature
indices (``ntuple.all_symmetry_indices``): the T_s-image of identity
entry ``(f, i_f(board))`` is ``(f', i_{f'}(sym_s(board)))`` where f'
is the feature whose cell set is the s-image of f's cells — i.e. the
feature-relabeling component of the table transforms
(``symmetry.build_sym_transforms``).  ``tests/test_canonical.py`` pins
the whole construction against the explicit 8-image scatter.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ntuple import TupleSet, get_tuple_set
from .symmetry import build_sym_transforms


def is_canonical(acfg) -> bool:
    """True when the agent trains/evaluates in canonical-index form."""
    return acfg.sym_mode == "scatter" and acfg.sym_impl == "canonical"


@lru_cache(maxsize=None)
def feature_perm_table(n: int) -> np.ndarray:
    """(8, F) int32: fp[s, f] = feature holding the T_s-image of an
    entry of feature f (fp[0] = identity)."""
    ts = get_tuple_set(n)
    fp = np.zeros((8, ts.num_feat), np.int32)
    fp[0] = np.arange(ts.num_feat)
    for s in range(1, 8):
        for ft, fs, _perm in build_sym_transforms(n)[s - 1]:
            fp[s, fs] = ft
    return fp


@lru_cache(maxsize=None)
def _gather_feat_ids(n: int) -> np.ndarray:
    from ..ops.onehot import build_table_classes

    return build_table_classes(get_tuple_set(n)).gather_feats


@lru_cache(maxsize=None)
def _orbit_pack(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fused packing for the gather-class orbit indices.

    Returns (mat (32, 8*K) f32, off (8, K) i32) with the D4 cell
    permutations PRE-COMPOSED into the matrix: for the identity cell
    vector ``v = concat(x, min(x, 13))`` of a board,
        orbit_vals[., s, k] = v @ mat[:, s*K + k] + off[s, k]
    is the (global) index of the T_s-image of identity entry
    ``(gf[k], .)``.  One (B, 32) @ (32, 8K) matmul replaces the
    permuted (B, 8, 16) gather + batched (8-minor) einsum of the naive
    formulation — no per-image board copies, and a single
    contraction.

    Derivation: image s reads cell ``c`` of the permuted board, i.e.
    cell ``perm_s[c]`` of the identity board (same for the clipped
    half, since min(.,13) is elementwise), so the coefficient of
    identity column ``perm_s[c]`` is the permuted matrix's row ``c``.
    """
    ts = get_tuple_set(n)
    gf = _gather_feat_ids(n)
    fp = feature_perm_table(n)
    k = len(gf)
    mat = np.zeros((32, 8 * k), np.float32)
    off = np.zeros((8, k), np.int32)
    for s in range(8):
        feats = fp[s, gf]  # (K,)
        m_s = ts.matrix[feats].T  # (32, K) acting on the PERMUTED board
        perm = ts.sym_perms[s]
        for c in range(16):
            mat[perm[c], s * k: (s + 1) * k] += m_s[c]
            mat[16 + perm[c], s * k: (s + 1) * k] += m_s[16 + c]
        off[s] = ts.offsets[feats]
    return mat, off


def gather_feat_count(ts: TupleSet) -> int:
    return len(_gather_feat_ids(ts.n))


def canonical_gather_indices(
    ts: TupleSet, flat_boards: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """(..., 16) boards -> (canonical indices, orbit multiplicities)
    for the gather-class features only, both shaped (..., K).

    ``mult[b, k] = |stab|`` of the entry (# of symmetries fixing it);
    ``sum(mult over the orbit's distinct members) == 8`` always.
    """
    mat, off = _orbit_pack(ts.n)
    k = off.shape[1]
    if k == 0:
        shape = flat_boards.shape[:-1] + (0,)
        return (jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
    x = flat_boards.astype(jnp.float32)
    v = jnp.concatenate([x, jnp.minimum(x, 13.0)], axis=-1)  # (..., 32)
    local = jnp.dot(
        v,
        jnp.asarray(mat),  # (32, 8K), permutations pre-composed
        precision=jax.lax.Precision.HIGHEST,  # exact: see feature_indices
        preferred_element_type=jnp.float32,
    ).reshape(flat_boards.shape[:-1] + (8, k))
    vals = local.astype(jnp.int32) + jnp.asarray(off)  # (..., 8, K)
    canon = vals.min(axis=-2)
    mult = (vals == canon[..., None, :]).sum(axis=-2).astype(jnp.int32)
    return canon, mult


def canonical_mask(ts: TupleSet) -> np.ndarray:
    """(total,) bool host-side mask of entries that are canonical (the
    min of their orbit).  O(total * 8) numpy; for conversions only."""
    from .symmetry import _table_geometry

    offsets, sizes, bases, ks, _classes = _table_geometry(ts)
    fp = feature_perm_table(ts.n)
    transforms = build_sym_transforms(ts.n)
    mask = np.ones(ts.total, bool)
    for f in range(ts.num_feat):
        size, base, kk = sizes[f], bases[f], ks[f]
        idx = np.arange(size, dtype=np.int64)
        digits = [(idx // base ** (kk - 1 - j)) % base for j in range(kk)]
        best = offsets[f] + idx  # identity image
        for s in range(1, 8):
            ft, _fs, perm = next(
                m for m in transforms[s - 1] if m[1] == f
            )
            # T_s maps source entry (f, i) to (ft, j) where digit d of
            # j at position p equals digit perm[p] of i (the transform
            # writes out[ft] = transposed in[f]; same algebra as
            # symmetry._apply_transform).
            j = np.zeros_like(idx)
            for p in range(kk):
                j += digits[perm[p]] * base ** (kk - 1 - p)
            best = np.minimum(best, offsets[ft] + j)
        mask[offsets[f]: offsets[f] + size] &= (
            best == offsets[f] + np.arange(size, dtype=np.int64)
        )
    return mask


@lru_cache(maxsize=None)
def _gather_region(n: int) -> np.ndarray:
    """(total,) bool: True on entries of the gather-path classes (the
    only classes the canonical representation transforms — the small
    16^2..16^4 classes stay dense/identity in either form)."""
    ts = get_tuple_set(n)
    gf = _gather_feat_ids(n)
    region = np.zeros(ts.total, bool)
    for f in gf:
        region[ts.offsets[f]: ts.offsets[f] + ts.sizes[f]] = True
    return region


def to_dense_table(ts: TupleSet, w_canonical: jax.Array) -> jax.Array:
    """Expand a canonical-form table to the orbit-constant dense table
    the identity-index evaluators (trial, native engine, watch) read.

    On the gather classes, dense[e] = w[canon(e)]: the D4 orbit sum of
    the canonical-masked ``w`` places ``|stab(e)| * w[canon(e)]`` at
    every entry e, and the same sum over the canonical indicator
    yields exactly ``|stab(e)|`` — one elementwise divide recovers the
    dense values.  The matmul classes pass through unchanged (they are
    identity-indexed in both representations).  One-off (used at agent
    export/serve time); costs one fold pass over the table.
    """
    from .symmetry import symmetrize_sum

    region = jnp.asarray(_gather_region(ts.n), jnp.float32)
    if not len(_gather_feat_ids(ts.n)):
        return w_canonical
    ind = jnp.asarray(canonical_mask(ts), jnp.float32) * region
    num = symmetrize_sum(ts, w_canonical * ind)
    den = symmetrize_sum(ts, ind)
    dense_g = num / jnp.maximum(den, 1.0)
    return jnp.where(region > 0, dense_g, w_canonical)


def from_dense_table(ts: TupleSet, w_dense: jax.Array) -> jax.Array:
    """Project a dense table into canonical form: orbit-average the
    gather classes and keep the canonical representative (exact
    inverse of ``to_dense_table`` for orbit-constant tables; the D4
    projection of anything else, e.g. the reference's random init).
    Matmul classes pass through unchanged."""
    from .symmetry import symmetrize_sum

    if not len(_gather_feat_ids(ts.n)):
        return w_dense
    region = jnp.asarray(_gather_region(ts.n), jnp.float32)
    ind = jnp.asarray(canonical_mask(ts), jnp.float32) * region
    num = symmetrize_sum(ts, w_dense * region)
    canon_g = (num / 8.0) * ind
    return jnp.where(region > 0, canon_g, w_dense)
