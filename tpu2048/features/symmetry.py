"""D4 symmetry as a structured permutation of the flat weight table.

The reference applies every TD update to the features of all 8
symmetric board images (``r_learning.py:207-214``) — 8x the scatter
traffic on the hot path.  This module exploits the algebra instead:
the D4 action on boards induces a FIXED permutation of the flat table
that decomposes per tuple into (a) a relabeling of tuples within the
geometry (rows <-> columns, etc.) and (b) a base-B digit permutation of
the sub-table index — i.e. a transpose of the sub-table viewed as a
(B,)*k array.  So

    sum_s scatter(features(sym_s(board)), dw)
  == sum_s T_s( scatter(features(board), dw) )

where each T_s is a bank of per-tuple reshape+transpose copies that run
at memory bandwidth.  The learner scatters identity features only and
folds the accumulated delta through all 8 transforms once per jitted
segment ("periodic" symmetry mode) — the per-image updates land with at
most steps_per_call delay, which is negligible against mini-batch TD
semantics and is validated by the learning-quality tests.

``tests/test_symmetry.py`` pins T_s numerically against the explicit
8-image scatter for every n.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import jax
import jax.numpy as jnp

from .ntuple import TupleSet, _cell_tuples, get_tuple_set

# (f_target, f_source, digit axes perm) per sym s=1..7
SymMaps = List[List[Tuple[int, int, Tuple[int, ...]]]]


@lru_cache(maxsize=None)
def build_sym_transforms(n: int) -> SymMaps:
    ts = get_tuple_set(n)
    cells_list = []
    bases = []
    for cells, base in _cell_tuples(n):
        cells_list.append([i * 4 + j for i, j in cells])
        bases.append(base)
    out: SymMaps = []
    for s in range(1, 8):
        perm_cells = ts.sym_perms[s]
        maps = []
        for ft, cells_t in enumerate(cells_list):
            target_cells = [int(perm_cells[c]) for c in cells_t]
            fs = next(
                f2
                for f2, cells_s in enumerate(cells_list)
                if bases[f2] == bases[ft]
                and set(cells_s) == set(target_cells)
            )
            cells_s = cells_list[fs]
            digit_perm = tuple(cells_s.index(tc) for tc in target_cells)
            maps.append((ft, fs, digit_perm))
        out.append(maps)
    return out


def _table_geometry(ts: TupleSet):
    offsets = [int(o) for o in ts.offsets]
    sizes = [int(z) for z in ts.sizes]
    bases = [
        16 if z in (16**2, 16**3, 16**4, 16**5, 16**6) else 14
        for z in sizes
    ]
    ks = []
    for z, b in zip(sizes, bases):
        k = 0
        v = 1
        while v < z:
            v *= b
            k += 1
        ks.append(k)
    # contiguous same-size classes (ascending offsets by construction)
    classes = []  # (f0, g, size)
    f = 0
    while f < len(sizes):
        g = 1
        while f + g < len(sizes) and sizes[f + g] == sizes[f]:
            g += 1
        classes.append((f, g, sizes[f]))
        f += g
    return offsets, sizes, bases, ks, classes


def _apply_transform(ts: TupleSet, delta: jax.Array, maps) -> jax.Array:
    """One D4 table transform T_s of the full flat table.

    Digit permutations run through the streaming-pass planner
    (ops/digit_perm.py), which replaces naive rank-5/6 transposes with
    14/16-wide dims by a few wide 2D passes.  Tables of one size class that share a digit perm
    are stacked and transformed in ONE batched op chain (fewer, wider
    passes).
    """
    from ..ops.digit_perm import digit_transpose

    offsets, sizes, bases, ks, classes = _table_geometry(ts)
    lead = delta.shape[:-1]
    num_feat = len(sizes)
    pieces = [None] * num_feat
    by_class_perm = {}
    for ft, fs, perm in maps:
        key = (next(i for i, (f0, g, _) in enumerate(classes)
                    if f0 <= fs < f0 + g), perm)
        by_class_perm.setdefault(key, []).append((ft, fs))
    for (ci, perm), pairs in by_class_perm.items():
        f0, g, size = classes[ci]
        b, k = bases[f0], ks[f0]
        cls = delta[..., offsets[f0]: offsets[f0] + g * size]
        cls = cls.reshape(lead + (g, size))
        fs_local = jnp.asarray([fs - f0 for _, fs in pairs])
        src = jnp.take(cls, fs_local, axis=-2)  # (lead, |pairs|, size)
        tr = digit_transpose(src, b, k, perm)
        for i, (ft, _) in enumerate(pairs):
            pieces[ft] = tr[..., i, :]
    return jnp.concatenate(pieces, axis=-1)


def symmetrize_sum(ts: TupleSet, delta: jax.Array) -> jax.Array:
    """sum over ALL 8 D4 transforms of ``delta`` (identity included).

    D4 is solvable — {e} < {e,m} < {e,m,r2,mr2} < D4 — so the 8-term
    orbit sum factors into THREE doubling steps, each one full-table
    transform-and-add:

        y1 = x + T_m(x);  y2 = y1 + T_r2(y1);  y3 = y2 + T_r(y2)

    because the products {r^a r2^b m^c : a,b,c in {0,1}} enumerate every
    group element exactly once.  3 transform passes instead of 7 — the
    difference is pure HBM bandwidth on the per-step hot path.
    ``tests/test_symmetry.py`` pins this against the explicit 8-image
    scatter for every n.

    ``delta`` may carry leading batch dimensions ``(..., total)`` — the
    transform bank applies to each slice independently (used to fold a
    stacked [dsum; hits] pair in one pass).
    """
    transforms = build_sym_transforms(ts.n)
    # sym_perms rows (see ntuple._d4_perms): s=1 transpose (m),
    # s=2 rot90 (r), s=4 rot180 (r^2); transforms[s-1] is T_s.
    y = delta + _apply_transform(ts, delta, transforms[0])  # m
    y = y + _apply_transform(ts, y, transforms[3])  # r^2
    y = y + _apply_transform(ts, y, transforms[1])  # r
    return y


def _apply_class_transform(
    ts: TupleSet, block: jax.Array, maps, feat0: int, g: int
) -> jax.Array:
    """T_s restricted to one size class: ``block`` is (..., g, size)
    holding the class's g per-tuple tables.  The feature relabeling of
    every T_s maps same-size tables among themselves (the cell-set
    image keeps the base and arity), so the restriction is closed."""
    from ..ops.digit_perm import digit_transpose

    _offsets, _sizes, bases, ks, _classes = _table_geometry(ts)
    base, k = bases[feat0], ks[feat0]
    pieces = [None] * g
    by_perm = {}
    for ft, fs, perm in maps:
        if feat0 <= ft < feat0 + g:
            assert feat0 <= fs < feat0 + g, "class not closed under D4"
            by_perm.setdefault(perm, []).append((ft - feat0, fs - feat0))
    for perm, pairs in by_perm.items():
        fs_l = jnp.asarray([fs for _, fs in pairs])
        src = jnp.take(block, fs_l, axis=-2)  # (..., |pairs|, size)
        tr = digit_transpose(src, base, k, perm)
        for i, (ft, _) in enumerate(pairs):
            pieces[ft] = tr[..., i, :]
    return jnp.stack(pieces, axis=-2)


def symmetrize_class_sum(
    ts: TupleSet, feat0: int, g: int, block: jax.Array
) -> jax.Array:
    """``symmetrize_sum`` restricted to one size class's (..., g, size)
    block — same 3-doubling-pass factorization, touching only the
    class's bytes.  Used by the canonical-index learner, where only
    the small 16^2..16^4 classes still fold densely (the big classes carry
    their symmetry in the indices — see features/canonical.py)."""
    transforms = build_sym_transforms(ts.n)
    y = block + _apply_class_transform(ts, block, transforms[0], feat0, g)
    y = y + _apply_class_transform(ts, y, transforms[3], feat0, g)
    y = y + _apply_class_transform(ts, y, transforms[1], feat0, g)
    return y


def fold_other_symmetries(ts: TupleSet, delta: jax.Array) -> jax.Array:
    """sum over the 7 non-identity D4 transforms of ``delta``.

    ``w + delta + fold_other_symmetries(ts, delta)`` equals applying the
    reference's 8-image update with accumulated identity delta.
    """
    return symmetrize_sum(ts, delta) - delta


def symmetrize_table(ts: TupleSet, w: jax.Array) -> jax.Array:
    """Average of a table over its full D4 orbit (symmetric projection)."""
    return symmetrize_sum(ts, w) / 8.0
