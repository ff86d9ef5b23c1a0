"""Fast digit permutations of (b,)*k tables (bandwidth-pass planner).

The D4 symmetry fold (``features/symmetry.py``) needs arbitrary digit
permutations of base-16 / base-14 tables: ``transpose(x.reshape((b,)*k),
perm)``.  A rank-5/6 transpose with 14/16-wide trailing dims is a
poor memory access pattern for a compiler to lower as one op.

This module re-expresses any digit permutation as a short sequence of
three bandwidth-friendly primitives on the FLAT array:

  * ``rot j``  — ``x.reshape(b**j, -1).T``: a 2D transpose (a left
    rotation of the digit order by j) whose dims can both be kept wide;
  * ``rows (j, sigma)`` — ``x.reshape(b**j, -1)[m]``: a permutation of
    b**j contiguous row blocks (a wide row gather), realizing an
    arbitrary permutation sigma of the leading j digits;
  * ``cols (m, sigma)`` — ``x.reshape(-1, b**m) @ P``: an exact
    one-hot permutation matmul over the trailing m digits.

Rotations by j and j' compose to rotations by (j + j') mod k, and
leading/trailing-digit permutations conjugated through rotations
generate the full symmetric group, so every permutation has a plan; a
breadth-first search over the k! digit arrangements finds the fewest-
pass plan per permutation (typically 1-3 passes of pure streaming
traffic instead of one lane-shuffling transpose).

For the large classes (16^5, 14^6) every pass must tile onto full
(sublane, lane) tiles, so 2D views are kept >= 128 on both sides; the
small classes (<= 16^4) get a wider op alphabet (dims down to 16) —
their traffic is small enough that a modestly off-bandwidth pass is
still far cheaper than the naive transpose.

Used by the per-step symmetry fold, where this is the difference
between the n=6 agent training at ~35k vs >200k env-steps/s.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

Op = Tuple  # ("rot", j) | ("rows", j, sigma)


def _allowed_js(k: int, base: int, min_dim: int) -> List[int]:
    return [
        j
        for j in range(1, k)
        if base**j >= min_dim and base ** (k - j) >= min_dim
    ]


def _allowed_ms(k: int, base: int) -> List[int]:
    """Trailing-digit groups small enough for a one-hot permutation
    matmul (b**m <= 256)."""
    return [m for m in range(1, k) if base**m <= 256]


@lru_cache(maxsize=None)
def _plans(k: int, base: int, min_dim: int) -> dict:
    """BFS over digit arrangements: shortest op plan for every
    reachable permutation.  State = tuple ``cur`` where ``cur[i]`` is
    the ORIGINAL digit index currently at position i."""
    js = _allowed_js(k, base, min_dim)
    ms = _allowed_ms(k, base)
    ident = tuple(range(k))
    plans = {ident: ()}
    frontier = [ident]
    while frontier:
        nxt = []
        for cur in frontier:
            base_plan = plans[cur]
            cands: List[Tuple[Tuple[int, ...], Op]] = []
            for j in js:
                cands.append((cur[j:] + cur[:j], ("rot", j)))
                for sigma in permutations(range(j)):
                    if sigma == tuple(range(j)):
                        continue
                    new = tuple(cur[s] for s in sigma) + cur[j:]
                    cands.append((new, ("rows", j, sigma)))
            for m in ms:
                for sigma in permutations(range(m)):
                    if sigma == tuple(range(m)):
                        continue
                    new = cur[: k - m] + tuple(
                        cur[k - m + s] for s in sigma
                    )
                    cands.append((new, ("cols", m, sigma)))
            for state, op in cands:
                if state not in plans:
                    plans[state] = base_plan + (op,)
                    nxt.append(state)
        frontier = nxt
    return plans


def plan(k: int, base: int, perm: Tuple[int, ...], min_dim: int):
    """Op sequence realizing ``transpose(x.reshape((base,)*k), perm)``,
    or None when the alphabet cannot reach ``perm`` (callers fall back
    to the plain transpose)."""
    return _plans(k, base, min_dim).get(tuple(perm))


@lru_cache(maxsize=None)
def _row_perm(base: int, j: int, sigma: Tuple[int, ...]) -> np.ndarray:
    """Row-index map m with out_rows[r] = in_rows[m[r]] for the op that
    puts (old digit at position sigma[i]) at new position i."""
    bj = base**j
    r = np.arange(bj)
    m = np.zeros(bj, np.int64)
    for i in range(j):
        digit = (r // base ** (j - 1 - i)) % base
        m += digit * base ** (j - 1 - int(sigma[i]))
    return m.astype(np.int32)


@lru_cache(maxsize=None)
def _col_perm_matrix(base: int, m: int, sigma: Tuple[int, ...]) -> np.ndarray:
    """One-hot matrix P with (x @ P) permuting the trailing m digits:
    out column c holds in column _row_perm(...)[c] (same index algebra
    as the row op, expressed as P[src, dst] = 1)."""
    src = _row_perm(base, m, sigma)
    bm = base**m
    p = np.zeros((bm, bm), np.float32)
    p[src, np.arange(bm)] = 1.0
    return p


def apply_plan(x: jnp.ndarray, ops, base: int, size: int) -> jnp.ndarray:
    """Apply a plan to ``x`` of shape (..., size); returns same shape.

    Each op is one full streaming pass (transpose of a wide 2D view, a
    row-block gather, or an exact one-hot permutation matmul); nothing
    ever reshapes to the slow (b,)*k form.
    """
    import jax

    lead = x.shape[:-1]
    for op in ops:
        if op[0] == "rot":
            j = op[1]
            bj = base**j
            x = jnp.swapaxes(x.reshape(lead + (bj, size // bj)), -1, -2)
        elif op[0] == "rows":
            _, j, sigma = op
            bj = base**j
            m = jnp.asarray(_row_perm(base, j, sigma))
            x = jnp.take(x.reshape(lead + (bj, size // bj)), m, axis=-2)
        else:  # cols: exact — P is 0/1, so each product term is an
            # exact f32 copy of one element (HIGHEST rules out TF32 /
            # bf16 operand rounding)
            _, m_, sigma = op
            bm = base**m_
            p = jnp.asarray(_col_perm_matrix(base, m_, sigma))
            x = jnp.dot(
                x.reshape(lead + (size // bm, bm)),
                p,
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
    return x.reshape(lead + (size,))


def digit_transpose(x: jnp.ndarray, base: int, k: int,
                    perm: Tuple[int, ...]) -> jnp.ndarray:
    """``transpose(x.reshape(lead + (base,)*k), lead-shifted perm)``
    flattened back to (lead..., base**k), via the fastest available
    path: planned streaming passes when reachable, else the plain
    transpose (acceptable only for small tables)."""
    size = base**k
    lead = x.shape[:-1]
    perm = tuple(perm)
    if perm == tuple(range(k)):
        return x
    min_dim = 128 if size >= (1 << 20) else 16
    ops = plan(k, base, perm, min_dim)
    if ops is not None:
        return apply_plan(x, ops, base, size)
    nl = len(lead)
    axes = tuple(range(nl)) + tuple(nl + p for p in perm)
    return jnp.transpose(
        x.reshape(lead + (base,) * k), axes=axes
    ).reshape(lead + (size,))
