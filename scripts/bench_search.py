"""Microbenchmark: where does device expectimax time go?

Times the depth-d tree (``search/expectimax.py``) and its components
at eval-shaped batches on the live backend, to direct optimization of
device search (reference protocol: depth=3, width=4, since_empty=6,
``/root/reference/README.md:131-145``).
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from tpu2048.engine import core as engine
from tpu2048.engine import fast as engf
from tpu2048.features import ntuple
from tpu2048.ops import dispatch
from tpu2048.search.expectimax import make_expectimax_estimator


def timeit(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps


def main():
    if "--cpu" in sys.argv:
        sys.argv.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    games = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    width = 4
    ts = ntuple.get_tuple_set(n)
    key = jax.random.PRNGKey(0)
    kw, kb = jax.random.split(key)
    weights = ntuple.init_weights(ts, kw)

    print(f"backend={jax.default_backend()} n={n} games={games}", flush=True)

    # mid-game-looking boards (some empties, mixed tiles)
    roots = np.asarray(
        jax.random.randint(kb, (4 * games, 16), 0, 11, dtype=jnp.int8)
    ).copy()
    roots[roots > 8] = 0  # ~20% empties
    boards = jnp.asarray(roots.reshape(4 * games, 4, 4))

    # raw leaf-eval rate at tree-leaf batch size, per evaluator mode
    # (weights as a jit ARGUMENT — a closed-over table lowers as an
    # embedded HLO constant and would bloat/break at n=6's 0.4 GB)
    b_leaf = 4 * games * (4 * width) ** 2
    kb2 = jax.random.PRNGKey(1)
    lb = jax.random.randint(kb2, (b_leaf, 16), 0, 11, dtype=jnp.int8)
    for emode in ("gather", "onehot"):
        evm = dispatch.make_evaluator(ts, emode)
        f = jax.jit(lambda w, fb, e=evm: e(w, fb))
        dt = timeit(f, weights, lb)
        lookups = b_leaf * ts.num_feat
        print(f"leaf eval [{emode:6s}] b={b_leaf}: {dt*1e3:8.1f} ms  "
              f"{lookups/dt/1e6:8.1f} M lookups/s", flush=True)

    # engine expansion rate at inner-node batch size
    b_mid = 4 * games * 4 * width
    codes = engf.codes_from_boards(
        jnp.asarray(roots[: min(len(roots), b_mid)].reshape(-1, 4, 4))
    )
    codes = jnp.tile(codes, (max(1, b_mid // codes.shape[0]), 1))[:b_mid]
    g = jax.jit(lambda c: engf.afterstates_nc(c)[0])
    dt = timeit(g, codes)
    print(f"afterstates_nc b={b_mid}: {dt*1e3:8.1f} ms", flush=True)

    # full tree at depths 1..3, per evaluator mode
    for emode in ("gather", "onehot"):
        evm = dispatch.make_evaluator(ts, emode)
        for depth in (1, 2, 3):
            def tree(w, bb, kk, d=depth, e=evm):
                vf = lambda b: e(w, b.reshape(b.shape[:-2] + (16,)))
                return make_expectimax_estimator(vf, d, width, 6)(bb, kk)

            f = jax.jit(tree)
            dt = timeit(f, weights, boards, jax.random.PRNGKey(2), reps=3)
            leaves = 4 * games * (4 * width) ** depth
            print(f"tree [{emode:6s}] depth={depth}: {dt*1e3:8.1f} ms  "
                  f"({leaves/1e6:.2f}M leaves, "
                  f"{dt*1e3/games:.2f} ms/game-move)", flush=True)


if __name__ == "__main__":
    main()
