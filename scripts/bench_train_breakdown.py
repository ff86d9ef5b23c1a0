"""Microbenchmark: where does the TD train step's time go?

Times the step's components in isolation for a given geometry on the
live backend — afterstate eval, identity accumulate, D4 fold
(symmetrize_sum), dense TC update, and the explicit 8-image accumulate
— to direct optimization of train throughput.

Usage: python scripts/bench_train_breakdown.py [n] [num_envs]
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from tpu2048.engine import fast as engf
from tpu2048.features import ntuple
from tpu2048.features.symmetry import symmetrize_sum
from tpu2048.ops import dispatch


def _sync(out):
    jax.block_until_ready(out)


def timeit(fn, *args, reps=5):
    out = fn(*args)
    _sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return (time.time() - t0) / reps


def main():
    if "--cpu" in sys.argv:
        sys.argv.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    envs = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    ts = ntuple.get_tuple_set(n)
    key = jax.random.PRNGKey(0)
    weights = ntuple.init_weights(ts, key)
    print(f"backend={jax.default_backend()} n={n} envs={envs} "
          f"table={ts.total/1e6:.1f}M entries", flush=True)

    codes = engf.new_codes(envs, key)
    for _ in range(3):  # roll to mid-game-ish boards
        aft, _, legal, _t = engf.afterstates_full(codes)
        codes = jnp.where(legal.any(0)[:, None], aft[0], codes)
    cells = np.asarray(engf.cells_from_codes(codes))
    boards = jnp.asarray(cells, jnp.int8)
    idx1 = ntuple.feature_indices(ts, boards)  # (N, F)
    dw = jax.random.normal(jax.random.PRNGKey(1), (envs,)) * 1e-3
    valid = jnp.ones((envs,), bool)

    # (0) achievable dense-pass rate on this table size (roofline)
    f_axpy = jax.jit(lambda a, b: a + 0.5 * b)
    dt = timeit(f_axpy, weights, weights)
    gb = weights.nbytes * 3 / 1e9
    print(f"dense axpy (1 pass, {gb:.2f} GB): {dt*1e3:8.2f} ms "
          f"({gb/dt:6.1f} GB/s)", flush=True)

    # (a) full 4-afterstate expansion + evaluation (the actor side)
    ev = dispatch.make_evaluator(ts, "auto")
    tperm = jnp.asarray(np.arange(16).reshape(4, 4).T.reshape(16))

    def actor(w, cd):
        aft, delta, legal, _t = engf.afterstates_full(cd)
        c4 = engf.cells_from_codes(aft)
        c4 = jnp.stack([c4[0], c4[1][..., tperm], c4[2], c4[3][..., tperm]])
        return ev(w, c4).sum() + delta.sum()

    dt = timeit(jax.jit(actor), weights, codes)
    print(f"actor (expand+eval x4):      {dt*1e3:8.2f} ms", flush=True)

    # (b) identity accumulate -> (dsum, hits)
    acc = dispatch.make_delta_accumulator(ts, "auto")
    f_acc = jax.jit(lambda w, i, d, v: acc(w, i, d, v))
    dt = timeit(f_acc, weights, idx1, dw, valid)
    print(f"accumulate (identity):       {dt*1e3:8.2f} ms", flush=True)

    # (c) D4 fold of the stacked [dsum; hits] pair (sym_impl="fold")
    pair = jnp.stack([weights, weights * 0.5])
    f_fold = jax.jit(lambda p: symmetrize_sum(ts, p))
    dt = timeit(f_fold, pair)
    print(f"fold (symmetrize_sum x2):    {dt*1e3:8.2f} ms", flush=True)

    # (d) dense TC update (lr compute + apply + accumulator update)
    def tc_update(w, e, a, dsum, hits):
        dbar = dsum / jnp.maximum(hits, 1.0)
        lr = jnp.where(a > 0.0, jnp.abs(e) / jnp.maximum(a, 1e-30), 1.0)
        return w + lr * dbar, e + dbar, a + jnp.abs(dbar)

    z = jnp.zeros_like(weights)
    dt = timeit(jax.jit(tc_update), weights, z, z, z, z)
    print(f"tc dense update:             {dt*1e3:8.2f} ms", flush=True)

    # (e) explicit 8-image accumulate (sym_impl="index")
    idx8 = ntuple.all_symmetry_indices(ts, boards).reshape(
        envs * 8, ts.num_feat
    )
    dw8 = jnp.broadcast_to(dw[:, None], (envs, 8)).reshape(-1)
    v8 = jnp.ones((envs * 8,), bool)
    dt = timeit(f_acc, weights, idx8, dw8, v8)
    print(f"accumulate (8-image index):  {dt*1e3:8.2f} ms", flush=True)

    # (f) gather-path share of (b): scatter into ONLY the gather classes
    from tpu2048.ops import onehot as oh

    classes = oh.build_table_classes(ts)
    if len(classes.gather_feats):
        gf = jnp.asarray(classes.gather_feats)

        def acc_gather_only(w, i, d, v):
            gi = i[:, gf]
            upd = jnp.broadcast_to(d[:, None], gi.shape)
            cv = jnp.broadcast_to(v[:, None], gi.shape).astype(jnp.float32)
            zz = jnp.zeros_like(w)
            return (zz.at[gi].add(upd, mode="drop"),
                    zz.at[gi].add(cv, mode="drop"))

        dt = timeit(jax.jit(acc_gather_only), weights, idx1, dw, valid)
        print(f"accumulate (gather classes only): {dt*1e3:8.2f} ms",
              flush=True)


if __name__ == "__main__":
    main()
