"""Primitive-cost probe: scatter/gather/sort shapes of the canonical
TD step, each rolled K times inside ONE jit (no op-by-op dispatch,
one compile + a few calls per case).

Splits the canonical step's sparse work into colliding scatter-adds
vs unique-index scatter-adds vs sorts vs gathers vs the dense
hits-count chain vs the metrics ring scatter.

Usage: python scripts/bench_scatter_probe.py [total] [m] [iters]
  total: table size (default n=5 gather region ~5.3M)
  m:     update lanes per step (default 8192*4)
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


def timeit_scan(body, carry, iters, reps=3):
    """Time body scanned `iters` times inside one jit."""

    def f(c):
        out, _ = jax.lax.scan(lambda cc, _: (body(cc), None), c, None,
                              length=iters)
        return out

    jf = jax.jit(f)
    out = jf(carry)
    np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])  # sync
    t0 = time.time()
    for _ in range(reps):
        out = jf(out)
    np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
    return (time.time() - t0) / reps / iters


def main():
    total = int(sys.argv[1]) if len(sys.argv) > 1 else 5_308_416
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 8192 * 4
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    print(f"backend={jax.default_backend()} total={total} m={m} "
          f"iters={iters}", flush=True)

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    idx0 = jax.random.randint(k1, (m,), 0, total, dtype=jnp.int32)
    vals0 = jax.random.normal(k2, (m,), jnp.float32) * 1e-3
    w0 = jnp.zeros((total,), jnp.float32)

    # 1. colliding scatter-add (the current gather-class update shape)
    def s_collide(c):
        w, i, v = c
        return (w.at[i].add(v, mode="drop"), i, v)

    dt = timeit_scan(s_collide, (w0, idx0, vals0), iters)
    print(f"scatter-add colliding:        {dt*1e3:8.3f} ms", flush=True)

    # 2. unique-index scatter-add (post-dedup shape; same lane count,
    #    sorted unique indices by construction)
    idx_u = jnp.sort(
        jax.random.permutation(k1, total)[:m].astype(jnp.int32)
    )

    def s_unique(c):
        w, i, v = c
        return (w.at[i].add(v, mode="drop", unique_indices=True), i, v)

    dt = timeit_scan(s_unique, (w0, idx_u, vals0), iters)
    print(f"scatter-add unique+sorted:    {dt*1e3:8.3f} ms", flush=True)

    # 2b. unique scatter WITHOUT the promise flag
    dt = timeit_scan(s_collide, (w0, idx_u, vals0), iters)
    print(f"scatter-add unique, no flag:  {dt*1e3:8.3f} ms", flush=True)

    # 3. gather at the same lanes
    def g_rand(c):
        w, i, v = c
        return (w, i, v + w[i])

    dt = timeit_scan(g_rand, (w0, idx0, vals0), iters)
    print(f"gather random:                {dt*1e3:8.3f} ms", flush=True)

    # 4. sort (key, val) pairs
    def srt(c):
        i, v = c
        ks, vs = jax.lax.sort([i, v], num_keys=1)
        return (ks, vs + 0)

    dt = timeit_scan(srt, (idx0, vals0), iters)
    print(f"sort m pairs:                 {dt*1e3:8.3f} ms", flush=True)

    # 5. dense hits chain: zeros(total) + scatter-add + gather back
    def hits_chain(c):
        w, i, v = c
        hits = jnp.zeros((total,), jnp.float32).at[i].add(
            jnp.ones_like(v), mode="drop")
        return (w, i, v / jnp.maximum(hits[i], 1.0))

    dt = timeit_scan(hits_chain, (w0, idx0, vals0), iters)
    print(f"dense hits chain:             {dt*1e3:8.3f} ms", flush=True)

    # 6. metrics-ring-shaped scatter: N lanes, mostly dropped
    n_env = 8192
    ring = 8192
    done0 = jax.random.uniform(k2, (n_env,)) < 0.01
    score0 = jax.random.randint(k1, (n_env,), 0, 100000, jnp.int32)

    def ring_scatter(c):
        r, pos, done, score = c
        order = jnp.cumsum(done.astype(jnp.int32)) - 1
        wpos = jnp.where(done, (pos + order) % ring, ring)
        r = r.at[wpos].set(score, mode="drop")
        return (r, pos + done.sum(), done, score)

    r0 = jnp.zeros((ring + 1,), jnp.int32)
    dt = timeit_scan(ring_scatter, (r0, jnp.int32(0), done0, score0),
                     iters)
    print(f"ring scatter (N lanes):       {dt*1e3:8.3f} ms", flush=True)

    # 7. full sorted-dedup update chain (sort + seg sums + 3 unique
    #    scatters + 2 gathers) — the candidate replacement
    def dedup_chain(c):
        w, e, a, i, v = c
        ks, vs = jax.lax.sort([i, v], num_keys=1)
        ar = jnp.arange(m)
        is_first = jnp.concatenate(
            [jnp.ones((1,), bool), ks[1:] != ks[:-1]])
        first_pos = jax.lax.cummax(jnp.where(is_first, ar, -1))
        is_last = jnp.concatenate(
            [ks[1:] != ks[:-1], jnp.ones((1,), bool)])
        # last position of my segment: reverse cummin of masked arange
        rev = jnp.flip(jnp.where(is_last, ar, m))
        last_pos = jnp.flip(jax.lax.cummin(rev))
        cs = jnp.cumsum(vs)
        ca = jnp.cumsum(jnp.abs(vs))
        seg_sum = cs[last_pos] - jnp.where(first_pos > 0,
                                           cs[first_pos - 1], 0.0)
        seg_abs = ca[last_pos] - jnp.where(first_pos > 0,
                                           ca[first_pos - 1], 0.0)
        cnt = (last_pos - first_pos + 1).astype(jnp.float32)
        dbar = seg_sum / cnt
        tgt = jnp.where(is_first, ks, total)
        e_g = e[ks]
        a_g = a[ks]
        lr = jnp.where(a_g > 0, jnp.abs(e_g) / jnp.maximum(a_g, 1e-30),
                       1.0)
        w = w.at[tgt].add(lr * dbar, mode="drop", unique_indices=True)
        e = e.at[tgt].add(dbar, mode="drop", unique_indices=True)
        a = a.at[tgt].add(seg_abs / cnt, mode="drop",
                          unique_indices=True)
        return (w, e, a, i, v)

    dt = timeit_scan(dedup_chain, (w0, w0, w0, idx0, vals0), iters)
    print(f"sorted-dedup TC chain:        {dt*1e3:8.3f} ms", flush=True)

    # 8. current sparse TC chain (dense hits + 2 gathers + 3 colliding
    #    scatters) — what the canonical step does today
    def current_chain(c):
        w, e, a, i, v = c
        hits = jnp.zeros((total,), jnp.float32).at[i].add(
            jnp.ones_like(v), mode="drop")
        per = v / jnp.maximum(hits[i], 1.0)
        e_g, a_g = e[i], a[i]
        lr = jnp.where(a_g > 0, jnp.abs(e_g) / jnp.maximum(a_g, 1e-30),
                       1.0)
        w = w.at[i].add(lr * per, mode="drop")
        e = e.at[i].add(per, mode="drop")
        a = a.at[i].add(jnp.abs(per), mode="drop")
        return (w, e, a, i, v)

    dt = timeit_scan(current_chain, (w0, w0, w0, idx0, vals0), iters)
    print(f"current sparse TC chain:      {dt*1e3:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
