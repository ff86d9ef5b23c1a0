"""Benchmark harness — prints ONE JSON line.

Headline metric: full TD(0) actor-learner training throughput in
env-steps/s on one chip for the SHIPPED AgentConfig defaults — the
champion quality recipe (n=5 features, temporal-coherence optimizer,
per-move 8-image symmetry realized through canonical-orbit indices),
with the default TrainConfig recording (ALL envs logged for true
best-game capture).  The reference trains ~770 env-steps/s on its
1 CPU core (100k episodes / ~3 days, ~2k moves/episode —
README.md:12); vs_baseline is measured against that.  Auxiliary
fields: the round-1 pinned n=4 configuration (cross-round
comparability), the n=6 quality-flagship geometry, engine-only
throughput, and evaluation (policy-only) throughput.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

# Reference training throughput on its own hardware (env-steps/s):
# 100,000 episodes in ~3 days with ~2,000 moves/episode (README.md:12).
REF_TRAIN_STEPS_PER_SEC = 770.0


def _sync(x):
    return jax.block_until_ready(x)


def bench_train(n_envs=8192, k=64, reps=8, acfg=None, record_envs=-1):
    # k matches TrainConfig.steps_per_call (the SHIPPED default): the
    # headline must measure the defaults as shipped
    from tpu2048.agent import td
    from tpu2048.config import AgentConfig, TrainConfig
    from tpu2048.features import ntuple

    if acfg is None:
        # the shipped defaults: the champion quality recipe
        acfg = AgentConfig()
    ts = ntuple.get_tuple_set(acfg.n)
    tcfg = TrainConfig(
        num_envs=n_envs, steps_per_call=k, ring_size=8192,
        record_envs=record_envs, max_record_steps=16384, seed=0,
    )
    state = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(0))
    seg = jax.jit(td.make_train_segment(ts, acfg, tcfg), donate_argnums=0)
    state = seg(state)
    _sync(state.alpha)  # compile + warmup
    t0 = time.time()
    for _ in range(reps):
        state = seg(state)
    _sync(state.alpha)
    dt = time.time() - t0
    return reps * k * n_envs / dt


def bench_engine(n_envs=8192, k=256, reps=6):
    """Engine-only lockstep stepping: afterstates + spawn + auto-reset
    (packed row-code representation, the train-path engine)."""
    from tpu2048.engine import fast as eng

    def roll(codes, key):
        def body(c, _):
            cd, k2 = c
            aft, delta, legal, _t = eng.afterstates_full(cd)
            done = ~legal.any(axis=0)
            k2, ks, kr = jax.random.split(k2, 3)
            nc, _, _ = eng.spawn_codes(aft[0], ks)
            # anchor ALL four score lanes so XLA can't dead-code any of
            # the fused quad gather's score output
            nc = nc + (delta.sum(axis=0, keepdims=True).T * 0)
            nc = jnp.where(done[:, None], eng.new_codes(n_envs, kr), nc)
            return (nc, k2), None
        (codes, key), _ = jax.lax.scan(body, (codes, key), None, length=k)
        return codes

    f = jax.jit(roll)
    key = jax.random.PRNGKey(0)
    codes = eng.new_codes(n_envs, key)
    out = f(codes, key)
    _sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = f(out, key)
    _sync(out)
    dt = time.time() - t0
    return reps * k * n_envs / dt


def bench_eval(n_envs=8192, k=128, reps=4, n=5):
    """Greedy policy inference throughput (trained-agent play):
    codes engine + table eval, the production serve path.
    Default geometry is the SHIPPED AgentConfig n=5 (dense-exported
    table, identity indices — exactly what ``trial``/serving runs);
    ``n=4`` is kept as an auxiliary number for cross-round
    comparability."""
    from tpu2048.engine import fast as eng
    from tpu2048.features import ntuple
    from tpu2048.ops import dispatch as table_dispatch

    ts = ntuple.get_tuple_set(n)
    w = ntuple.init_weights(ts, jax.random.PRNGKey(0))
    eval_fn = table_dispatch.make_evaluator(ts, "auto")
    tperm = jnp.asarray(np.arange(16).reshape(4, 4).T.reshape(16))

    def roll(codes, key):
        def body(c, _):
            cd, k2 = c
            aft, delta, legal, _t = eng.afterstates_full(cd)
            cells4 = eng.cells_from_codes(aft)
            cells4 = jnp.stack(
                [cells4[0], cells4[1][..., tperm],
                 cells4[2], cells4[3][..., tperm]]
            )
            vals = eval_fn(w, cells4)
            masked = jnp.where(legal, vals, -jnp.inf)
            bd = jnp.argmax(masked, axis=0).astype(jnp.int32)
            ar = jnp.arange(n_envs)
            chosen = eng.canonicalize_chosen(aft[bd, ar], bd)
            done = ~legal.any(axis=0)
            k2, ks, kr = jax.random.split(k2, 3)
            nc, _, _ = eng.spawn_codes(chosen, ks)
            nc = jnp.where(done[:, None], eng.new_codes(n_envs, kr), nc)
            return (nc, k2), None
        (codes, key), _ = jax.lax.scan(body, (codes, key), None, length=k)
        return codes

    f = jax.jit(roll)
    key = jax.random.PRNGKey(0)
    codes = eng.new_codes(n_envs, key)
    out = f(codes, key)
    _sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = f(out, key)
    _sync(out)
    dt = time.time() - t0
    return reps * k * n_envs / dt


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler device trace of the "
                        "headline train benchmark (TensorBoard format)")
    args = p.parse_args(argv)
    from tpu2048.compile_cache import setup_compile_cache
    from tpu2048.config import AgentConfig

    setup_compile_cache()
    # initialize the device before timing anything
    _sync(jax.jit(lambda x: x * 2)(jnp.ones((8, 128))))

    if args.trace:
        from tpu2048.obs.profiler import device_trace

        with device_trace(args.trace):
            bench_train(reps=1)
        print(f"# trace written to {args.trace}", flush=True)

    champion_sps = bench_train()  # the SHIPPED defaults — headline
    n4_sps = bench_train(
        acfg=AgentConfig(n=4, optimizer="sgd", sym_mode="periodic",
                         alpha=0.25),
        record_envs=32,  # the round-1/2 pinned setting, comparability
    )
    n6_sps = bench_train(
        acfg=AgentConfig(n=6), reps=2
    )  # quality-flagship geometry
    engine_sps = bench_engine()
    eval_sps = bench_eval()  # SHIPPED defaults geometry (n=5)
    eval_n4_sps = bench_eval(n=4)  # round-1/2 comparability
    print(
        json.dumps(
            {
                "metric": "train_env_steps_per_sec_1chip_defaults",
                "value": round(champion_sps, 1),
                "unit": "env-steps/s",
                "vs_baseline": round(
                    champion_sps / REF_TRAIN_STEPS_PER_SEC, 2
                ),
                "train_n4_pinned_sps": round(n4_sps, 1),
                "train_n6_flagship_sps": round(n6_sps, 1),
                "engine_env_steps_per_sec": round(engine_sps, 1),
                "eval_env_steps_per_sec": round(eval_sps, 1),
                "eval_n4_env_steps_per_sec": round(eval_n4_sps, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
