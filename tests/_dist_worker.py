"""Worker process for the multi-process jax.distributed test.

Launched by tests/test_distributed.py as one of NUM_PROCESSES CPU
processes; brings up the control plane through
tpu2048.parallel.distributed.initialize (the framework's comm
backend), then runs a cross-process psum and one GSPMD-sharded TD
train segment over the global 2-device mesh (SURVEY §4: multi-host
logic validated on multi-process CPU without a cluster).

Usage: python tests/_dist_worker.py <coordinator> <num_procs> <pid> \
           [segment|trainer <store_dir>]
Prints "WORKER_OK <pid>" (segment) / "TRAINER_OK <pid>" (trainer) on
success.  Trainer mode runs the FULL ``Trainer`` driver — mesh-native
init, run, process-0 checkpointing, and a cross-process resume — the
multi-host story above the raw GSPMD segment (round-2 verdict item 2).
"""

import sys

sys.path.insert(0, ".")

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402


def run_trainer(nprocs: int, pid: int, store_dir: str) -> None:
    import numpy as np

    from tpu2048.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048.obs.logging import Logger
    from tpu2048.parallel import distributed
    from tpu2048.store.artifacts import LocalStore
    from tpu2048.train.loop import Trainer

    m = distributed.global_mesh(MeshConfig(data=nprocs, model=1))
    store = LocalStore(store_dir)
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(
        num_envs=8 * nprocs, episodes=80, steps_per_call=8, ring_size=256,
        record_envs=2, max_record_steps=2048, checkpoint_every=40, seed=0,
    )
    tr = Trainer("dist_agent", acfg, tcfg, store=store,
                 logger=Logger(console=False), mesh=m)
    out = tr.run()
    eps1 = out["episodes"]
    assert eps1 >= tcfg.episodes, eps1
    # the checkpoint must exist for every process (process 0 wrote it)
    assert store.load("a/dist_agent.json") is not None
    w1 = np.asarray(tr.state.weights)

    # cross-process resume: every process reloads the same checkpoint,
    # state is rebuilt mesh-native, and training continues
    tr2 = Trainer("dist_agent", acfg, tcfg, store=store,
                  logger=Logger(console=False), mesh=m, resume=True)
    eps_resumed = int(np.asarray(tr2.state.metrics.episodes))
    assert eps_resumed == eps1, (eps_resumed, eps1)
    np.testing.assert_array_equal(np.asarray(tr2.state.weights), w1)
    out2 = tr2.run()
    assert out2["episodes"] >= eps1 + tcfg.episodes, out2["episodes"]
    print(f"TRAINER_OK {pid}", flush=True)


def main() -> None:
    coord, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "segment"
    # initialize the control plane BEFORE importing any tpu2048 module
    # that might touch the backend (device constants at import time)
    from tpu2048.parallel import distributed

    ok = distributed.initialize(
        coordinator_address=coord, num_processes=nprocs, process_id=pid
    )
    assert ok, "distributed.initialize returned False with explicit args"
    if mode == "trainer":
        run_trainer(nprocs, pid, sys.argv[5])
        return
    from tpu2048.agent import td
    from tpu2048.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048.features import ntuple
    from tpu2048.parallel import mesh as pmesh
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == nprocs, jax.device_count()

    # data plane: a psum collective across processes
    m = distributed.global_mesh(MeshConfig(data=nprocs, model=1))
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.jit(
        lambda: jnp.full((nprocs,), jax.process_index() + 1.0),
        out_shardings=NamedSharding(m, P("data")),
    )()
    total = jax.jit(lambda a: a.sum(), out_shardings=NamedSharding(m, P()))(x)
    # each process contributed one element of value pid+1
    assert float(total) == sum(range(1, nprocs + 1)), float(total)

    # env-slice bookkeeping for host-fed batches
    sl = distributed.process_env_slice(8 * nprocs)
    assert sl == slice(pid * 8, (pid + 1) * 8), sl

    # one full GSPMD train segment over the global mesh
    ts = ntuple.get_tuple_set(2)
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(
        num_envs=4 * nprocs, steps_per_call=4, ring_size=64,
        record_envs=2, max_record_steps=64, seed=0,
    )
    sh = pmesh.td_state_shardings(m, acfg.engine_mode)
    state = jax.jit(
        lambda: td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(0)),
        out_shardings=sh,
    )()
    seg = pmesh.make_sharded_train_segment(ts, acfg, tcfg, m)
    out = seg(state)
    w = jax.jit(
        lambda s: jnp.abs(s.weights).sum(),
        out_shardings=NamedSharding(m, P()),
    )(out)
    assert float(w) > 0.0
    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
