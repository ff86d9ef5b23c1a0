"""Worker process for the fault-injection test.

Trains an agent with periodic checkpoints; the parent test SIGKILLs it
mid-run (after at least one checkpoint landed) and then relaunches it
in resume mode to prove crash recovery (SURVEY §5 failure-detection
row; reference restarts from its last 1000-episode save,
``r_learning.py:264-267``).

Usage: python tests/_fault_worker.py <store_dir> <fresh|resume>
"""

import sys

sys.path.insert(0, ".")

import jax  # noqa: E402

import numpy as np  # noqa: E402


def main() -> None:
    store_dir, mode = sys.argv[1], sys.argv[2]
    resume = mode == "resume"
    from tpu2048.config import AgentConfig, TrainConfig
    from tpu2048.obs.jobs import JobRegistry
    from tpu2048.obs.logging import Logger
    from tpu2048.store.artifacts import LocalStore
    from tpu2048.train.loop import Trainer

    store = LocalStore(store_dir)
    # short lease: the parent asserts the crashed run's orphaned lease
    # is reaped by vacuum after expiry
    reg = JobRegistry(store, lease_sec=2.0)
    assert reg.acquire("agent", "fault_agent", parent=f"sess_{mode}")
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(
        num_envs=64,
        # fresh mode never finishes on its own — the parent kills it
        episodes=10_000_000 if not resume else 120,
        steps_per_call=8, ring_size=256, record_envs=2,
        max_record_steps=2048, checkpoint_every=40, seed=0,
    )
    tr = Trainer("fault_agent", acfg, tcfg, store=store,
                 logger=Logger(console=False), resume=resume)
    start = int(np.asarray(tr.state.metrics.episodes))
    print(f"START_EPISODES {start}", flush=True)
    out = tr.run()
    reg.release("agent", "fault_agent")
    print(f"DONE {out['episodes']}", flush=True)


if __name__ == "__main__":
    main()
