"""Run a sequence of training experiments in ONE process.

One process for the whole matrix (one compile cache, one device
claim) — and logs each run's per-1000
summaries under a distinct agent name for later comparison.

Usage: python scripts/quality_matrix.py [matrix.json]
Default matrix compares batched-TD variants for sample efficiency.
"""

import faulthandler
import json
import sys
import time

sys.path.insert(0, ".")
faulthandler.enable()

from tpu2048.config import AgentConfig, TrainConfig
from tpu2048.obs.logging import Logger
from tpu2048.store.artifacts import open_store
from tpu2048.train.loop import Trainer

DEFAULT = [
    # name, acfg overrides, tcfg overrides
    {"name": "m_1k_per", "agent": {"n": 5, "sym_mode": "periodic"},
     "train": {"num_envs": 1024, "episodes": 30000}},
    {"name": "m_1k_sca", "agent": {"n": 5, "sym_mode": "scatter"},
     "train": {"num_envs": 1024, "episodes": 30000}},
    {"name": "m_8k_sca", "agent": {"n": 5, "sym_mode": "scatter"},
     "train": {"num_envs": 8192, "episodes": 30000}},
]


def main():
    if len(sys.argv) > 1:
        matrix = json.load(open(sys.argv[1]))
    else:
        matrix = DEFAULT
    store = open_store("local", root="~/.tpu2048")
    for spec in matrix:
        name = spec["name"]
        acfg = AgentConfig(**spec.get("agent", {}))
        tcfg = TrainConfig(**spec.get("train", {}))
        print(f"\n===== {name}: {spec} =====", flush=True)
        t0 = time.time()
        tr = Trainer(name, acfg, tcfg, store=store,
                     logger=Logger(console=True))
        out = tr.run()
        print(f"===== {name} DONE in {time.time()-t0:.0f}s: "
              f"episodes={out['episodes']} top={out['top_score']} "
              f"{out['env_steps_per_sec']:.0f} steps/s =====", flush=True)


if __name__ == "__main__":
    main()
