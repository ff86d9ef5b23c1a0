"""Virtual-mesh scaling bench: GSPMD partitioning/collective overhead.

Multi-chip hardware is not reachable from this environment, so the
measurable scaling story is: run the SAME global env batch on a
1/2/4/8-device virtual CPU mesh and compare env-steps/s.  All virtual
devices share the host's cores, so wall-clock cannot improve with
device count — what the numbers expose is the cost GSPMD adds for
partitioning the program (the per-step psum of the TD table update and
the resharded metrics).  On real chips each mesh slot has its own
compute, so throughput scales with devices as long as this overhead
stays small relative to per-device work.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python scripts/bench_scaling.py
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tpu2048.agent import td  # noqa: E402
from tpu2048.config import AgentConfig, MeshConfig, TrainConfig  # noqa: E402
from tpu2048.features import ntuple  # noqa: E402
from tpu2048.parallel import mesh as pmesh  # noqa: E402


def bench(data_axis: int, num_envs: int = 1024, k: int = 32,
          reps: int = 3) -> float:
    ts = ntuple.get_tuple_set(4)
    acfg = AgentConfig(n=4, optimizer="sgd", alpha=0.25,
                       sym_mode="periodic", table_ops="gather")
    tcfg = TrainConfig(num_envs=num_envs, steps_per_call=k,
                       ring_size=2048, record_envs=8,
                       max_record_steps=2048, seed=0)
    state = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(0))
    if data_axis == 1:
        seg = jax.jit(td.make_train_segment(ts, acfg, tcfg),
                      donate_argnums=0)
    else:
        m = pmesh.make_mesh(
            MeshConfig(data=data_axis, model=1),
            devices=jax.devices()[:data_axis],
        )
        state = pmesh.shard_td_state(state, m)
        seg = pmesh.make_sharded_train_segment(ts, acfg, tcfg, m)
    state = seg(state)
    np.asarray(state.alpha)  # compile + sync
    t0 = time.time()
    for _ in range(reps):
        state = seg(state)
    np.asarray(state.alpha)
    return reps * k * num_envs / (time.time() - t0)


def main():
    ts = ntuple.get_tuple_set(4)
    table_mb = ts.total * 4 / 2**20
    rows = []
    base = None
    for d in (1, 2, 4, 8):
        sps = bench(d)
        base = base or sps
        rows.append({"devices": d, "env_steps_per_sec": round(sps, 1),
                     "overhead_vs_1dev": round(base / sps, 3)})
        print(f"data={d}: {sps / 1e3:.1f}K env-steps/s "
              f"(x{base / sps:.2f} cost vs 1-device)", flush=True)
    print(json.dumps({
        "metric": "virtual_mesh_partition_overhead",
        "rows": rows,
        "allreduce_mb_per_step": round(table_mb, 2),
        "note": (
            "The dominant partition cost is the per-step all-reduce of "
            "the replicated TD table delta "
            f"({table_mb:.1f} MB/step for n=4), which on shared-core "
            "virtual CPU devices serializes into host memcpys and "
            "swamps the useful work.  On real cards the same reduce "
            "runs over the interconnect (NVLink) beside compute; "
            "chip_smoke.py --four measures it on four GPUs."
        ),
    }))


if __name__ == "__main__":
    main()
