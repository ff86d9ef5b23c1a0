"""Multi-process jax.distributed bring-up test (SURVEY §4).

The reference has no communication backend at all (SURVEY §2.2); the
framework's multi-host story is jax.distributed + GSPMD collectives.
Validated here without a cluster: two real OS processes, one CPU
device each, coordinated over localhost — covering
distributed.initialize, cross-process psum, process_env_slice, and a
GSPMD-sharded train segment spanning both processes.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    return env


def _run_workers(extra_args, ok_token: str, nprocs: int = 2):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(nprocs), str(i),
             *extra_args],
            cwd=REPO, env=_clean_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            # generous: two Trainer instantiations compile GSPMD
            # segments on CPU, and CI machines run the suite in
            # parallel with other load
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"{ok_token} {i}" in out, f"worker {i} output:\n{out}"


def test_two_process_distributed_train_segment():
    _run_workers([], "WORKER_OK")


def test_two_process_trainer_run_checkpoint_resume(tmp_path):
    """The FULL Trainer driver across 2 OS processes: mesh-native state
    init (no host device_put), GSPMD segments, process-0-only
    checkpoint writes, and a resume that reloads the checkpoint in both
    processes and continues training (round-2 verdict item 2)."""
    store = tmp_path / "dist_store"
    store.mkdir()
    _run_workers(["trainer", str(store)], "TRAINER_OK")
    # process 0 wrote the checkpoint artifacts exactly once
    assert (store / "a" / "dist_agent.json").exists()
    assert (store / "weights" / "dist_agent.npz").exists()
