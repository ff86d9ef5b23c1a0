"""Fault injection: SIGKILL a training process mid-run, prove recovery.

SURVEY §5 (failure detection / recovery): the reference survives
crashes by restarting from its last 1000-episode checkpoint
(``r_learning.py:264-267``) and reaps orphaned sessions via lease
expiry + vacuum (``application.py:784-805``).  Here a REAL OS process
is killed with SIGKILL after its first checkpoint; the test asserts

  * the orphaned agent lease expires and ``vacuum()`` reaps it;
  * a resumed process picks up exactly the checkpointed episode count
    and weights, and trains on to completion.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_fault_worker.py")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _agent_doc(store_dir):
    path = os.path.join(store_dir, "a", "fault_agent.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None  # mid-write


def test_sigkill_mid_run_then_resume(tmp_path):
    store_dir = str(tmp_path / "store")
    os.makedirs(store_dir)
    p = subprocess.Popen(
        [sys.executable, WORKER, store_dir, "fresh"],
        cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    # wait for the first checkpoint (>= 40 episodes recorded)
    deadline = time.time() + 180
    ckpt_eps = 0
    try:
        while time.time() < deadline:
            doc = _agent_doc(store_dir)
            if doc and doc.get("meta", {}).get("episodes", 0) >= 40:
                ckpt_eps = doc["meta"]["episodes"]
                break
            assert p.poll() is None, p.communicate()[0]
            time.sleep(0.5)
        assert ckpt_eps >= 40, "no checkpoint appeared within 180 s"
        # hard crash: SIGKILL the exact PID (no orderly shutdown)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        if p.poll() is None:
            p.kill()
    p.wait(timeout=30)

    # the crashed session's lease must expire and vacuum must reap it
    from tpu2048.obs.jobs import JobRegistry
    from tpu2048.store.artifacts import LocalStore

    reg = JobRegistry(LocalStore(store_dir), lease_sec=2.0)
    assert reg.holder("agent", "fault_agent") in ("sess_fresh", None)
    time.sleep(2.5)  # lease horizon
    assert reg.holder("agent", "fault_agent") is None
    removed = reg.vacuum()
    doc = reg._read()
    assert "fault_agent" not in doc.get("agent", {}), (removed, doc)

    # resume from the checkpoint: continuity of episodes and weights
    with np.load(os.path.join(store_dir, "weights", "fault_agent.npz")) as z:
        w_ckpt = z["weights"].copy()
    out = subprocess.run(
        [sys.executable, WORKER, store_dir, "resume"],
        cwd=REPO, env=_env(), timeout=240,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    assert out.returncode == 0, out.stdout
    start_line = [ln for ln in out.stdout.splitlines()
                  if ln.startswith("START_EPISODES")][0]
    start_eps = int(start_line.split()[1])
    # resumed exactly from the last completed checkpoint (the crash
    # loses at most checkpoint_every episodes, like the reference)
    doc = _agent_doc(store_dir)
    assert start_eps >= ckpt_eps, (start_eps, ckpt_eps)
    done_line = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("DONE")][0]
    final_eps = int(done_line.split()[1])
    assert final_eps >= start_eps + 120
    assert doc["meta"]["episodes"] == final_eps
    # weights actually advanced from the crash checkpoint
    with np.load(os.path.join(store_dir, "weights", "fault_agent.npz")) as z:
        w_final = z["weights"]
    assert not np.array_equal(w_ckpt, w_final)
