"""chip_smoke.py's phases at tiny sizes on the CPU: the same code the
GPU run drives, checked against the same references."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from tpu2048.config import AgentConfig, SearchConfig
from tpu2048.store.artifacts import LocalStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """phase_train on a small geometry; its store feeds eval/service."""
    store = LocalStore(str(tmp_path_factory.mktemp("smoke_store")))
    out = cs.phase_train(store, num_envs=64, steps_per_call=16,
                         checkpoint_every=16, acfg=AgentConfig(n=3))
    return store, out


def test_main_refuses_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_phase_device():
    out = cs.phase_device("/nowhere")
    assert out["platform"] == jax.devices()[0].platform
    assert out["count"] == len(jax.devices())


def test_phase_indices():
    cs.phase_indices(num_boards=128)


def test_phase_indices_catches_a_wrong_index(monkeypatch):
    real = cs._np_feature_indices
    monkeypatch.setattr(cs, "_np_feature_indices",
                        lambda ts, b: real(ts, b) + 1)
    with pytest.raises(cs.SmokeError, match="feature_indices"):
        cs.phase_indices(num_boards=64, ns=(2,))


def test_phase_engine():
    cs.phase_engine(n_envs=32, steps=8)


@pytest.mark.parametrize("n", [4, 5])
def test_phase_class_grads(n):
    cs.phase_class_grads(n=n, rows=256)


def test_phase_train_checkpoints_and_resumes(trained):
    _store, out = trained
    assert out["episodes"] > 0
    assert out["env_steps_per_sec"] > 0


def test_phase_flagship():
    out = cs.phase_flagship(n=3, num_envs=32, steps=4, reps=1)
    assert out["step_ms"] > 0


def test_phase_eval(trained):
    store, _ = trained
    out = cs.phase_eval(store, games=16, search_games=2, search_moves=4,
                        search=SearchConfig(depth=1, width=2,
                                            since_empty=6))
    assert out["mean_score"] > 0


def test_phase_service(trained):
    store, _ = trained
    out = cs.phase_service(store, depth=1, timeout_s=240)
    assert isinstance(out["native_built"], bool)


def test_phase_four_on_virtual_devices():
    out = cs.phase_four(n=3, envs_per_device=8, steps=4, ndev=4,
                        devices=jax.devices()[:4])
    ops = {op for op, _shape, _b in out["collectives"]}
    assert "all-reduce" in ops
    assert out["mesh_step_ms"] > 0 and out["one_step_ms"] > 0


def test_collective_bytes_parses_hlo():
    hlo = (
        "  %all-reduce.1 = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
        "replica_groups={{0,1,2,3}}\n"
        "  %ag = (s32[1,8]{1,0}, s32[4,8]{1,0}) all-gather-start("
        "s32[1,8]{1,0} %y)\n"
        "  %ar2 = (f32[2]{0}, s8[16]{0}) all-reduce-start(f32[2]{0} %p, "
        "s8[16]{0} %q), to_apply=%sum\n"
        "  %ard = f32[2]{0} all-reduce-done(%ar2)\n"
        "  %add = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)\n"
    )
    assert cs.collective_bytes(hlo) == [
        ("all-reduce", "f32[1024]", 4096),
        ("all-gather", "s32[4,8]", 128),
        ("all-reduce", "f32[2],s8[16]", 24),
    ]
