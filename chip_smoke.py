"""End-to-end smoke run of tpu2048 on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at
full width, and checks every result against a plain reference:

  1 device       what JAX found, the compile cache, nvidia-smi
  2 indices      feature / canonical-orbit indices vs int64 numpy, n=2..7
  3 engine       packed engine rollout, GPU vs CPU, bitwise
  4 class grads  16^4 class (dsum, hits) + D4 fold vs numpy
  5 train        Trainer.run on the shipped defaults, 2 checkpoints, resume
  6 flagship     one n=6 segment at 8,192 envs
  7 eval         greedy tournament + d3/w4 expectimax, replayed on the host
  8 service      AppService requests, one of them a device search move
  9 gpu tests    the tests marked ``gpu``, in this process

Usage:
    python chip_smoke.py          # phases 1-9 on one card
    python chip_smoke.py --four   # only the four-card data-parallel
                                  # phase (needs 4 GPUs)

Each phase prints one line with its wall seconds and what it checked;
the last line of the output is one JSON object.  Any failed check
raises, so the run exits non-zero with no result line.  Without a GPU
it exits non-zero before doing any work.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpu2048.agent import td
from tpu2048.compile_cache import setup_compile_cache
from tpu2048.config import AgentConfig, MeshConfig, SearchConfig, TrainConfig
from tpu2048.engine import core as engine
from tpu2048.engine import fast as engf
from tpu2048.features import canonical, ntuple, symmetry
from tpu2048.obs.logging import Logger
from tpu2048.ops import dispatch
from tpu2048.store import checkpoint as ckpt
from tpu2048.store.artifacts import LocalStore
from tpu2048.train.loop import Trainer
from tpu2048.train.trial import trial

ROOT = Path(__file__).resolve().parent


class SmokeError(RuntimeError):
    """A smoke check failed."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def _say(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f} s: {msg}", flush=True)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, summed from
    its monitoring events (one listener per process)."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name: str, secs: float, **_kw) -> None:
        if name in self.EVENTS:
            self.seconds += secs


def _peak_bytes() -> Optional[int]:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


# -- 1. device ----------------------------------------------------------------

def phase_device(cache_dir: str) -> Dict[str, Any]:
    t0 = time.perf_counter()
    devs = jax.devices()
    smi = _nvidia_smi()
    print(f"devices: {devs}", flush=True)
    print(f"device_kind: {devs[0].device_kind}; jax {jax.__version__}; "
          f"compile cache: {cache_dir}", flush=True)
    # the card's name and power limit, exactly as nvidia-smi gives them
    print(smi, flush=True)
    _say("1 device", t0, f"{len(devs)} x {devs[0].platform} "
         f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


# -- 2. index exactness -------------------------------------------------------

def _np_feature_indices(ts, boards: np.ndarray) -> np.ndarray:
    x = boards.astype(np.int64)
    v = np.concatenate([x, np.minimum(x, 13)], axis=-1)
    return v @ ts.matrix.T.astype(np.int64) + ts.offsets.astype(np.int64)


def _np_canonical(ts, boards: np.ndarray):
    """Orbit-minimal index of every gather-class feature: the flat
    index of each feature's T_s-image feature on the s-permuted board,
    minimized over the 8 symmetries."""
    gf = canonical._gather_feat_ids(ts.n)
    fp = canonical.feature_perm_table(ts.n)
    imgs = []
    for s in range(8):
        xp = boards[:, ts.sym_perms[s]].astype(np.int64)
        v = np.concatenate([xp, np.minimum(xp, 13)], axis=-1)
        feats = fp[s, gf]
        imgs.append(v @ ts.matrix[feats].T.astype(np.int64)
                    + ts.offsets[feats].astype(np.int64))
    vals = np.stack(imgs, axis=1)  # (B, 8, K)
    canon = vals.min(axis=1)
    mult = (vals == canon[:, None, :]).sum(axis=1)
    return canon, mult


def phase_indices(num_boards: int = 4096,
                  ns: Sequence[int] = (2, 3, 4, 5, 6, 7),
                  seed: int = 0) -> Dict[str, Any]:
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 16, size=(num_boards, 16)).astype(np.int8)
    boards[: max(1, num_boards // 64)] = 15  # the largest indices
    for n in ns:
        ts = ntuple.get_tuple_set(n)
        got = np.asarray(jax.jit(
            lambda b, ts=ts: ntuple.feature_indices(ts, b)
        )(jnp.asarray(boards)))
        _check(np.array_equal(got, _np_feature_indices(ts, boards)),
               f"feature_indices differ from int64 numpy at n={n}")
        if canonical.gather_feat_count(ts):
            cidx, mult = jax.jit(
                lambda b, ts=ts: canonical.canonical_gather_indices(ts, b)
            )(jnp.asarray(boards))
            want_c, want_m = _np_canonical(ts, boards)
            _check(np.array_equal(np.asarray(cidx), want_c),
                   f"canonical indices differ at n={n}")
            _check(np.array_equal(np.asarray(mult), want_m),
                   f"canonical multiplicities differ at n={n}")
    _say("2 indices", t0, f"feature + canonical indices exact for "
         f"n={list(ns)} on {num_boards} boards (all-15 rows included)")
    return {}


# -- 3. engine ----------------------------------------------------------------

def _engine_roll(n_envs: int, steps: int):
    def roll(codes, key):
        def body(c, _):
            cd, k = c
            aft, delta, legal, _t = engf.afterstates_full(cd)
            done = ~legal.any(axis=0)
            k, ks, kr = jax.random.split(k, 3)
            nc, _, _ = engf.spawn_codes(aft[0], ks)
            nc = nc + (delta.sum(axis=0, keepdims=True).T * 0)
            nc = jnp.where(done[:, None], engf.new_codes(n_envs, kr), nc)
            return (nc, k), None

        (codes, key), _ = jax.lax.scan(body, (codes, key), None,
                                       length=steps)
        return codes

    return jax.jit(roll)


def phase_engine(n_envs: int = 8192, steps: int = 256) -> Dict[str, Any]:
    t0 = time.perf_counter()
    roll = _engine_roll(n_envs, steps)
    key = jax.random.PRNGKey(0)
    codes = engf.new_codes(n_envs, key)
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        c, k = jax.device_put((codes, key), dev)
        outs.append(np.asarray(jax.block_until_ready(roll(c, k))))
    _check(np.array_equal(outs[0], outs[1]),
           "engine rollout differs between the device and the CPU")
    _say("3 engine", t0, f"{n_envs} envs x {steps} steps: device codes == "
         "CPU codes bitwise")
    return {}


# -- 4. class grads + fold ----------------------------------------------------

def _np_class_fold(ts, c, pair: np.ndarray) -> np.ndarray:
    """The class fold y = x + T_m x; y += T_r2 y; y += T_r y with each
    T_s written as explicit numpy transposes of the per-tuple tables,
    summed in the same order as the device fold."""
    maps = symmetry.build_sym_transforms(ts.n)
    size = c.h * c.l
    k = int(round(np.log(size) / np.log(16)))

    def image(x, s):
        out = np.empty_like(x)
        for ft, fs, perm in maps[s - 1]:
            if c.feat0 <= ft < c.feat0 + c.g:
                src = x[:, fs - c.feat0].reshape((x.shape[0],) + (16,) * k)
                out[:, ft - c.feat0] = np.transpose(
                    src, (0,) + tuple(1 + p for p in perm)
                ).reshape(x.shape[0], size)
        return out

    y = pair + image(pair, 1)
    y = y + image(y, 4)
    return y + image(y, 2)


def phase_class_grads(n: int = 5, rows: int = 8192, seed: int = 0
                      ) -> Dict[str, Any]:
    t0 = time.perf_counter()
    ts = ntuple.get_tuple_set(n)
    rng = np.random.default_rng(seed)
    # uniform exponents: a few colliding rows per entry, so the f32
    # atomic sums stay within the 1e-6 bound whatever their order
    boards = rng.integers(0, 16, size=(rows, 16)).astype(np.int8)
    idx = np.asarray(ntuple.feature_indices(ts, jnp.asarray(boards)))
    dw = rng.uniform(-1.0, 1.0, rows).astype(np.float32)
    valid = rng.random(rows) < 0.9
    classes, fn = dispatch.make_class_grads(ts, "auto")

    def grads_and_fold(idx, dw, valid):
        out = []
        for c, (d, h) in zip(classes.matmul, fn(idx, dw, valid)):
            size = c.h * c.l
            pair = jnp.stack([d.reshape(c.g, size), h.reshape(c.g, size)])
            out.append((pair, symmetry.symmetrize_class_sum(
                ts, c.feat0, c.g, pair)))
        return out

    res = jax.jit(grads_and_fold)(jnp.asarray(idx), jnp.asarray(dw),
                                  jnp.asarray(valid))
    dwv = np.where(valid, dw, 0.0).astype(np.float64)
    for c, (pair, folded) in zip(classes.matmul, res):
        pair, folded = np.asarray(pair), np.asarray(folded)
        size = c.h * c.l
        loc = idx[:, c.feat0: c.feat0 + c.g] - c.start
        want_d = np.zeros(c.g * size)
        want_h = np.zeros(c.g * size)
        np.add.at(want_d, loc, np.broadcast_to(dwv[:, None], loc.shape))
        np.add.at(want_h, loc,
                  np.broadcast_to(valid[:, None], loc.shape).astype(float))
        _check(np.array_equal(pair[1].reshape(-1), want_h),
               f"class hits differ from numpy (feat0={c.feat0})")
        np.testing.assert_allclose(pair[0].reshape(-1), want_d,
                                   rtol=1e-6, atol=1e-6)
        want_f = _np_class_fold(ts, c, pair)
        _check(np.array_equal(folded, want_f),
               f"class fold differs from the numpy fold (feat0={c.feat0})")
    _say("4 class grads", t0, f"n={n}, {rows} rows, "
         f"{len(classes.matmul)} classes: hits exact, dsum within 1e-6, "
         "fold exact")
    return {}


# -- 5. train + resume --------------------------------------------------------

class _StopAfter:
    """Job stand-in: asks ``Trainer.run`` to stop once its timer has
    counted ``count`` calls of ``section``."""

    def __init__(self, trainer: Trainer, section: str, count: int):
        self.trainer, self.section, self.count = trainer, section, count

    def should_stop(self) -> bool:
        counts = self.trainer.timer.counts
        return counts.get(self.section, 0) >= self.count


def phase_train(store, name: str = "smoke", num_envs: int = 8192,
                steps_per_call: int = 64, checkpoint_every: int = 1000,
                acfg: Optional[AgentConfig] = None,
                clock: Optional[CompileClock] = None) -> Dict[str, Any]:
    t0 = time.perf_counter()
    acfg = acfg or AgentConfig()
    tcfg = TrainConfig(num_envs=num_envs, steps_per_call=steps_per_call,
                       episodes=10**9, checkpoint_every=checkpoint_every)
    log = Logger(console=False)
    c0 = clock.seconds if clock else 0.0
    tr = Trainer(name, acfg, tcfg, store=store, logger=log)
    t_run = time.perf_counter()
    out = tr.run(job=_StopAfter(tr, "checkpoint", 2))
    wall = time.perf_counter() - t_run
    compile_s = (clock.seconds - c0) if clock else float("nan")
    n_ckpt = tr.timer.counts.get("checkpoint", 0)
    _check(n_ckpt >= 2, f"only {n_ckpt} checkpoints")
    steps = tr.timer.counts["train_segment"] * steps_per_call * num_envs
    del tr

    _cfg, w_ck, meta = ckpt.load_agent(store, name)
    tr2 = Trainer(name, acfg, tcfg, store=store, logger=log, resume=True)
    _check(np.array_equal(np.asarray(tr2.state.weights), w_ck),
           "resumed weights differ from the checkpoint")
    for k in ("opt_e", "opt_a"):
        _check(np.array_equal(np.asarray(getattr(tr2.state, k)),
                              meta["extras"][k]),
               f"resumed {k} differs from the checkpoint")
    ep0 = int(np.asarray(tr2.state.metrics.episodes))
    _check(ep0 == meta["episodes"] == out["episodes"],
           f"resume starts at episode {ep0}, checkpoint has "
           f"{meta['episodes']}")
    out2 = tr2.run(job=_StopAfter(tr2, "train_segment", 1))
    _check(out2["episodes"] >= ep0, "episode count went backwards")
    del tr2
    sps = steps / wall
    sps_warm = steps / max(wall - compile_s, 1e-9) if clock else sps
    print(f"train: in-driver {sps:.1f} env-steps/s including compile, "
          f"{sps_warm:.1f} excluding it; compile {compile_s:.1f} s; "
          f"peak_bytes_in_use {_peak_bytes()}", flush=True)
    _say("5 train", t0, f"n={acfg.n} {acfg.optimizer} {acfg.sym_impl}, "
         f"{num_envs} envs: {n_ckpt} checkpoints, {out['episodes']} "
         f"episodes, resumed bitwise at {ep0} -> {out2['episodes']}")
    return {"episodes": out["episodes"], "env_steps_per_sec": sps,
            "env_steps_per_sec_excl_compile": sps_warm,
            "compile_s": compile_s}


# -- 6. n=6 flagship geometry -------------------------------------------------

def phase_flagship(n: int = 6, num_envs: int = 8192, steps: int = 64,
                   reps: int = 2) -> Dict[str, Any]:
    t0 = time.perf_counter()
    ts = ntuple.get_tuple_set(n)
    acfg = AgentConfig(n=n)
    tcfg = TrainConfig(num_envs=num_envs, steps_per_call=steps)
    state = td.init_td_state(ts, acfg, tcfg, jax.random.PRNGKey(0))
    seg = jax.jit(td.make_train_segment(ts, acfg, tcfg), donate_argnums=0)
    t_c = time.perf_counter()
    state = jax.block_until_ready(seg(state))
    first = time.perf_counter() - t_c
    t_s = time.perf_counter()
    for _ in range(reps):
        state = seg(state)
    state = jax.block_until_ready(state)
    step_ms = (time.perf_counter() - t_s) / (reps * steps) * 1e3
    _check(bool(np.isfinite(np.asarray(state.weights)).all()),
           "non-finite weights")
    _check(int(np.asarray(state.env.odometer).min()) >= 0, "bad odometer")
    peak = _peak_bytes()
    print(f"flagship n={n}: {ts.total} entries, step {step_ms:.3f} ms "
          f"({num_envs / step_ms * 1e3:.1f} env-steps/s), first segment "
          f"{first:.1f} s, peak_bytes_in_use {peak}", flush=True)
    _say("6 flagship", t0, f"n={n} canonical tc, {num_envs} envs x "
         f"{steps} steps x {reps + 1} segments, finite weights")
    return {"step_ms": step_ms, "peak_bytes": peak}


# -- 7. eval + search ---------------------------------------------------------

def _replay(start: np.ndarray, moves, spawns, length: int):
    """Host replay of a device game log; (board, score), or None at the
    first move that changes nothing (illegal)."""
    board = np.asarray(start, np.int8).copy()
    score = 0
    for t in range(length):
        nb, delta, changed = engine.np_move(board, int(moves[t]))
        if not changed:
            return None
        score += delta
        sp = int(spawns[t]) & 0xFF
        nb = nb.reshape(16).copy()
        nb[sp & 0xF] = (sp >> 4) + 1
        board = nb.reshape(4, 4)
    return board, score


def _play_and_replay(ts, weights, num, start, **kw):
    last = {}
    res = trial(ts, weights, num=num, game_init=start,
                progress_cb=lambda st: last.update(st=st), **kw)
    st = last["st"]
    moves, spawns = np.asarray(st.moves), np.asarray(st.spawns)
    finals = np.asarray(engf.boards_from_codes(st.codes))
    for i in range(num):
        got = _replay(start, moves[i], spawns[i], int(res.odometers[i]))
        _check(got is not None, f"game {i}: illegal move in the log")
        board, score = got
        _check(score == int(res.scores[i]),
               f"game {i}: replayed score {score} != {res.scores[i]}")
        _check(np.array_equal(board, finals[i]),
               f"game {i}: replayed board differs")
    return res


def _start_board(rng, filled: int) -> np.ndarray:
    cells = np.zeros(16, np.int8)
    pos = rng.choice(16, size=filled, replace=False)
    cells[pos] = rng.integers(1, 9, size=filled)
    return cells.reshape(4, 4)


def phase_eval(store, name: str = "smoke", games: int = 1024,
               search_games: int = 4, search_moves: int = 16,
               search: SearchConfig = SearchConfig(depth=3, width=4,
                                                   since_empty=6),
               seed: int = 0) -> Dict[str, Any]:
    t0 = time.perf_counter()
    acfg, w, _ = ckpt.load_agent_dense(store, name)
    ts = ntuple.get_tuple_set(acfg.n)
    w = jnp.asarray(w)
    rng = np.random.default_rng(seed)
    greedy = _play_and_replay(ts, w, games, _start_board(rng, 2),
                              seed=seed)
    _check(int(greedy.odometers.max()) < 32768, "a greedy game hit the cap")
    t_g = time.perf_counter() - t0
    # a crowded start (few empty cells) so the tree is searched at once
    deep = _play_and_replay(ts, w, search_games, _start_board(rng, 12),
                            seed=seed, search=search, step_cap=search_moves,
                            steps_per_call=search_moves // 2)
    moves = int(greedy.odometers.sum())
    print(f"eval: greedy {games} games to completion, {moves} moves in "
          f"{greedy.elapsed:.2f} s ({moves / greedy.elapsed:.1f} moves/s), "
          f"mean score {greedy.scores.mean():.1f}; expectimax "
          f"d{search.depth}/w{search.width} {search_games} games x "
          f"{int(deep.odometers.max())} moves in {deep.elapsed:.2f} s",
          flush=True)
    _say("7 eval", t0, f"{games} greedy games ({t_g:.1f} s) + "
         f"{search_games} d{search.depth}/w{search.width} games: every "
         "move legal, replayed scores and boards match")
    return {"greedy_moves_per_s": moves / greedy.elapsed,
            "mean_score": float(greedy.scores.mean())}


# -- 8. service ---------------------------------------------------------------

def phase_service(store, name: str = "smoke", depth: int = 1,
                  timeout_s: float = 600.0) -> Dict[str, Any]:
    from tpu2048 import native
    from tpu2048.apps.service import AppService

    t0 = time.perf_counter()
    svc = AppService(store)
    n_req = 0
    _check(len(svc.modes()) == 7, "modes")
    _check(name in svc.list_agents(), "agent not listed")
    _check(svc.agent_info(name)["name"] == name, "agent_info")
    play = svc.play_new()
    n_req += 4
    for d in range(4):
        r = svc.play_move(play["session"], d)
        _check(r["session"] == play["session"], "play_move session")
        n_req += 1
    sid = svc.start_watch(name, depth=depth, width=1, backend="device")
    n_req += 1
    deadline = time.time() + timeout_s
    frames = []
    while time.time() < deadline:
        frames = svc.watch_frames(sid)["frames"]
        n_req += 1
        if sum(1 for f in frames if f["next_move"] >= 0) >= 2:
            break
        time.sleep(0.5)
    svc.stop_watch(sid)
    n_req += 1
    while time.time() < deadline and not svc.watch_frames(sid)["done"]:
        time.sleep(0.2)
    n_req += 1
    played = [f for f in frames if f["next_move"] >= 0]
    _check(len(played) >= 2, "no device search move within the deadline")
    for f in played:
        _nb, _d, changed = engine.np_move(
            np.asarray(f["board"], np.int8), int(f["next_move"]))
        _check(changed, "device search chose an illegal move")
    built = native.available()
    _say("8 service", t0, f"{n_req} requests, {len(played)} device "
         f"d{depth} search moves legal; native host engine built: {built}")
    return {"native_built": built}


# -- 9. on-card tests ---------------------------------------------------------

def phase_gpu_tests() -> Dict[str, Any]:
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_gpu.py")])
    _check(rc == 0, f"gpu tests exit code {rc}")
    _say("9 gpu tests", t0, "pytest -m gpu passed in this process")
    return {}


# -- four cards ---------------------------------------------------------------

_COLLECTIVE = re.compile(
    r"= (\([^=]*?\)|\S+) (all-reduce|all-gather|reduce-scatter|"
    r"collective-permute|all-to-all)(?:-start)?\("
)
_ARRAY = re.compile(r"(\w+)\[([\d,]*)\]")
_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "s8": 1, "u8": 1,
                "f16": 2, "bf16": 2, "s64": 8, "u64": 8, "f64": 8}


def collective_bytes(hlo_text: str):
    """(op, result shapes, bytes) for every collective in compiled HLO.

    An async ``*-start`` op returns a tuple; an all-reduce's tuple holds
    only its results (summed), the others' end with the result."""
    out = []
    for shape, op in _COLLECTIVE.findall(hlo_text):
        arrays = _ARRAY.findall(shape)
        if op != "all-reduce":
            arrays = arrays[-1:]
        nbytes = sum(
            int(np.prod([int(d) for d in dims.split(",") if d]))
            * _DTYPE_BYTES.get(dt, 4)
            for dt, dims in arrays
        )
        out.append((op, ",".join(f"{dt}[{d}]" for dt, d in arrays), nbytes))
    return out


def _segment_ms(tr: Trainer, steps: int) -> float:
    """Device time of one steady segment: a second ``run`` of one
    segment (the first compiled), read from the trainer's timer."""
    tr.run(job=_StopAfter(tr, "train_segment", 1))
    tr.run(job=_StopAfter(tr, "train_segment", 1))
    t = tr.timer.totals
    return (t["train_segment"] + t["metrics_read"]) / steps * 1e3


def _codes_differ(a: Trainer, b: Trainer) -> int:
    ca, cb = np.asarray(a.state.env.codes), np.asarray(b.state.env.codes)
    return int((ca != cb).any(axis=1).sum())


def _update_terms(ts, state) -> np.ndarray:
    """Per table entry, how many colliding terms the next TD update sums
    into it: hits of the valid rows' canonical indices, and for the
    16^2..16^4 classes the D4-folded hit counts of their blocks."""
    from tpu2048.ops.onehot import build_table_classes

    valid = np.asarray(state.prev_valid)
    terms = np.zeros(ts.total, np.int64)
    np.add.at(terms, np.asarray(state.prev_cidx)[valid].ravel(), 1)
    idx = np.asarray(state.prev_idx)[valid][:, 0, :]
    for c in build_table_classes(ts).matmul:
        size = c.g * c.h * c.l
        blk = np.bincount((idx[:, c.feat0: c.feat0 + c.g] - c.start).ravel(),
                          minlength=size).astype(np.float32)
        pair = np.stack([blk.reshape(c.g, -1)] * 2)
        terms[c.start: c.start + size] += np.rint(
            _np_class_fold(ts, c, pair)[0]).astype(np.int64).reshape(-1)
    return terms


def phase_four(n: int = 6, envs_per_device: int = 8192, steps: int = 64,
               ndev: int = 4, devices=None) -> Dict[str, Any]:
    """Data-parallel training on a ``data=ndev`` mesh against the same
    global batch on device 0 alone.

    Step times and the collectives of the compiled segment come from
    two ``steps``-long segments of each. Agreement is checked over the
    first two steps, both of which choose moves with the same initial
    table (the second applies the first TD update): codes equal, and
    every weight within rtol 1e-5 plus the f32 summation bound of its
    update, n·2^-24·|update| for an entry that sums n colliding terms.
    Every env starts from a near-empty board, so a few entries sum
    ~10^5 equal terms, and the two programs add them in different
    orders (partial scatters plus an all-reduce vs one scatter). A
    second single-device run gives the card's run-to-run noise. Later
    the tables differ at rounding level, a greedy choice can flip, and
    the shared table spreads the difference to every env: the number of
    envs whose codes differ after the timed segments is reported, not
    checked."""
    from tpu2048.parallel import mesh as pmesh

    t0 = time.perf_counter()
    devices = list(devices or jax.devices())
    _check(len(devices) >= ndev, f"needs {ndev} devices, "
           f"have {len(devices)}")
    acfg = AgentConfig(n=n)
    log = Logger(console=False)
    m = pmesh.make_mesh(MeshConfig(data=ndev), devices=devices[:ndev])

    def trainer(k: int, mesh=None) -> Trainer:
        tcfg = TrainConfig(num_envs=ndev * envs_per_device,
                           steps_per_call=k)
        return Trainer("four", acfg, tcfg, logger=log, mesh=mesh)

    tr_m, tr_1 = trainer(steps, m), trainer(steps)
    hlo = tr_m._segment.lower(tr_m.state).compile().as_text()
    colls = collective_bytes(hlo)
    ms_mesh = _segment_ms(tr_m, steps)
    ms_one = _segment_ms(tr_1, steps)
    drift = _codes_differ(tr_m, tr_1)
    del tr_m, tr_1
    total = sum(b for _, _, b in colls)
    print(f"four: {ndev} devices x {envs_per_device} envs, n={n}: "
          f"mesh step {ms_mesh:.3f} ms, one device step {ms_one:.3f} ms "
          f"(same {ndev * envs_per_device}-env batch); after "
          f"{2 * steps} steps codes differ in {drift} envs", flush=True)
    print(f"four: {len(colls)} collectives in the segment HLO, "
          f"{total} bytes if each runs once:", flush=True)
    for op, shape, b in colls:
        print(f"  {op} {shape} {b} bytes", flush=True)

    trs = (trainer(1, m), trainer(1), trainer(1))  # mesh, one, one again
    w_0 = np.asarray(trs[1].state.weights)
    for tr in trs:
        tr.run(job=_StopAfter(tr, "train_segment", 1))
    terms = _update_terms(ntuple.get_tuple_set(n), trs[1].state)
    for tr in trs:
        tr.run(job=_StopAfter(tr, "train_segment", 1))
    differ = _codes_differ(trs[0], trs[1])
    w_m, w_1, w_1b = (np.asarray(t.state.weights) for t in trs)
    del trs
    upd = np.abs(w_1 - w_0)
    tol = 1e-5 * np.abs(w_1) + terms * 2.0 ** -24 * upd
    for name, w in (("mesh vs one", w_m), ("one vs one", w_1b)):
        d = np.abs(w - w_1)
        print(f"four: weights {name} after 2 steps: max abs diff "
              f"{d.max():.3g}, {int((d > 1e-5 * np.abs(w_1)).sum())} of "
              f"{w_1.size} entries beyond rtol 1e-5, "
              f"{int((d > tol).sum())} beyond rtol 1e-5 + the f32 "
              f"summation bound (max {int(terms.max())} terms per entry)",
              flush=True)
    _check(differ == 0, f"after 2 steps codes differ in {differ} of "
           f"{ndev * envs_per_device} envs")
    bad = int((np.abs(w_m - w_1) > tol).sum())
    _check(bad == 0, f"{bad} weights beyond rtol 1e-5 + the f32 "
           "summation bound")
    _say("four", t0, f"data={ndev} mesh vs one device: codes equal and "
         "weights within rtol 1e-5 + the f32 summation bound after 2 "
         "steps; step times and collectives above")
    return {"mesh_step_ms": ms_mesh, "one_step_ms": ms_one,
            "collectives": colls, "drift_envs": drift}


# -- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card data-parallel phase")
    args = p.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform} "
              f"({devs})", file=sys.stderr)
        return 2
    cache_dir = setup_compile_cache()
    clock = CompileClock()
    t0 = time.perf_counter()
    dev = phase_device(cache_dir)
    if args.four:
        import __graft_entry__

        phase_four()
        t1 = time.perf_counter()
        __graft_entry__.dryrun_multichip(4)
        _say("four dryrun", t1, "dryrun_multichip(4) on the cards")
    else:
        phase_indices()
        phase_engine()
        phase_class_grads()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            store = LocalStore(tmp)
            phase_train(store, clock=clock)
            phase_flagship()
            phase_eval(store)
            phase_service(store)
        phase_gpu_tests()
    print(f"total {time.perf_counter() - t0:.1f} s, compile "
          f"{clock.seconds:.1f} s; {dev['nvidia_smi']}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
