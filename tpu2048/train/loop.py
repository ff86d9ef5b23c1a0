"""Host training driver.

Capability parity with the reference ``train_run``
(``/root/reference/game2048/r_learning.py:269-346``): the same metric
cadence measured in completed episodes (ma-100 logging, per-1000
summaries with tile-reach percentages and best boards, learning-rate
display), per-1000-episode checkpointing, best-game saving, cooperative
cancellation, and resume-and-retune — but the hot loop is a single
jitted K-step segment over N lockstep envs; the host only reads the
device-resident metrics ring between segments.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import jax
import numpy as np

from ..agent import td
from ..config import AgentConfig, TrainConfig
from ..features import ntuple
from ..obs.jobs import Job
from ..obs.logging import Logger
from ..obs.metrics import MetricsWriter
from ..store import checkpoint as ckpt
from ..store.artifacts import ArtifactStore

TILE_NAMES = [1 << e for e in range(10, 17)]  # 1024 .. 65536


def _board_str(board: np.ndarray, score: int) -> str:
    lines = []
    for row in board:
        lines.append(
            "".join(
                f"{(1 << int(v)) if v else 0}".ljust(7) for v in row
            )
        )
    lines.append(f"score = {score}")
    return "\n".join(lines)


class Trainer:
    """Owns one agent's training session."""

    def __init__(
        self,
        name: str,
        acfg: AgentConfig,
        tcfg: TrainConfig,
        store: Optional[ArtifactStore] = None,
        logger: Optional[Logger] = None,
        mesh=None,
        resume: bool = False,
    ):
        self.name = name
        self.acfg = acfg
        self.tcfg = tcfg
        self.store = store
        self.log = logger or Logger(console=True)
        self.ts = ntuple.get_tuple_set(acfg.n)
        self.mesh = mesh
        # only one process writes artifacts/metrics in a multi-host run
        self._is_writer = jax.process_index() == 0
        self.metrics_writer = (
            MetricsWriter(store, name)
            if store is not None and self._is_writer else None
        )
        self.train_history: list = []

        weights = None
        meta: Dict[str, Any] = {}
        self._provenance: Dict[str, Any] = {}
        if resume:
            if store is None:
                raise ValueError("resume requires a store")
            loaded_cfg, w, meta = ckpt.load_agent(store, name)
            if loaded_cfg.n != acfg.n:
                raise ValueError(
                    f"agent '{name}' has n={loaded_cfg.n}, requested n={acfg.n}"
                )
            weights = np.asarray(w)
            # resume-and-retune may flip the symmetry impl: convert
            # between canonical-orbit and dense table representations
            # (weights AND TC accumulators — features/canonical.py)
            from ..features import canonical as canon

            if canon.is_canonical(loaded_cfg) != canon.is_canonical(acfg):
                import jax.numpy as jnp

                conv = (canon.to_dense_table
                        if canon.is_canonical(loaded_cfg)
                        else canon.from_dense_table)
                weights = np.asarray(conv(self.ts, jnp.asarray(weights)))
                if "extras" in meta:
                    meta = {
                        **meta,
                        "extras": {
                            k: np.asarray(conv(self.ts, jnp.asarray(v)))
                            if np.asarray(v).shape == weights.shape else v
                            for k, v in meta["extras"].items()
                        },
                    }
            self.train_history = list(meta.get("train_history", []))
            self._provenance = {
                k: meta[k] for k in ("forked_from", "source_episodes")
                if k in meta
            }
        init_key = jax.random.PRNGKey(tcfg.seed)
        if mesh is not None:
            # mesh-native init: the state is computed directly onto the
            # mesh under GSPMD (each process materializes only its
            # addressable shards) — device_put of a host-built state
            # cannot work multi-process (SURVEY §7 step 4).
            from ..parallel import mesh as pmesh

            self._pmesh = pmesh
            self.state = pmesh.init_sharded_td_state(
                self.ts, acfg, tcfg, mesh, init_key, weights=weights
            )
            self._segment = pmesh.make_sharded_train_segment(
                self.ts, acfg, tcfg, mesh
            )

            def _dev(x):
                return pmesh.replicate_to_mesh(x, mesh)
        else:
            self._pmesh = None
            self.state = td.init_td_state(
                self.ts, acfg, tcfg, init_key, weights=weights
            )
            self._segment = jax.jit(
                td.make_train_segment(self.ts, acfg, tcfg), donate_argnums=0
            )

            def _dev(x):
                return x
        # only one process writes artifacts in a multi-host run; state
        # reads for checkpoints are replicated, so any process could,
        # but exactly one must
        self._is_writer = jax.process_index() == 0
        if resume and meta:
            import jax.numpy as jnp

            extras = meta.get("extras", {})
            if acfg.optimizer == "tc" and "opt_e" in extras:
                self.state = self.state._replace(
                    opt_e=_dev(jnp.asarray(extras["opt_e"], jnp.float32)),
                    opt_a=_dev(jnp.asarray(extras["opt_a"], jnp.float32)),
                )
            if "rng_key" in extras:
                # stream-exact resume: continue the original RNG stream
                # rather than replaying PRNGKey(seed) from scratch (env
                # boards restart fresh; spawn randomness continues)
                self.state = self.state._replace(
                    key=_dev(jnp.asarray(extras["rng_key"], jnp.uint32))
                )
            self.state = self.state._replace(
                alpha=_dev(jnp.float32(meta.get("alpha", acfg.alpha))),
                next_decay=_dev(jnp.int32(
                    meta.get("next_decay", acfg.decay_step)
                )),
                top_tile=_dev(jnp.int32(meta.get("top_tile", 10))),
                metrics=self.state.metrics._replace(
                    episodes=_dev(jnp.int32(meta.get("episodes", 0))),
                    best_score=_dev(jnp.int32(meta.get("top_score", 0))),
                ),
            )
        self._saved_best = int(np.asarray(self.state.metrics.best_score))

    # -- cadenced reporting -------------------------------------------------

    def _ring_slice(self, metrics, count: int) -> tuple:
        ring = self.tcfg.ring_size
        pos = int(np.asarray(metrics.ring_pos))
        take = min(count, pos, ring)
        idx = np.arange(pos - take, pos) % ring
        scores = np.asarray(metrics.score_ring)[idx]
        tiles = np.asarray(metrics.tile_ring)[idx]
        return scores, tiles

    def _drain_history(self, next_100: int) -> int:
        """Append one ma-100 point PER 100-episode window crossed since
        the last drain (the reference appends per window,
        ``r_learning.py:315-318``), reading each window's own ring span
        by absolute episode position.  A fast device segment can cross
        dozens of boundaries at once; re-reading the final ring state
        for each would duplicate one value across all of them.  Windows
        the ring has already overwritten (segment completed more than
        ``ring_size`` episodes) get the mean over all surviving new
        episodes — the best available estimate, logged as coalesced.
        Returns the updated next_100 boundary.
        """
        every = self.tcfg.log_every
        ring = self.tcfg.ring_size
        met = self.state.metrics
        pos = int(np.asarray(met.ring_pos))
        if pos < next_100:
            return next_100
        scores_np = np.asarray(met.score_ring)
        alpha = float(np.asarray(self.state.alpha))
        coalesced = 0
        while pos >= next_100:
            start, end = next_100 - every, next_100
            if pos - start <= ring:
                window = scores_np[np.arange(start, end) % ring]
            else:  # overwritten: coalesce onto surviving episodes
                window = scores_np[np.arange(pos - ring, pos) % ring]
                coalesced += 1
            ma = int(window.mean())
            self.train_history.append(ma)
            self.log.add(
                f"episode {next_100}: ma_100 = {ma} "
                f"(window top {int(window.max())})"
            )
            if self.metrics_writer is not None:
                self.metrics_writer.write(
                    {"kind": "ma100", "episodes": next_100, "ma100": ma,
                     "alpha": alpha}
                )
            next_100 += every
        if coalesced:
            self.log.add(
                f"({coalesced} ma_{every} windows outran the "
                f"{ring}-episode ring and were coalesced)"
            )
        return next_100

    def _report_1000(self, episodes: int, t_block: float) -> None:
        scores, tiles = self._ring_slice(self.state.metrics, 1000)
        if len(scores) == 0:
            return
        self.log.add("\n------")
        self.log.add(f"{round(t_block / 60, 2)} min")
        self.log.add(f"episode = {episodes}")
        self.log.add(
            f"average over last {len(scores)} episodes = "
            f"{round(float(scores.mean()), 3)}"
        )
        for j, tile in enumerate(TILE_NAMES):
            r = float((tiles >= j + 10).mean() * 100)
            if r:
                self.log.add(f"{tile} reached in {round(r, 1)} %")
        rec = self.state.recorder
        best_score = int(np.asarray(rec.best_score))
        if best_score > 0:
            final = self._best_game_record()
            self.log.add("best recorded game of this agent:")
            self.log.add(_board_str(final["final_board"], final["score"]))
        self.log.add(
            f"episode = {episodes}, current learning rate = "
            f"{round(float(np.asarray(self.state.alpha)), 4)}"
        )
        self.log.add("------\n")
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                {
                    "kind": "summary1000",
                    "episodes": episodes,
                    "avg1000": float(scores.mean()),
                    "reach": {
                        str(t): float((tiles >= j + 10).mean())
                        for j, t in enumerate(TILE_NAMES)
                    },
                    "alpha": float(np.asarray(self.state.alpha)),
                    "top_score": int(np.asarray(self.state.metrics.best_score)),
                }
            )

    def _best_game_record(self) -> Dict[str, Any]:
        """Reconstruct the best recorded game as a replayable record
        (host-side replay of the device move/spawn logs)."""
        from ..engine import core as engine

        rec = self.state.recorder
        length = int(np.asarray(rec.best_len))
        start = np.asarray(rec.best_start, np.int8)
        moves = np.asarray(rec.best_moves)[:length]
        spawns = np.asarray(rec.best_spawns)[:length]
        board = start.copy()
        score = 0
        tiles = []
        for t in range(length):
            nb, delta, _ = engine.np_move(board, int(moves[t]))
            score += delta
            sp = int(spawns[t]) & 0xFF
            pos, val = sp & 0xF, (sp >> 4) + 1
            nb = nb.reshape(16).copy()
            nb[pos] = val
            board = nb.reshape(4, 4)
            tiles.append((val, pos // 4, pos % 4))
        return {
            "starting_position": start,
            "moves": moves.astype(np.int8),
            "tiles": np.asarray(tiles, np.int8).reshape(-1, 3),
            "score": score,
            "odometer": length,
            "final_board": board.astype(np.int8),
        }

    # -- checkpointing ------------------------------------------------------

    def _host(self, x) -> np.ndarray:
        """Full host copy of a (possibly mesh-distributed) array."""
        if self._pmesh is not None:
            return self._pmesh.host_full(x)
        return np.asarray(x)

    def save(self) -> None:
        if self.store is None:
            return
        # host reads FIRST, on every process: a model-axis-sharded
        # table crosses processes and host_full gathers it through a
        # collective jit — all peers must participate even though only
        # the writer process emits the artifact files.
        weights_np = self._host(self.state.weights)
        extras = {"rng_key": np.asarray(self.state.key, np.uint32)}
        if self.acfg.optimizer == "tc":
            extras["opt_e"] = self._host(self.state.opt_e)
            extras["opt_a"] = self._host(self.state.opt_a)
        if not self._is_writer:
            return
        meta = {
            **self._provenance,
            "episodes": int(np.asarray(self.state.metrics.episodes)),
            "top_score": int(np.asarray(self.state.metrics.best_score)),
            "top_tile": int(np.asarray(self.state.top_tile)),
            "alpha": float(np.asarray(self.state.alpha)),
            "next_decay": int(np.asarray(self.state.next_decay)),
            "train_history": [int(x) for x in self.train_history],
            "num_envs": self.tcfg.num_envs,
        }
        ckpt.save_agent(
            self.store, self.name, self.acfg,
            weights_np, meta, extras=extras,
        )

    def _maybe_save_best_game(self) -> None:
        if self.store is None or not self._is_writer:
            return
        best = int(np.asarray(self.state.recorder.best_score))
        if best > self._saved_best:
            self._saved_best = best
            record = self._best_game_record()
            ckpt.save_game(self.store, f"best_of_{self.name}", record)
            self.log.add(
                f"\nnew best recorded game ({best})! saved to "
                f"g/best_of_{self.name}.npz\n"
            )

    # -- main loop ----------------------------------------------------------

    def run(self, job: Optional[Job] = None, registry=None,
            trace_dir: Optional[str] = None) -> Dict[str, Any]:
        """Main loop.  ``trace_dir`` captures a ``jax.profiler`` device
        trace of the whole session (TensorBoard-compatible, SURVEY §5
        tracing row); host-side phases are timed with ``Timer`` and
        reported in the final log lines either way."""
        from ..obs.profiler import Timer, device_trace

        tcfg = self.tcfg
        timer = self.timer = Timer()
        start_eps = int(np.asarray(self.state.metrics.episodes))
        target = start_eps + tcfg.episodes
        self.log.add(
            f"Agent {self.name} training session started, "
            f"episodes = {start_eps}, target = {target}, "
            f"n = {self.acfg.n}, envs = {tcfg.num_envs}"
        )
        next_100 = (start_eps // tcfg.log_every + 1) * tcfg.log_every
        next_1000 = (
            start_eps // tcfg.checkpoint_every + 1
        ) * tcfg.checkpoint_every
        t_global = t_block = time.time()
        steps_done = 0
        with device_trace(trace_dir):
            while True:
                if job is not None and job.should_stop():
                    self.log.add("training cancelled")
                    break
                with timer.section("train_segment"):
                    self.state = self._segment(self.state)
                steps_done += tcfg.steps_per_call * tcfg.num_envs
                with timer.section("metrics_read"):
                    episodes = int(np.asarray(self.state.metrics.episodes))
                    if registry is not None and job is not None:
                        registry.heartbeat(job.parent)
                    next_100 = self._drain_history(next_100)
                if episodes >= next_1000:
                    with timer.section("checkpoint"):
                        self._report_1000(episodes, time.time() - t_block)
                        t_block = time.time()
                        self._maybe_save_best_game()
                        self.save()
                    next_1000 = (
                        episodes // tcfg.checkpoint_every + 1
                    ) * tcfg.checkpoint_every
                if episodes >= target:
                    break
        total = time.time() - t_global
        sps = steps_done / max(total, 1e-9)
        self.log.add(
            f"Total time = {int(total) // 60} min {int(total) % 60} sec "
            f"({sps / 1e3:.0f}K env-steps/s)"
        )
        self.log.add("timing:\n" + timer.report())
        if trace_dir:
            self.log.add(f"device trace written to {trace_dir}")
        self._maybe_save_best_game()
        self.save()
        if self.mesh is not None and jax.process_count() > 1:
            # multi-host: no process may leave run() (and possibly
            # re-read the checkpoint for a resume) before the writer
            # finished the final save
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("tpu2048:run_end")
        if self.store is not None:
            self.log.add(f"{self.name} saved at episode "
                         f"{int(np.asarray(self.state.metrics.episodes))}")
        return {
            "episodes": int(np.asarray(self.state.metrics.episodes)),
            "top_score": int(np.asarray(self.state.metrics.best_score)),
            "env_steps_per_sec": sps,
            "train_history": list(self.train_history),
        }
