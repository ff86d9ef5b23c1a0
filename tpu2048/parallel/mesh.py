"""Device mesh, shardings, and collectives.

The reference has NO distributed compute at all (SURVEY §2.2): one
sequential game on one CPU core, with S3 polling as its only
inter-process channel.  This module is the from-scratch multi-device
design:

  * a ``jax.sharding.Mesh`` with a ``data`` axis (environments sharded
    across chips/hosts) and an optional ``model`` axis (weight-table
    sharding, the tensor-parallel analogue for very large tuple sets);
  * ``NamedSharding`` pytrees for the TD train state: env batch and
    per-env bootstrap state sharded along ``data``, the weight table and
    scalar schedule state replicated;
  * GSPMD-compiled train steps: ``jax.jit`` over sharded inputs lets
    XLA insert the collectives — the batched scatter-add of TD updates
    into the replicated table becomes a local scatter + cross-replica
    all-reduce (NCCL; the cards of one host are joined all to all, so
    the mesh follows the algorithm, not a topology), and episode
    metrics reduce the same way.

Multi-host bring-up is ``jax.distributed.initialize`` + the same mesh
over ``jax.devices()``; tests exercise the logic on a virtual 8-device
CPU platform (SURVEY §4).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..agent.td import Metrics, Recorder, TDState
from ..config import MeshConfig
from ..engine.core import EnvState


def make_mesh(cfg: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """Build a (data, model) mesh.  Defaults to all visible devices on
    the data axis."""
    if devices is None:
        devices = jax.devices()
    if cfg is None:
        cfg = MeshConfig(data=len(devices), model=1)
    arr = mesh_utils.create_device_mesh(
        (cfg.data, cfg.model), devices=devices[: cfg.data * cfg.model]
    )
    return Mesh(arr, axis_names=("data", "model"))


def td_state_shardings(mesh: Mesh, engine_mode: str = "cells",
                       record_all: bool = False) -> TDState:
    """NamedSharding pytree for a TDState: per-env leaves on ``data``,
    scalars + metrics replicated.  With ``record_all`` (the default
    TrainConfig records every env for true best-game capture) the
    per-env recorder logs are sharded along ``data`` too — a replicated
    (N, S) move log would multiply its 134 MB by the device count;
    the best-game snapshot fields stay replicated.

    The weight table is replicated when the mesh's ``model`` axis is
    trivial (the common case — 4–70 MB fits HBM), and sharded along
    ``model`` otherwise: the tensor-parallel analogue for very large
    tuple sets (SURVEY §2.2 TP row — e.g. n=6's 12x14^6 tables).
    GSPMD then inserts the all-gather-on-read for evaluation gathers
    and keeps each shard's scatter-add local.
    """

    def s(*spec):
        return NamedSharding(mesh, P(*spec))

    rep = s()
    data = s("data")
    table = rep if mesh.shape.get("model", 1) == 1 else s("model")
    if engine_mode == "codes":
        from ..engine.fast import EnvStateC

        env_sh = EnvStateC(codes=data, score=data, odometer=data)
    else:
        env_sh = EnvState(boards=data, score=data, odometer=data)
    return TDState(
        weights=table,
        opt_e=table,
        opt_a=table,
        alpha=rep,
        next_decay=rep,
        top_tile=rep,
        env=env_sh,
        prev_idx=data,
        prev_value=data,
        prev_valid=data,
        prev_cidx=data,
        prev_cmult=data,
        key=rep,
        metrics=Metrics(
            episodes=rep,
            score_ring=rep,
            tile_ring=rep,
            ring_pos=rep,
            best_score=rep,
        ),
        recorder=Recorder(
            moves=data if record_all else rep,
            spawns=data if record_all else rep,
            starts=data if record_all else rep,
            overflow=data if record_all else rep,
            best_moves=rep,
            best_spawns=rep,
            best_start=rep,
            best_len=rep,
            best_score=rep,
        ),
    )


def shard_td_state(state: TDState, mesh: Mesh) -> TDState:
    """Place a host-built TDState onto the mesh (single-process only:
    ``jax.device_put`` of host arrays onto a multi-process mesh would
    require every process to own the full value — multi-process callers
    use ``init_sharded_td_state``, which computes each process's shards
    in place under GSPMD)."""
    from ..engine.fast import EnvStateC

    mode = "codes" if isinstance(state.env, EnvStateC) else "cells"
    record_all = (
        state.recorder.moves.shape[0] == state.prev_value.shape[0]
    )
    sh = td_state_shardings(mesh, mode, record_all=record_all)
    return jax.device_put(state, sh)


def init_sharded_td_state(
    ts, acfg, tcfg, mesh: Mesh, key, weights=None
) -> TDState:
    """Build a TDState directly ONTO the mesh under GSPMD.

    Unlike ``shard_td_state`` (host-built state + ``device_put``), the
    init computation itself is jitted with ``out_shardings``, so in a
    multi-process run each process materializes only its addressable
    shards — the path ``Trainer`` uses for real multi-host training
    (SURVEY §7 step 4).  ``weights`` (resume) enters as a replicated
    jit argument; every process must pass the same host array, which
    holds because all load the same checkpoint.
    """
    import jax.numpy as jnp

    from ..agent import td

    sh = td_state_shardings(
        mesh, acfg.engine_mode,
        record_all=td.record_env_count(tcfg) == tcfg.num_envs,
    )
    rep = NamedSharding(mesh, P())
    if weights is None:
        f = jax.jit(
            lambda k: td.init_td_state(ts, acfg, tcfg, k),
            out_shardings=sh,
        )
        return f(jax.device_put(key, rep))
    w = jax.device_put(jnp.asarray(weights, jnp.float32), rep)
    f = jax.jit(
        lambda k, w: td.init_td_state(ts, acfg, tcfg, k, weights=w),
        out_shardings=sh,
    )
    return f(jax.device_put(key, rep), w)


def replicate_to_mesh(x, mesh: Mesh):
    """Place a host array replicated onto the mesh (all processes must
    hold the same value — true for checkpoint-loaded state)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def host_full(x) -> np.ndarray:
    """Read a (possibly distributed) array fully onto this host.

    Single-process (or fully addressable) arrays read directly.  A
    replicated multi-process array is NOT fully addressable, but every
    process already holds a complete copy in its local shards — read
    it without any collective, so a lone writer process can snapshot
    state while its peers keep training.  Only a genuinely
    cross-process-sharded array (model-axis table) needs the
    replicating jit gather, which is a COLLECTIVE: every process of
    the mesh must call ``host_full`` on it together.
    """
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    if getattr(x, "is_fully_replicated", False):
        return np.asarray(x.addressable_data(0))
    sharding = x.sharding
    mesh = sharding.mesh
    rep = NamedSharding(mesh, P())
    return np.asarray(jax.jit(lambda a: a, out_shardings=rep)(x))


def make_sharded_train_segment(ts, acfg, tcfg, mesh: Mesh):
    """jit the K-step train segment with explicit in/out shardings.

    XLA/GSPMD turns the replicated-table scatter-add from the sharded
    env batch into local scatter + all-reduce over the ``data`` axis.
    """
    from ..agent.td import make_train_segment, record_env_count

    seg = make_train_segment(ts, acfg, tcfg)
    sh = td_state_shardings(
        mesh, acfg.engine_mode,
        record_all=record_env_count(tcfg) == tcfg.num_envs,
    )
    return jax.jit(seg, in_shardings=(sh,), out_shardings=sh,
                   donate_argnums=0)
