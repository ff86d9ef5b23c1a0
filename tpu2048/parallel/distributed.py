"""Multi-host bring-up (the framework's communication backend).

The reference has NO communication backend at all — its only
inter-process channel is S3 document polling (SURVEY §2.2 / §5:
``start.py:84-141``, ``application.py:164-182``).  Here the data
plane is JAX/XLA collectives (NCCL over NVLink within a host, the
network across hosts); this module owns the control-plane bring-up:

  * ``initialize()`` wraps ``jax.distributed.initialize`` with
    explicit arguments or the env vars COORDINATOR_ADDRESS,
    NUM_PROCESSES and PROCESS_ID — call it once per process before
    any device op; with no coordinator it is a no-op.
  * ``global_mesh()`` builds the (data, model) mesh over the global
    device set, so the same ``make_sharded_train_segment`` spans
    every process: each feeds its local shard of the env batch, the
    weight table is replicated (or model-sharded) and TD updates
    all-reduce automatically through GSPMD.

Host-side coordination above this (job registry, leases, heartbeats)
stays in ``tpu2048.obs.jobs`` — storage-backed like the reference's
status.json concept, but never in the device hot path.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from ..config import MeshConfig
from .mesh import make_mesh

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Bring up jax.distributed for a multi-process run.

    Resolution order: explicit args > env vars (COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID).  Returns True if distributed mode was
    initialized, False when no coordinator is given (single process).
    Safe to call more than once.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def global_mesh(cfg: Optional[MeshConfig] = None):
    """(data, model) mesh over the global (all-host) device set."""
    devices = jax.devices()
    if cfg is None:
        cfg = MeshConfig(data=len(devices), model=1)
    return make_mesh(cfg, devices=devices)


def process_env_slice(num_envs: int) -> slice:
    """The half-open env range this host feeds (env batch is sharded
    evenly along the data axis across processes)."""
    p = jax.process_count()
    i = jax.process_index()
    per = num_envs // p
    return slice(i * per, (i + 1) * per)
