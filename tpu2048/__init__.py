"""tpu2048 — a 2048 reinforcement-learning framework on JAX/XLA.

A from-scratch JAX/XLA re-design with the capabilities of the
reference system (abachurin/2048): 4x4 game engine, n-tuple TD(0)
learner, expectimax search, persistence, observability, and
replay/watch/play applications — re-architected as vectorized lockstep
environments and an on-device actor–learner sharded over device
meshes.

Layer map (see README.md):
    engine/    vectorized environment core + sequential CPU parity mode
    features/  n-tuple feature index engine (f2..f6 geometries, D4 symmetry)
    agent/     TD(0) n-tuple learner (gather / scatter-add on a flat table)
    search/    batched fixed-depth expectimax
    train/     host training / evaluation drivers
    parallel/  device mesh, shardings, collectives (DP + table-sharded TP)
    ops/       table-op dispatch (gather / one-hot matmul), digit perms
    store/     artifact store (local FS / object store), checkpoints
    obs/       logging, metrics, job registry, profiling
    apps/      web service + desktop/CLI clients
"""

__version__ = "0.1.0"
