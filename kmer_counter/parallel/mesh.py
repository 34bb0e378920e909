"""Device mesh construction for the count engine.

One logical axis — ``data`` — carries both roles: reads are data-parallel
across it during counting, and the k-mer key space is range-partitioned
across it during the merge (parallel.shuffle).  On one host the mesh
spans its local GPUs, which NVLink joins all to all, so the 1-D mesh
follows the algorithm alone; on several hosts it spans every process
(jax.distributed).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ``data`` mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    import numpy as np

    return Mesh(np.array(devices), (DATA_AXIS,))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed for a multi-host run.

    Pass the arguments explicitly (or via JAX's standard env vars).  After
    this, ``make_mesh()`` spans every device of every process — the
    reference has no multi-node story at all (SURVEY.md §2.3).

    Idempotent: safe to call when already initialized or single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process defaults


def process_shard(paths: list[str]) -> list[str]:
    """Round-robin file assignment for this process's ingest (multi-host
    data sharding: each host parses only its own files)."""
    n = jax.process_count()
    if n <= 1:
        return list(paths)
    idx = jax.process_index()
    return [p for i, p in enumerate(paths) if i % n == idx]


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded across the data axis (reads or table slots)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
