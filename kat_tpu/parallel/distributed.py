"""Multi-host runtime: process-group init and per-host work sharding.

The reference has no distributed backend at all — pthreads + one shared
mmap'd hash are the whole story (SURVEY §2.5 P9, lib locks_pthread.hpp).
This module is the framework's replacement:

  - `init_distributed()` brings up the jax.distributed process group
    (coordinator discovery via standard env vars or explicit args);
    within a host collectives ride NVLink, across hosts the network.
  - `shard_files(paths)` splits input files across hosts (data parallelism,
    the multi-host analogue of the cooperative input pool P1).
  - `global_mesh()` builds a mesh over all devices of all processes; the
    ShardedCounter works unchanged on it — `all_to_all` k-mer routing and
    `psum` merges are topology-aware in XLA.

Single-process use is always safe: every helper degrades to the local
devices without requiring initialization.
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import numpy as np


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the jax.distributed runtime (idempotent).

    Arguments default from the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or the
    cluster autodetection built into jax.distributed.initialize).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def shard_files(paths: Sequence[str],
                index: int | None = None,
                count: int | None = None) -> list[str]:
    """This host's slice of the input files (round-robin by size rank, so
    hosts get balanced byte totals even when file sizes are skewed)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(paths)
    sized = sorted(paths, key=lambda p: -os.path.getsize(p)
                   if os.path.exists(p) else 0)
    return [p for i, p in enumerate(sized) if i % count == index]


def balanced_batches(local_batches: Sequence, rows: int, length: int):
    """Yield this process's batches, then empty (all-invalid) padding
    batches so EVERY process yields the same count.

    The sharded counter's flush is a collective program: all processes
    must call `add_codes` (and hence flush) in lockstep.  When per-host
    file shards produce uneven batch counts, hosts with fewer batches pad
    with empties — the multi-host analogue of the reference parser's
    empty-tail chunks.  The global max is agreed via one tiny allgather
    BEFORE any batch is consumed, so no counting collective can
    interleave with it.  Batches must share one [rows, length] shape.
    """
    n_local = len(local_batches)
    if process_count() > 1:
        from jax.experimental import multihost_utils

        counts = multihost_utils.process_allgather(
            np.asarray([n_local], np.int32))
        n_max = int(np.max(counts))
    else:
        n_max = n_local
    yield from iter(local_batches)
    empty = np.full((rows, length), 255, np.uint8)
    for _ in range(n_max - n_local):
        yield empty


def lockstep_code_batches(it):
    """Yield [rows, L] uint8 code batches padded to a globally agreed
    shape each step, until EVERY process's stream is exhausted.

    The sharded counter's flush schedule is a collective program driven
    by batch shapes and counts (add_codes flushes on shape change and
    every flush_batches); per-host file shards produce neither the same
    shapes nor the same counts.  One tiny allgather per batch agrees on
    (any_left, max_rows, max_len): every process then feeds an identical
    [max_rows, max_len] geometry — its own data top-left, 255 (invalid)
    padding elsewhere — so flushes stay in lockstep everywhere.  Padding
    adds only invalid windows, which the extractor masks, leaving counts
    exact.  Single-process: passthrough."""
    if process_count() <= 1:
        yield from it
        return
    from jax.experimental import multihost_utils

    it = iter(it)
    while True:
        batch = next(it, None)
        rows, length = batch.shape if batch is not None else (0, 0)
        agg = multihost_utils.process_allgather(
            np.asarray([int(batch is not None), rows, length], np.int64))
        agg = agg.reshape(-1, 3)
        if not agg[:, 0].any():
            return
        rmax = int(agg[:, 1].max())
        lmax = int(agg[:, 2].max())
        out = np.full((rmax, lmax), 255, np.uint8)
        if batch is not None:
            out[:rows, :length] = batch
        yield out


def global_mesh(axis_names: Sequence[str] = ("shards",),
                shape: Sequence[int] | None = None):
    """Mesh over every device of every process (ICI within a slice, DCN
    across hosts).  Defaults to one flat k-mer-sharding axis."""
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    if shape is not None:
        devs = devs.reshape(tuple(shape))
    return Mesh(devs, tuple(axis_names))
