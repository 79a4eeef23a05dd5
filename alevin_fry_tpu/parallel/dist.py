"""Multi-host (DCN) scaffolding.

The reference is strictly single-process (SURVEY §2.3); the
scale-out story prescribed there is ``jax.distributed`` + collectives:
replicate the tg-map and permit list, shard the RAD chunk stream by
host, keep per-cell work chip-local, and merge per-host partial count
matrices at the end — the only cross-host traffic is the final ragged
all-gather (and the gpl histogram psum, which already rides the mesh).

``initialize()`` wires ``jax.distributed`` from either explicit
arguments or the standard env (``JAX_COORDINATOR_ADDRESS`` /
``AFT_COORDINATOR`` + ``AFT_NUM_PROCESSES`` + ``AFT_PROCESS_ID``).
Single-process runs never touch jax.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

_INITIALIZED = False


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (idempotent).  With no arguments and
    no coordinator env, this is a no-op (single-process run)."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    coordinator = coordinator or os.environ.get(
        "AFT_COORDINATOR", os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("AFT_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("AFT_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True


def rank_world() -> Tuple[int, int]:
    """(process_index, process_count) — (0, 1) when jax.distributed is
    not initialized (cheap: avoids importing jax in that case)."""
    if not _INITIALIZED and "AFT_COORDINATOR" not in os.environ and (
        "JAX_COORDINATOR_ADDRESS" not in os.environ
    ):
        return 0, 1
    import jax

    return jax.process_index(), jax.process_count()


def host_chunk_plan(num_chunks: int, world: int, rank: int) -> Tuple[int, int]:
    """Contiguous chunk range [start, end) owned by this host.

    Collated files carry one chunk per cell in descending read-count
    order, so contiguous ranges balance by count; raw (uncollated)
    chunks are near-uniform by construction (fixed records per chunk).
    """
    per = num_chunks // world
    extra = num_chunks % world
    start = rank * per + min(rank, extra)
    end = start + per + (1 if rank < extra else 0)
    return start, end


def barrier(name: str = "aft_barrier") -> None:
    """Block until every process reaches this point (no-op single-host).
    Used where one rank writes a file the others will read next."""
    rank, world = rank_world()
    if world == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def allgather_ragged(arr: np.ndarray) -> List[np.ndarray]:
    """All-gather a 1-D array whose length differs per process.
    Returns the per-process arrays in rank order (every host gets the
    full list).  Pads to the global max length under the hood
    (multihost collectives need uniform shapes)."""
    rank, world = rank_world()
    if world == 1:
        return [np.asarray(arr)]
    import jax
    from jax.experimental import multihost_utils

    arr = np.asarray(arr)
    if arr.dtype.itemsize == 8:
        # jax demotes 64-bit dtypes to 32 bits unless x64 is enabled,
        # which would silently truncate e.g. composite (sample, cell)
        # keys — ship 8-byte elements as u32 pairs instead
        parts = allgather_ragged(arr.view(np.uint32))
        return [np.ascontiguousarray(p).view(arr.dtype) for p in parts]
    n = np.asarray([arr.shape[0]], np.int64)
    lens = np.asarray(multihost_utils.process_allgather(n)).reshape(world)
    m = int(lens.max())
    if m == 0:
        return [np.zeros(0, arr.dtype) for _ in range(world)]
    pad = np.zeros(m, arr.dtype)
    pad[: arr.shape[0]] = arr
    gathered = np.asarray(multihost_utils.process_allgather(pad))
    return [gathered[r, : int(lens[r])] for r in range(world)]


def stream_concat_files(local_path, out_fh, chunk_bytes: int = 8 << 20) -> int:
    """Concatenate every rank's local file into ``out_fh`` (rank 0
    writes; other ranks pass their bytes) in rank order, over bounded
    DCN chunks so memory stays flat regardless of file size.  Every
    rank must call this (collective).  Returns total bytes written."""
    import os as _os

    rank, world = rank_world()
    n = _os.path.getsize(local_path)
    if world == 1:
        with open(local_path, "rb") as fh:
            while True:
                b = fh.read(chunk_bytes)
                if not b:
                    break
                out_fh.write(b)
        return n
    sizes = [int(p[0]) for p in allgather_ragged(np.asarray([n], np.int64))]
    total = 0
    fh = open(local_path, "rb")
    try:
        for r in range(world):
            rounds = (sizes[r] + chunk_bytes - 1) // chunk_bytes
            for _ in range(rounds):
                if r == rank:
                    data = np.frombuffer(fh.read(chunk_bytes), np.uint8)
                else:
                    data = np.zeros(0, np.uint8)
                parts = allgather_ragged(data)
                if rank == 0 and out_fh is not None:
                    out_fh.write(parts[r].tobytes())
                total += len(parts[r])
    finally:
        fh.close()
    return total


def merge_partial_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    row_offset: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-host partial COO matrices: each host's rows are local
    cell indices offset by its global row base; the gathered triplets
    concatenate in rank order (hosts own disjoint, contiguous cell
    ranges, so no reduction is needed — SURVEY §2.3 'merged by
    concat')."""
    rank, world = rank_world()
    if world == 1:
        return np.asarray(rows), np.asarray(cols), np.asarray(vals)
    r = allgather_ragged(np.asarray(rows, np.int64) + np.int64(row_offset))
    c = allgather_ragged(np.asarray(cols, np.int64))
    v = allgather_ragged(np.asarray(vals, np.float32))
    return np.concatenate(r), np.concatenate(c), np.concatenate(v)
