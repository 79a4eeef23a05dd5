"""Device-mesh sharding for the quantification engine.

The reference is single-process (SURVEY.md §2.3); the device design
shards the *cell axis* (pure data parallelism — per-cell UMI resolution
and EM are independent) and the *barcode/read axis* for the histogram
and collation phases, with psum/all-gather merges between devices:

* permit-list histogram: reads sharded across chips; per-chip partial
  histograms over the (replicated, sorted) whitelist merge with a
  ``psum``;
* quant EM: cells sharded across chips; each chip runs the batched EM
  kernel locally; the per-shard sparse matrices concatenate on the host
  (no inter-cell reduction exists, matching the reference's
  thread-per-cell independence).
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "cells") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def mesh_from_env() -> Mesh | None:
    """Build the cells-axis mesh for the batched EM.  ``AFT_EM_MESH``
    overrides (``0``/``none`` → no mesh; ``auto`` → all devices; an
    integer → that many).  Unset = ``auto`` when jax's default backend
    is an accelerator (a multi-card host shards by default; a single
    card yields no mesh and plain jit), no mesh on CPU-only hosts.

    The EM batch sizes are quantized to {64, 512, 4096}
    (ops/em.py::em_cells_batched), so the device count is clamped to
    the largest power of two ≤ min(request, 64) to keep every batch
    evenly shardable."""
    import os

    spec = os.environ.get("AFT_EM_MESH", "").strip().lower()
    if spec == "":
        from ..ops.crlike import accelerator_present

        spec = "auto" if accelerator_present() else "0"
    if spec in ("0", "none", "off"):
        return None
    avail = len(jax.devices())
    want = avail if spec == "auto" else max(1, int(spec))
    n = 1
    while n * 2 <= min(want, avail, 64):
        n *= 2
    if n < 2:
        return None
    return make_mesh(n)


def sharded_histogram(mesh: Mesh, bcs: jnp.ndarray, wl_sorted: jnp.ndarray):
    """Barcode histogram against a replicated sorted whitelist.

    ``bcs`` is sharded over the cells axis; the whitelist is replicated;
    per-shard partial counts are merged with a psum.
    Returns (counts_per_wl_entry, num_unmatched).

    Runs under x64 so packed barcodes keep their full u64 width
    (bc_len > 16 bases needs more than 32 bits)."""
    axis = mesh.axis_names[0]

    def local_hist(b, v, wl):
        idx = jnp.searchsorted(wl, b)
        idx_c = jnp.minimum(idx, wl.shape[0] - 1)
        hit = (wl[idx_c] == b) & v
        cnt = jnp.zeros(wl.shape[0], jnp.int32).at[jnp.where(hit, idx_c, 0)].add(
            hit.astype(jnp.int32)
        )
        unmatched = (~hit & v).sum()
        return (
            jax.lax.psum(cnt, axis),
            jax.lax.psum(unmatched, axis),
            hit,
        )

    fn = jax.shard_map(
        local_hist,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(), P(), P(axis)),
    )
    n = len(bcs)
    n_dev = int(np.prod(mesh.devices.shape))
    pad = (-n) % n_dev
    bcs_p = np.concatenate(
        [np.asarray(bcs, np.uint64), np.zeros(pad, np.uint64)]
    )
    valid = np.ones(n + pad, bool)
    valid[n:] = False
    with jax.enable_x64(True):
        b = jax.device_put(bcs_p, NamedSharding(mesh, P(axis)))
        v = jax.device_put(valid, NamedSharding(mesh, P(axis)))
        wl = jax.device_put(
            np.asarray(wl_sorted, np.uint64), NamedSharding(mesh, P())
        )
        cnt, unm, hit = fn(b, v, wl)
        return cnt, unm, np.asarray(hit)[:n]


def sharded_bin_histogram(mesh: Mesh, idx: np.ndarray, n_bins: int):
    """Genomic-bin scatter-add histogram over the mesh (the ATAC gpl
    bin pass, atac/cellfilter.rs:67-102): bin indices shard over the
    data axis, each shard scatter-adds into a replicated bin array, and
    a psum merges the partials.  Returns int64 counts[n_bins].
    """
    axis = mesh.axis_names[0]

    def local(ix, v):
        cnt = jnp.zeros(n_bins, jnp.int32).at[
            jnp.where(v, ix, 0)
        ].add(v.astype(jnp.int32))
        return jax.lax.psum(cnt, axis)

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )
    n = len(idx)
    n_dev = int(np.prod(mesh.devices.shape))
    pad = (-n) % n_dev
    ix = np.concatenate([np.asarray(idx, np.int32), np.zeros(pad, np.int32)])
    valid = np.ones(n + pad, bool)
    valid[n:] = False
    i = jax.device_put(ix, NamedSharding(mesh, P(axis)))
    v = jax.device_put(valid, NamedSharding(mesh, P(axis)))
    return np.asarray(fn(i, v)).astype(np.int64)


def sharded_em_step(mesh: Mesh):
    """Returns a jitted one-round EM update with the cell batch sharded
    over the mesh: gather alpha over labels, normalize by class totals,
    scatter-add — the inner loop of em_cells_batched distributed
    data-parallel over cells."""
    axis = mesh.axis_names[0]
    batch_sharding = NamedSharding(mesh, P(axis))

    @partial(jax.jit, static_argnums=(4,))
    def step(labels, lens, counts, alphas, R):
        labels = jax.lax.with_sharding_constraint(labels, batch_sharding)
        alphas = jax.lax.with_sharding_constraint(alphas, batch_sharding)
        B, E, L = labels.shape
        lmask = jnp.arange(L)[None, None, :] < lens[:, :, None]
        ab = jnp.take_along_axis(alphas, labels.reshape(B, -1), axis=1).reshape(
            labels.shape
        )
        ab = jnp.where(lmask, ab, 0.0)
        denom = ab.sum(axis=2)
        single = lens == 1
        valid = lens > 0
        multi = valid & ~single
        inv = jnp.where((denom > 0) & multi, counts / jnp.maximum(denom, 1e-30), 0.0)
        contrib = ab * inv[:, :, None]
        out = jnp.zeros_like(alphas)
        bidx = jnp.broadcast_to(jnp.arange(B)[:, None, None], labels.shape)
        out = out.at[
            bidx.reshape(-1), jnp.where(lmask, labels, R).reshape(-1)
        ].add(jnp.where(multi[:, :, None], contrib, 0.0).reshape(-1))
        out = out.at[jnp.arange(B)[:, None], jnp.where(single, labels[:, :, 0], R)].add(
            jnp.where(single, counts, 0.0)
        )
        out = out.at[:, R].set(0.0)
        return jax.lax.with_sharding_constraint(out, batch_sharding)

    return step


def sharded_collate_shuffle(
    mesh: Mesh,
    ranks: np.ndarray,
    payload: np.ndarray,
    n_cells: int,
    capacity: int,
):
    """All-to-all collation shuffle over the device mesh.

    The reference's collate stage is an out-of-core scatter/gather by
    corrected barcode through temp files (collate.rs:584-905); on a
    device mesh the same regrouping is a fixed-capacity all-to-all
    (SURVEY.md §5): reads arrive sharded in mapper order, each carrying
    its corrected cell rank, and must end up grouped by cell on the
    shard that owns that cell.

    Ownership is contiguous: shard ``s`` owns ranks in
    ``[s*ceil(n_cells/S), (s+1)*ceil(n_cells/S))``.  Each device bins
    its local reads by owner, pads every bin to ``capacity``, exchanges
    bins with ``lax.all_to_all``, then sorts what it received by
    (rank, payload) — the per-shard collated order.

    Returns ``(ranks_out, payload_out, n_dropped)`` where the outputs
    have global shape ``(S, S*capacity)`` (row ``s`` = shard ``s``'s
    reads, invalid slots hold rank ``n_cells``) and ``n_dropped`` counts
    reads that overflowed a bin (0 when ``capacity`` bounds the largest
    (device, owner) bin — the analog of the reference's per-bucket
    record-count invariant, collate.rs:784-803).
    """
    axis = mesh.axis_names[0]
    S = mesh.devices.size
    cells_per_shard = -(-n_cells // S)
    C = int(capacity)
    INVALID = np.int32(n_cells)

    def local(r, p):
        n_loc = r.shape[0]
        dest = jnp.minimum(r // cells_per_shard, S - 1)
        order = jnp.argsort(dest, stable=True)
        d_sorted = dest[order]
        cnt = jnp.zeros(S, jnp.int32).at[d_sorted].add(1)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(cnt)[:-1]])
        pos = jnp.arange(n_loc, dtype=jnp.int32) - starts[d_sorted]
        ok = pos < C
        n_drop = jax.lax.psum((~ok).sum(), axis)
        # scatter into the padded (S, C) exchange buffer; dropped reads
        # land in a scratch row
        row = jnp.where(ok, d_sorted, S)
        col = jnp.where(ok, pos, 0)
        buf_r = jnp.full((S + 1, C), INVALID, r.dtype).at[row, col].set(r[order])
        buf_p = jnp.zeros((S + 1, C), p.dtype).at[row, col].set(p[order])
        ex_r = jax.lax.all_to_all(buf_r[:S], axis, split_axis=0, concat_axis=0)
        ex_p = jax.lax.all_to_all(buf_p[:S], axis, split_axis=0, concat_axis=0)
        fr = ex_r.reshape(-1)
        fp = ex_p.reshape(-1)
        # collated order on the owning shard: (rank, payload) ascending,
        # invalid slots (rank == n_cells) pushed to the end
        perm = jnp.lexsort((fp, fr))
        return fr[perm], fp[perm], n_drop

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
    )
    r = jax.device_put(
        np.asarray(ranks, np.int32), NamedSharding(mesh, P(axis))
    )
    p = jax.device_put(
        np.asarray(payload, np.int32), NamedSharding(mesh, P(axis))
    )
    ranks_out, payload_out, n_drop = jax.jit(fn)(r, p)
    return (
        np.asarray(ranks_out).reshape(S, S * C),
        np.asarray(payload_out).reshape(S, S * C),
        int(n_drop),
    )


def example_em_inputs(B=8, E=8, L=4, R=32, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, L + 1, size=(B, E)).astype(np.int32)
    labels = np.full((B, E, L), R, np.int32)
    for b in range(B):
        for e in range(E):
            labels[b, e, : lens[b, e]] = rng.choice(R, size=lens[b, e], replace=False)
    counts = rng.randint(1, 10, size=(B, E)).astype(np.float32)
    alphas = np.zeros((B, R + 1), np.float32)
    alphas[:, :R] = 1e-3
    return (
        jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(counts),
        jnp.asarray(alphas),
    )
