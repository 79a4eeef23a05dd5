"""collate — group reads by corrected cell barcode.

The reference implements this as an out-of-core scatter/gather over
temp-file buckets (src/collate.rs:396-939).  Here collation is a
single device sort: ingest the RAD file to columnar arrays, correct
barcodes through the permit map (vectorized binary search), filter
alignments to the expected orientation, and stable-sort reads by cell
rank (cells ordered by descending read count, the reference's
largest-cells-first order, collate.rs:180-182).

The output contract matches the reference exactly: ``map.collated.rad``
with one chunk per cell and num_chunks patched in the header
(collate.rs:542-581), ``collate.json``, and
``unmapped_bc_count_collated.bin``.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from .. import __version__
from ..radz import bincodeio, read_prelude, record_type_from_prelude, KnownRecordType
from ..radz.chunkio import ReadBatch, decode_all_chunks
from ..radz.records import RecordSchema
from ..radz import unmapped as unmappedio
from ..utils import aln_strand_mask, check_version_compat, write_json
from .logging_ import get_logger

log = get_logger("collate")


def _lookup_map(keys_sorted: np.ndarray, vals: np.ndarray, query: np.ndarray):
    """Vectorized hash-map lookup (native hash table when available,
    binary search otherwise).  Returns (hit_mask, mapped_values)."""
    if len(keys_sorted) == 0:
        return np.zeros(len(query), bool), np.zeros(len(query), np.uint64)
    from ..radz import _native

    if _native.available() and len(query) > 4096:
        return _native.lookup_u64(keys_sorted, vals, query)
    idx = np.searchsorted(keys_sorted, query)
    idx_c = np.minimum(idx, len(keys_sorted) - 1)
    hit = (idx < len(keys_sorted)) & (keys_sorted[idx_c] == query)
    return hit, vals[idx_c]


def correct_and_filter(
    batch: ReadBatch,
    map_keys: np.ndarray,
    map_vals: np.ndarray,
    expected_ori: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, dict]:
    """Correct barcodes and filter alignments by orientation.

    Returns (corrected_bc_per_read, keep_read_mask, keep_aln_mask,
    new_aln_offsets_for_kept_reads, stats).  Matches the behavior of
    dump_corrected_cb_chunk_to_temp_file_generic: records whose barcode
    isn't correctable are dropped; alignments not matching the expected
    orientation are dropped; records left with no alignments are dropped.
    """
    bcs = batch.barcode()
    hit, corrected = _lookup_map(map_keys, map_vals, bcs)

    keep_aln = aln_strand_mask(batch.dirs, expected_ori)
    # per-read surviving alignment counts
    n = batch.n_reads
    kept_per_read = np.add.reduceat(keep_aln.astype(np.int64), batch.aln_offsets[:-1]) \
        if n else np.zeros(0, np.int64)
    kept_per_read[np.diff(batch.aln_offsets) == 0] = 0
    keep_read = hit & (kept_per_read > 0)

    # expand read mask to alignments, intersect with orientation mask
    read_of_aln = np.repeat(np.arange(n), batch.num_aln_per_read)
    keep_aln_final = keep_aln & keep_read[read_of_aln]

    new_offsets = np.zeros(int(keep_read.sum()) + 1, np.int64)
    np.cumsum(kept_per_read[keep_read], out=new_offsets[1:])
    stats = {"dropped_reads": int(n - keep_read.sum())}
    return corrected, keep_read, keep_aln_final, new_offsets, stats


def collate_device_enabled() -> bool:
    """Whether the device all-to-all shuffle computes the collation
    order.  ``AFT_COLLATE_BACKEND`` = ``jax`` forces it, ``host``
    disables it; ``auto`` (default) uses the device whenever jax's
    default backend is an accelerator — same policy as the quant
    resolver (ops/crlike.py::device_backend_enabled)."""
    import os

    mode = os.environ.get("AFT_COLLATE_BACKEND", "auto")
    if mode == "host":
        return False
    if mode == "jax":
        return True
    from ..ops.crlike import accelerator_present

    return accelerator_present()


def collation_order_device(ranks: np.ndarray, n_cells: int):
    """Stable grouping order of reads by cell rank via the mesh
    all-to-all shuffle (parallel/mesh.py::sharded_collate_shuffle — the
    device analog of the reference's temp-bucket scatter/gather,
    collate.rs:584-905).  Returns (order, per_cell_counts), or None
    for inputs the int32 device layout cannot hold; ``order`` equals
    ``np.argsort(ranks, kind="stable")``."""
    n = len(ranks)
    if n == 0 or n_cells == 0 or n >= (1 << 31) - 1:
        return None
    from ..parallel.mesh import make_mesh, sharded_collate_shuffle

    mesh = make_mesh()
    S = int(mesh.devices.size)
    n_pad = -(-n // S) * S
    r = np.full(n_pad, n_cells, np.int64)
    r[:n] = ranks
    payload = np.arange(n_pad, dtype=np.int64)
    # exchange-bin capacity = largest (source shard, owner shard) bin,
    # so no read can overflow its bin (the analog of the reference's
    # per-bucket record-count asserts, collate.rs:784-803)
    cps = -(-n_cells // S)
    owner = np.minimum(r // cps, S - 1)
    src = np.repeat(np.arange(S, dtype=np.int64), n_pad // S)
    cap = max(1, int(np.bincount(src * S + owner, minlength=S * S).max()))
    r_out, p_out, dropped = sharded_collate_shuffle(
        mesh, r, payload, n_cells, cap
    )
    if dropped:
        raise AssertionError(
            f"device collation shuffle dropped {dropped} reads although "
            f"every bin fits the capacity {cap}"
        )
    fr = r_out.reshape(-1)
    order = p_out.reshape(-1)[fr != n_cells].astype(np.int64)
    per_cell = np.bincount(
        np.asarray(ranks, np.int64), minlength=n_cells
    ).astype(np.int64)
    return order, per_cell


def _gather_bucket_payload(rec_bytes: np.ndarray, ranks: np.ndarray, schema):
    """Assemble one spill bucket into its final chunk bytes: stable-sort
    the re-encoded records by cell rank, prepend an 8-byte chunk header
    per cell, return (out_buf, n_chunks).  Shared by the single-host
    file gather and the multi-host DCN gather."""
    from ..radz import _native

    if _native.available():
        rec_starts, num_aln = _native.walk_records(
            rec_bytes, np.asarray([0], np.int64),
            np.asarray([len(ranks)], np.int64),
            schema.read_bytes, schema.aln_bytes,
        )
    else:
        from ..radz.chunkio import _walk_records_py

        rec_starts, num_aln = _walk_records_py(
            rec_bytes, [0], [len(ranks)],
            schema.read_bytes, schema.aln_bytes,
        )
    sizes = 4 + schema.read_bytes + num_aln * schema.aln_bytes
    order = np.argsort(ranks, kind="stable")
    out_sizes = sizes[order]
    rs = ranks[order]
    newc = np.ones(len(rs), bool)
    newc[1:] = rs[1:] != rs[:-1]
    starts = np.flatnonzero(newc)
    ends = np.append(starts[1:], len(rs))
    chunk_of = np.cumsum(newc) - 1
    dst = np.zeros(len(order) + 1, np.int64)
    np.cumsum(out_sizes, out=dst[1:])
    rec_dst = dst[:-1] + 8 * (chunk_of + 1)
    total = int(dst[-1]) + 8 * len(starts)
    out_buf = np.empty(total, np.uint8)
    if _native.available():
        _native.gather_records(
            rec_bytes, rec_starts, sizes, order, rec_dst, out_buf
        )
    else:
        gidx = np.repeat(rec_starts[order], out_sizes) + (
            np.arange(int(dst[-1]))
            - np.repeat(dst[:-1], out_sizes)
        )
        tgt = np.repeat(rec_dst, out_sizes) + (
            np.arange(int(dst[-1]))
            - np.repeat(dst[:-1], out_sizes)
        )
        out_buf[tgt] = rec_bytes[gidx]
    # chunk headers: [nbytes:u32][nrec:u32] at each cell's start
    hdr_pos = rec_dst[starts] - 8
    nrec_c = (ends - starts).astype(np.uint32)
    nbytes_c = (dst[ends] - dst[starts] + 8).astype(np.uint32)
    hv = out_buf.view(np.uint8)
    for field, off in ((nbytes_c, 0), (nrec_c, 4)):
        le = field.astype("<u4").view(np.uint8).reshape(-1, 4)
        for k in range(4):
            hv[hdr_pos + off + k] = le[:, k]
    return out_buf, len(starts)


def _gather_rank_buckets(
    out_path: Path,
    spill_dir: Path,
    n_buckets: int,
    schema,
    prelude,
    ftm,
    compress_out: bool,
    n_cells: int,
):
    """Gather phase of the spill-bucket collation: per bucket, byte-sort
    the re-encoded records by cell rank and append one chunk per cell to
    ``out_path``.  The exact chunk count comes from a cheap pre-scan of
    the (u32 rank) sidecars — the compressed stream cannot be
    backpatched, and a header over-claiming chunks would make readers
    hit EOF (cells may lose all reads to the orientation filter).
    Returns (n_written, per_cell_record_counts)."""
    per_cell = np.zeros(n_cells, np.int64)
    for b in range(n_buckets):
        ranks = np.fromfile(spill_dir / f"bucket_{b}.rank", np.uint32)
        if len(ranks):
            per_cell += np.bincount(
                ranks.astype(np.int64), minlength=n_cells
            )
    n_expected = int((per_cell > 0).sum())

    raw_sink = open(out_path, "wb")
    if compress_out:
        from ..radz.snappyz import SnappyFrameWriter
        import io

        head = io.BytesIO()
        sink = head
    else:
        sink = raw_sink
    n_written = 0
    prelude.hdr.num_chunks = n_expected
    nc_pos = prelude.write(sink)
    prelude.write_file_tag_values(sink, ftm)
    if compress_out:
        frame = SnappyFrameWriter(raw_sink)
        frame.write(head.getvalue())

    for b in range(n_buckets):
        rec_bytes = np.fromfile(spill_dir / f"bucket_{b}.rec", np.uint8)
        ranks = np.fromfile(spill_dir / f"bucket_{b}.rank", np.uint32)
        if len(ranks) == 0:
            continue
        out_buf, n_chunks = _gather_bucket_payload(rec_bytes, ranks, schema)
        w = frame if compress_out else sink
        w.write(out_buf.tobytes())
        n_written += n_chunks
        (spill_dir / f"bucket_{b}.rec").unlink()
        (spill_dir / f"bucket_{b}.rank").unlink()
    if compress_out:
        frame.flush()
        raw_sink.close()
        assert n_written == n_expected, (n_written, n_expected)
    else:
        if n_written != n_expected:
            # defensive: the pre-scan makes this unreachable
            pos = sink.tell()
            sink.seek(nc_pos)
            sink.write(struct.pack("<Q", n_written))
            sink.seek(pos)
        sink.close()
    return n_written, per_cell


def _gather_rank_buckets_multihost(
    out_path: Path,
    spill_dir: Path,
    n_buckets: int,
    schema,
    prelude,
    ftm,
    compress_out: bool,
    n_cells: int,
):
    """Multi-host gather: every host holds spill buckets for ITS chunk
    range; per bucket, the record/rank streams are all-gathered over DCN
    and concatenated in rank order (= global input chunk order, so the
    stable per-bucket sort reproduces the single-host byte stream
    exactly), and rank 0 writes the collated file.  All ranks execute
    the collectives; only rank 0 touches the output.  This is the DCN
    analog of the reference's temp-bucket gather (collate.rs:823-905),
    the stage SURVEY §5 prescribes collectives for."""
    from ..parallel import dist

    rank, world = dist.rank_world()
    # pass 1: all-gather the (small) rank sidecars — yields the exact
    # chunk count (compressed output cannot be backpatched) and keeps
    # the per-bucket streams for pass 2 on rank 0 only
    per_cell = np.zeros(n_cells, np.int64)
    rank_streams = []
    for b in range(n_buckets):
        local = np.fromfile(spill_dir / f"bucket_{b}.rank", np.uint32)
        parts = dist.allgather_ragged(local)
        cat = np.concatenate(parts) if parts else local
        if rank == 0:
            rank_streams.append(cat)
            if len(cat):
                per_cell += np.bincount(cat.astype(np.int64), minlength=n_cells)
        del parts, cat
    n_expected = int((per_cell > 0).sum())

    n_written = 0
    sink = raw_sink = frame = None
    if rank == 0:
        raw_sink = open(out_path, "wb")
        if compress_out:
            from ..radz.snappyz import SnappyFrameWriter
            import io

            head = io.BytesIO()
            prelude.hdr.num_chunks = n_expected
            prelude.write(head)
            prelude.write_file_tag_values(head, ftm)
            frame = SnappyFrameWriter(raw_sink)
            frame.write(head.getvalue())
        else:
            sink = raw_sink
            prelude.hdr.num_chunks = n_expected
            prelude.write(sink)
            prelude.write_file_tag_values(sink, ftm)

    for b in range(n_buckets):
        local = np.fromfile(spill_dir / f"bucket_{b}.rec", np.uint8)
        parts = dist.allgather_ragged(local)
        if rank == 0:
            rec_bytes = np.concatenate(parts) if parts else local
            ranks = rank_streams[b]
            if len(ranks):
                out_buf, n_chunks = _gather_bucket_payload(
                    rec_bytes, ranks, schema
                )
                (frame if compress_out else sink).write(out_buf.tobytes())
                n_written += n_chunks
        del parts
        (spill_dir / f"bucket_{b}.rec").unlink()
        (spill_dir / f"bucket_{b}.rank").unlink()

    if rank == 0:
        if compress_out:
            frame.flush()
        raw_sink.close()
        assert n_written == n_expected, (n_written, n_expected)
    # all hosts wait until the file exists before the next stage reads it
    dist.barrier("collate_gather_done")
    return n_written, per_cell


def _collate_out_of_core(
    input_dir: Path,
    rad_dir: Path,
    cell_bcs: np.ndarray,
    cell_cts: np.ndarray,
    map_keys: np.ndarray,
    map_vals: np.ndarray,
    expected_ori: str,
    velo_mode: bool,
    max_records: int,
    compress_out: bool,
    expect_atac: bool = False,
    chunk_range: tuple | None = None,
    multihost: bool = False,
) -> None:
    """Bounded-memory collation: scatter corrected records into
    rank-range spill buckets (each <= max_records), then gather each
    bucket with one in-memory sort.  Records are re-encoded once during
    scatter and moved byte-wise during gather (no second field decode).

    Shared by the RNA path (orientation-filtered) and the ATAC path
    (``expect_atac=True``, ``expected_ori='.'`` — ATAC records carry no
    orientation; reference atac/collate.rs keys purely by barcode)."""
    from ..radz.chunkio import encode_records, iter_decoded_blocks
    from ..radz import _native

    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, _info = record_type_from_prelude(prelude, ftm)
        if (rec_type == KnownRecordType.ATAC) != expect_atac:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" '
                "sub-command" if rec_type == KnownRecordType.ATAC
                else "the atac collate sub-command requires an ATAC RAD file"
            )
        schema = RecordSchema.from_prelude(prelude)

        if multihost and chunk_range is None:
            from ..parallel import dist

            rank, world = dist.rank_world()
            nchunks = int(prelude.hdr.num_chunks)
            if nchunks <= 0:
                raise ValueError(
                    "multi-host collate needs a chunk count in the RAD header"
                )
            chunk_range = dist.host_chunk_plan(nchunks, world, rank)
            log.info(
                "multi-host collate: host %d/%d scatters chunks [%d, %d)",
                rank, world, chunk_range[0], chunk_range[1],
            )

        # bucket planning over the descending-count cell ranks
        csum = np.zeros(len(cell_cts) + 1, np.int64)
        np.cumsum(cell_cts.astype(np.int64), out=csum[1:])
        # bucket b covers ranks with csum in [b*max_records, ...)
        bucket_of_rank = (csum[:-1] // max_records).astype(np.int64)
        n_buckets = int(bucket_of_rank[-1]) + 1 if len(cell_cts) else 1
        log.info(
            "out-of-core collation: %d records into %d spill buckets",
            int(csum[-1]), n_buckets,
        )

        sort_perm = np.argsort(cell_bcs, kind="stable")
        cell_sorted = cell_bcs[sort_perm]

        if multihost:
            from ..parallel import dist

            rank, _world = dist.rank_world()
            spill_dir = input_dir / f"_collate_tmp_r{rank}"
        else:
            spill_dir = input_dir / "_collate_tmp"
        spill_dir.mkdir(exist_ok=True)
        bucket_files = [
            (open(spill_dir / f"bucket_{b}.rec", "wb"),
             open(spill_dir / f"bucket_{b}.rank", "wb"))
            for b in range(n_buckets)
        ]
        try:
            # ATAC gpl outputs may leave num_chunks = 0 in the header
            # (chunk count lives in the gpl JSON, atac/collate.rs:212);
            # None = stream until EOF
            from .progress import stage_timer

            # file read of block k+1 overlaps the scatter of block k
            # (collate.rs:646-763 reader/worker pattern; only the raw
            # IO runs on the producer thread — see chunkio)
            pb_ctx = stage_timer(log, "collate scatter", "reads")
            pb = pb_ctx.__enter__()
            # stream in blocks SMALLER than the spill-bucket bound:
            # max_records caps a bucket's gather memory, but decoding
            # 30M-record blocks in one go spikes RSS by GBs and
            # serializes the producer/consumer overlap — 4M-record
            # blocks measured 1.3x faster at 10M reads (r5) and cost
            # nothing (bucket planning is independent of block size)
            block_records = min(
                max_records,
                int(os.environ.get("AFT_COLLATE_BLOCK_RECORDS", 4_000_000)),
            )
            for batch in iter_decoded_blocks(
                fh, schema, prelude.hdr.num_chunks or None, block_records,
                prefetch=True, chunk_range=chunk_range,
            ):
                pb.update(batch.n_reads)
                corrected, keep_read, keep_aln, new_offsets, _ = (
                    correct_and_filter(batch, map_keys, map_vals, expected_ori)
                )
                kept = np.flatnonzero(keep_read)
                if len(kept) == 0:
                    continue
                rank = sort_perm[
                    np.searchsorted(cell_sorted, corrected[keep_read])
                ]
                read_cols = {k: v[kept] for k, v in batch.read_cols.items()}
                read_cols[schema.barcode_fields[-1]] = corrected[keep_read]
                refs = batch.refs[keep_aln]
                dirs = batch.dirs[keep_aln]
                aln_cols = {k: v[keep_aln] for k, v in batch.aln_cols.items()}
                bmask = bucket_of_rank[rank]
                nal = np.diff(new_offsets)
                for b in np.unique(bmask):
                    sel = np.flatnonzero(bmask == b)
                    offs = np.zeros(len(sel) + 1, np.int64)
                    np.cumsum(nal[sel], out=offs[1:])
                    gather = np.repeat(new_offsets[:-1][sel], nal[sel]) + (
                        np.arange(int(offs[-1]))
                        - np.repeat(offs[:-1], nal[sel])
                    )
                    body = encode_records(
                        schema,
                        {k: v[sel] for k, v in read_cols.items()},
                        offs,
                        refs[gather], dirs[gather],
                        {k: v[gather] for k, v in aln_cols.items()},
                    )
                    bucket_files[int(b)][0].write(body.tobytes())
                    bucket_files[int(b)][1].write(
                        rank[sel].astype(np.uint32).tobytes()
                    )
            for rf, kf in bucket_files:
                rf.close()
                kf.close()

            cfname = (
                "velo.map.collated.rad" if velo_mode
                else ("map.collated.rad.sz" if compress_out else "map.collated.rad")
            )
            gather = (
                _gather_rank_buckets_multihost if multihost
                else _gather_rank_buckets
            )
            n_written, _per_cell = gather(
                input_dir / cfname, spill_dir, n_buckets, schema, prelude,
                ftm, compress_out, len(cell_bcs),
            )
        finally:
            for rf, kf in bucket_files:
                if not rf.closed:
                    rf.close()
                if not kf.closed:
                    kf.close()
            for p in spill_dir.glob("bucket_*"):
                p.unlink(missing_ok=True)
            try:
                spill_dir.rmdir()
            except OSError:
                pass
    log.info(
        "finished out-of-core collation; wrote %d cell chunks", n_written
    )


def _collate_in_memory_native(
    input_dir: Path,
    rad_dir: Path,
    cell_bcs: np.ndarray,
    cell_cts: np.ndarray,
    map_keys: np.ndarray,
    map_vals: np.ndarray,
    expected_ori: str,
    velo_mode: bool,
    compress_out: bool,
    expect_atac: bool = False,
) -> bool:
    """Byte-level in-memory collation: walk record boundaries, correct
    barcodes, then gather whole records in cell-rank order with the
    barcode patched in place and alignments orientation-filtered — one
    native pass, no column decode/re-encode.  Returns False when the
    schema isn't eligible (caller falls back to the columnar path).

    ``expect_atac``: the ATAC collation is the same byte-level gather
    keyed purely by barcode (atac/collate.rs:586-595; records carry no
    orientation, so the caller passes ``expected_ori='.'``)."""
    from ..radz import _native
    from ..radz.chunkio import read_chunk_bodies, _gather_uint

    if not _native.available():
        return False
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, _info = record_type_from_prelude(prelude, ftm)
        if (rec_type == KnownRecordType.ATAC) != expect_atac:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" '
                "sub-command" if rec_type == KnownRecordType.ATAC
                else "the atac collate sub-command requires an ATAC RAD file"
            )
        schema = RecordSchema.from_prelude(prelude)
        ori_mode = {
            "both": 0, ".": 0, "fw": 1, "+": 1, "rc": 2, "-": 2,
        }.get(expected_ori)
        if ori_mode is None or schema.ref_field is None:
            return False
        ref_off = 0
        for name, w in schema.aln_fields:
            if name == schema.ref_field:
                break
            ref_off += w
        ref_width = dict(schema.aln_fields)[schema.ref_field]
        if ori_mode != 0 and ref_width != 4:
            return False
        bc_name = schema.barcode_fields[-1]
        bc_off = 0
        for name, w in schema.read_fields:
            if name == bc_name:
                bc_width = w
                break
            bc_off += w
        # ATAC gpl outputs may leave num_chunks = 0 in the header
        # (atac/collate.rs:212); None = stream until EOF
        buf, region_starts, chunk_recs = read_chunk_bodies(
            fh, prelude.hdr.num_chunks or None
        )
    rec_starts, num_aln = _native.walk_records(
        buf, region_starts, chunk_recs, schema.read_bytes, schema.aln_bytes
    )
    n = len(rec_starts)
    log.info(
        "collating %d reads across %d chunks into %d cells",
        n, len(chunk_recs), len(cell_bcs),
    )

    bcs = _gather_uint(buf, rec_starts + 4 + bc_off, bc_width)
    # fold the two lookups (raw bc -> corrected bc -> cell rank) into one:
    # remap the correction map's values to cell ranks up front (small),
    # then a single binary search per read yields its rank directly
    sort_perm = np.argsort(cell_bcs, kind="stable")
    cell_sorted = cell_bcs[sort_perm]
    mpos = np.searchsorted(cell_sorted, map_vals)
    assert (
        cell_sorted[np.minimum(mpos, len(cell_sorted) - 1)] == map_vals
    ).all(), "corrected barcode missing from permit list"
    map_rank = sort_perm[mpos].astype(np.uint64)
    hit, rank = _lookup_map(map_keys, map_rank, bcs)
    if ori_mode == 0:
        kept_per_read = num_aln
    else:
        kept_per_read = _native.ori_counts(
            buf, rec_starts, num_aln,
            schema.read_bytes, schema.aln_bytes, ref_off, ori_mode,
        )
    keep_read = hit & (kept_per_read > 0)
    kept_idx = np.flatnonzero(keep_read)
    corrected = (
        cell_bcs[np.where(hit, rank, 0).astype(np.int64)]
        if len(cell_bcs)
        else np.zeros(n, np.uint64)
    )

    # group kept reads by cell rank: device all-to-all shuffle when an
    # accelerator is present, stable O(n) native counting sort otherwise
    dev = (
        collation_order_device(rank[kept_idx].astype(np.int64), len(cell_bcs))
        if collate_device_enabled() else None
    )
    if dev is not None:
        order_rel, per_cell = dev
    else:
        order_rel, per_cell = _native.counting_sort(
            rank[kept_idx].astype(np.int64), len(cell_bcs)
        )
    order = kept_idx[order_rel]
    if not np.array_equal(per_cell, cell_cts.astype(np.int64)):
        log.warning(
            "per-cell collated record counts differ from permit_freq counts "
            "(total %d vs %d)", int(per_cell.sum()), int(cell_cts.sum()),
        )

    # exact per-chunk output offsets (record sizes are known up front
    # from the kept-alignment counts) make every chunk independent, so
    # the byte-gather emit runs threaded
    order_offsets = np.zeros(len(per_cell) + 1, np.int64)
    np.cumsum(per_cell, out=order_offsets[1:])
    sizes = 4 + schema.read_bytes + kept_per_read[order] * schema.aln_bytes
    szsum = np.zeros(len(order) + 1, np.int64)
    np.cumsum(sizes, out=szsum[1:])
    chunk_bytes = (
        szsum[order_offsets[1:]] - szsum[order_offsets[:-1]]
        + 8 * (per_cell > 0)
    )
    out_offsets = np.zeros(len(per_cell) + 1, np.int64)
    np.cumsum(chunk_bytes, out=out_offsets[1:])
    body = _native.collate_emit2(
        buf, rec_starts, num_aln, corrected, order, order_offsets,
        out_offsets, schema.read_bytes, schema.aln_bytes, bc_off, bc_width,
        ref_off, ori_mode,
    )
    n_written = int((per_cell > 0).sum())

    cfname = (
        "velo.map.collated.rad" if velo_mode
        else ("map.collated.rad.sz" if compress_out else "map.collated.rad")
    )
    out_path = input_dir / cfname
    prelude.hdr.num_chunks = n_written
    if compress_out:
        import io

        from ..radz import snappyz

        raw = io.BytesIO()
        prelude.write(raw)
        prelude.write_file_tag_values(raw, ftm)
        raw.write(memoryview(body.data))
        with open(out_path, "wb") as out:
            snappyz.frame_compress_stream(raw.getvalue(), out)
    else:
        with open(out_path, "wb") as out:
            prelude.write(out)
            prelude.write_file_tag_values(out, ftm)
            out.write(memoryview(body.data))
    log.info("finished collating input rad file; wrote %d cell chunks", n_written)
    return True


def collate(
    input_dir: Path,
    rad_dir: Path,
    num_threads: int = 8,
    max_records: int = 30_000_000,
    compress_out: bool = False,
    cmdline: str = "",
    version: str = __version__,
    collation_mode: str = "fast",
) -> None:
    input_dir = Path(input_dir)
    rad_dir = Path(rad_dir)
    mdata = check_version_compat(version, input_dir / "generate_permit_list.json")

    if mdata.get("multi_barcode"):
        from .collate_multi import collate_multi_bc

        return collate_multi_bc(
            input_dir, rad_dir, num_threads, max_records, compress_out,
            cmdline, version, mode=collation_mode,
        )

    if compress_out:
        from ..radz import snappyz  # noqa: F401  (raises if unsupported)

    # permit_freq.bin -> cells ordered by descending read count
    bclen, freq_bc, freq_ct = bincodeio.read_permit_freq(input_dir / "permit_freq.bin")
    del bclen
    order = np.lexsort((freq_bc, -freq_ct.astype(np.int64)))
    cell_bcs = freq_bc[order]
    cell_cts = freq_ct[order]
    total_to_collate = int(freq_ct.sum())

    expected_ori = mdata["expected_ori"]
    velo_mode = bool(mdata.get("velo_mode", False))

    # correction map
    map_keys, map_vals = bincodeio.read_u64_map_file(input_dir / "permit_map.bin")
    log.info("deserialized correction map of length: %d", len(map_keys))

    from ..parallel import dist

    # initialize (idempotent, no-op without a coordinator): a
    # standalone multi-host `collate` invocation must not silently run
    # as world=1 on every host — that would race N full collations
    # over the same output paths
    dist.initialize()
    rank, world = dist.rank_world()

    # unmapped counts (sidecars are rank-0 writes under multi-host)
    if rank == 0:
        bcs_u, cts_u = unmappedio.read_raw_unmapped(rad_dir / "unmapped_bc_count.bin")
        if len(bcs_u):
            hit, corr = _lookup_map(map_keys, map_vals, bcs_u)
            cb, inv = np.unique(corr[hit], return_inverse=True)
            agg = np.zeros(len(cb), np.uint64)
            np.add.at(agg, inv, cts_u[hit].astype(np.uint64))
            unmappedio.write_collated_single(
                input_dir / "unmapped_bc_count_collated.bin", cb, agg.astype(np.uint32)
            )
        else:
            unmappedio.write_collated_single(
                input_dir / "unmapped_bc_count_collated.bin",
                np.zeros(0, np.uint64), np.zeros(0, np.uint32),
            )

        write_json(input_dir / "collate.json", {
            "cmd": cmdline,
            "version_str": version,
            "compressed_output": compress_out,
        })

    # multi-host: every host scatters its chunk range into rank-local
    # spill buckets; the gather all-gathers per-bucket streams over DCN
    # and rank 0 writes the byte-identical collated file
    if world > 1:
        return _collate_out_of_core(
            input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals,
            expected_ori, velo_mode, max_records, compress_out,
            multihost=True,
        )

    # out-of-core path for datasets beyond the in-memory record bound
    # (the reference's --max-records scatter/gather, collate.rs:584-905)
    if total_to_collate > max_records:
        return _collate_out_of_core(
            input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals,
            expected_ori, velo_mode, max_records, compress_out,
        )

    # byte-level native path (no column decode / re-encode)
    if _collate_in_memory_native(
        input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals,
        expected_ori, velo_mode, compress_out,
    ):
        return

    # ingest the input RAD
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, _info = record_type_from_prelude(prelude, ftm)
        if rec_type == KnownRecordType.ATAC:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" sub-command'
            )
        schema = RecordSchema.from_prelude(prelude)
        batch = decode_all_chunks(fh, schema, prelude.hdr.num_chunks)
    log.info(
        "collating %d reads across %d chunks into %d cells",
        batch.n_reads, prelude.hdr.num_chunks, len(cell_bcs),
    )

    corrected, keep_read, keep_aln, new_offsets, _ = correct_and_filter(
        batch, map_keys, map_vals, expected_ori
    )

    # rank cells by the descending-count order: sorted-position ->
    # original (descending-count) index is argsort itself
    sort_perm = np.argsort(cell_bcs, kind="stable")
    cell_sorted = cell_bcs[sort_perm]
    hit2, _ = _lookup_map(cell_sorted, cell_sorted, corrected[keep_read])
    assert hit2.all(), "corrected barcode missing from permit list"
    rank = sort_perm[np.searchsorted(cell_sorted, corrected[keep_read])]

    # gather surviving reads into the final (cell-rank-sorted) order in
    # ONE pass: compose the keep-filter and the stable rank sort into a
    # single alignment gather index over the original columns
    kept_reads = np.flatnonzero(keep_read)
    dev = (
        collation_order_device(rank.astype(np.int64), len(cell_bcs))
        if collate_device_enabled() else None
    )
    sort_idx = dev[0] if dev is not None else np.argsort(rank, kind="stable")
    final_reads = kept_reads[sort_idx]
    rank_sorted = rank[sort_idx]
    read_cols = {k: v[final_reads] for k, v in batch.read_cols.items()}
    read_cols[batch.schema.barcode_fields[-1]] = corrected[final_reads]

    nal = np.diff(new_offsets)
    out_nal = nal[sort_idx]
    out_offsets = np.zeros(len(sort_idx) + 1, np.int64)
    np.cumsum(out_nal, out=out_offsets[1:])
    # positions of surviving alignments in the ORIGINAL flat aln arrays,
    # grouped per kept read (keep_aln order == kept_reads order)
    surv_pos = np.flatnonzero(keep_aln)
    src_starts = new_offsets[:-1][sort_idx]
    aln_gather = surv_pos[
        np.repeat(src_starts, out_nal) + (
            np.arange(int(out_offsets[-1]))
            - np.repeat(out_offsets[:-1], out_nal)
        )
    ]
    refs = batch.refs[aln_gather]
    dirs = batch.dirs[aln_gather]
    aln_cols = {k: v[aln_gather] for k, v in batch.aln_cols.items()}

    # per-cell read counts; the reference asserts these match permit_freq
    per_cell = np.zeros(len(cell_bcs), np.int64)
    u_rank, u_ct = np.unique(rank_sorted, return_counts=True)
    per_cell[u_rank] = u_ct
    if not np.array_equal(per_cell, cell_cts.astype(np.int64)):
        log.warning(
            "per-cell collated record counts differ from permit_freq counts "
            "(total %d vs %d)", int(per_cell.sum()), total_to_collate,
        )

    # write the collated file: same prelude, num_chunks = number of cells
    cfname = (
        "velo.map.collated.rad" if velo_mode
        else ("map.collated.rad.sz" if compress_out else "map.collated.rad")
    )
    out_path = input_dir / cfname
    import io

    sink: object
    if compress_out:
        from ..radz import snappyz

        raw = io.BytesIO()
        sink = raw
    else:
        sink = open(out_path, "wb")
    try:
        prelude.hdr.num_chunks = len(cell_bcs)
        prelude.write(sink)
        prelude.write_file_tag_values(sink, ftm)
        from ..radz.chunkio import write_cell_chunks

        n_written = write_cell_chunks(
            sink, schema, read_cols, out_offsets, refs, dirs, aln_cols, per_cell
        )
        if n_written != len(cell_bcs):
            # patch the header with the actual chunk count
            pos = sink.tell()
            sink.seek(1 + 8 + prelude.hdr.names_nbytes())
            sink.write(struct.pack("<Q", n_written))
            sink.seek(pos)
        if compress_out:
            from ..radz import snappyz

            with open(out_path, "wb") as out:
                snappyz.frame_compress_stream(raw.getvalue(), out)
    finally:
        if not compress_out:
            sink.close()
    log.info("finished collating input rad file; wrote %d cell chunks", n_written)
