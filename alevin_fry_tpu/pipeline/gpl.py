"""generate-permit-list (RNA).

Re-implements src/cellfilter.rs as batched array programs:

* the per-barcode read histogram is a sort + run-length count over the
  strand-compatible reads (the reference's DashMap histogram,
  cellfilter.rs:1283-1418);
* the unfiltered-list path matches whitelist membership via binary
  search and rescues unmatched barcodes that have a *unique* Hamming<=1
  neighbor among the kept barcodes (cellfilter.rs:105-333);
* the filtered paths (knee / force-cells / expect-cells / explicit
  list) select barcodes by frequency threshold and build the full
  1-edit (SNP+indel) correction map (cellfilter.rs:336-480).

Outputs the same artifact contract as the reference: permit_freq.bin,
all_freq.bin (filtered paths), permit_map.bin, generate_permit_list.json.

Determinism note: where the reference resolves contested 1-edit
neighbors by seeded-hash iteration order (utils.rs:1043-1048), we use an
explicit priority (descending read frequency, then ascending barcode) —
deterministic and documented; the unfiltered unique-neighbor rescue (the
bit-parity CI path) has no such ties.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import __version__
from ..ops import barcodes as bcops
from ..ops.knee import get_knee
from ..radz import bincodeio, read_prelude, record_type_from_prelude, KnownRecordType
from ..radz.chunkio import decode_all_chunks
from ..radz.records import RecordSchema
from ..utils import (
    STRAND_BOTH,
    STRAND_FW,
    STRAND_RC,
    read_barcode_file,
    read_strand_mask,
    strand_from_ori_arg,
    write_json,
)
from .logging_ import get_logger

log = get_logger("gpl")


@dataclass
class CellFilterMethod:
    """One of knee-distance / force-cells / expect-cells / explicit list /
    unfiltered external list (cellfilter.rs:51-71)."""

    kind: str  # "knee" | "force" | "expect" | "explicit" | "unfiltered"
    count: int = 0
    path: Optional[Path] = None
    min_reads: int = 10

    def describe(self) -> str:
        return {
            "knee": "KneeFinding",
            "force": f"ForceCells({self.count})",
            "expect": f"ExpectCells({self.count})",
            "explicit": f"ExplicitList({self.path})",
            "unfiltered": f"UnfilteredExternalList({self.path}, {self.min_reads})",
        }[self.kind]


@dataclass
class GenPermitListOpts:
    input_dir: Path
    output_dir: Path
    fmeth: CellFilterMethod
    expected_ori: str  # "fw" | "rc" | "both" | "either"
    threads: int = 8
    velo_mode: bool = False
    cmdline: str = ""
    version: str = __version__
    # multi-barcode (10x Flex) options
    sample_bc_list: Optional[Path] = None
    sample_names: Optional[Path] = None
    sample_correction_mode: str = "exact"  # "exact" | "1-edit"
    sample_bc_ori: str = "forward"  # "forward" | "reverse"


def _serialize_opts(opts: GenPermitListOpts) -> dict:
    d = {
        "input_dir": str(opts.input_dir),
        "output_dir": str(opts.output_dir),
        "fmeth": opts.fmeth.describe(),
        "expected_ori": opts.expected_ori,
        "velo_mode": opts.velo_mode,
        "threads": opts.threads,
        "cmdline": opts.cmdline,
        "version": opts.version,
        "sample_bc_list": str(opts.sample_bc_list) if opts.sample_bc_list else None,
        "sample_names": str(opts.sample_names) if opts.sample_names else None,
        "sample_correction_mode": opts.sample_correction_mode,
        "sample_bc_ori": opts.sample_bc_ori,
    }
    return d


GPL_BLOCK_RECORDS = int(
    __import__("os").environ.get("AFT_GPL_BLOCK_RECORDS", 20_000_000)
)


def _histogram(bcs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (barcode, count) histogram (native hash counting when
    available: O(n) instead of a full sort)."""
    if len(bcs) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    from ..radz import _native

    if _native.available() and len(bcs) > 16384:
        return _native.count_u64(bcs)
    uniq, counts = np.unique(bcs, return_counts=True)
    return uniq, counts.astype(np.uint64)


def gpl_mesh_from_env():
    """Device mesh for the barcode histogram.  ``AFT_GPL_MESH``
    overrides (``0``/``none`` → host; ``auto`` → all devices; integer →
    that many); unset = ``auto`` when jax's default backend is an
    accelerator.  Needs ≥ 2 devices — with one card the host histogram
    already saturates the decode stream, so the device path is the
    multi-card regime (cellfilter.rs:1762-1888 is the behavioral
    spec: DashMap histogram + thread-local unmatched lists → psum'd
    per-shard counts + host-side unmatched tail)."""
    import os

    spec = os.environ.get("AFT_GPL_MESH", "").strip().lower()
    if spec == "":
        from ..ops.crlike import accelerator_present

        spec = "auto" if accelerator_present() else "0"
    if spec in ("0", "none", "off"):
        return None
    import jax

    from ..parallel.mesh import make_mesh

    avail = len(jax.devices())
    want = avail if spec == "auto" else max(1, int(spec))
    n = min(want, avail)
    if n < 2:
        return None
    return make_mesh(n)


def _merge_histograms(a_bc, a_ct, b_bc, b_ct):
    """Merge two sorted histograms (sorted-merge + segment sum)."""
    if len(a_bc) == 0:
        return b_bc, b_ct
    if len(b_bc) == 0:
        return a_bc, a_ct
    bc = np.concatenate([a_bc, b_bc])
    ct = np.concatenate([a_ct, b_ct])
    order = np.argsort(bc, kind="stable")
    bc, ct = bc[order], ct[order]
    new = np.ones(len(bc), bool)
    new[1:] = bc[1:] != bc[:-1]
    starts = np.flatnonzero(new)
    out_ct = np.add.reduceat(ct, starts)
    return bc[starts], out_ct.astype(np.uint64)


def _iter_block_barcodes(fh, schema, num_chunks, strand, chunk_range=None):
    """Yield (barcodes[u64], strand_compat[bool], num_aln[int64]) per
    streamed block.  Native byte-level path extracts only the barcode
    column and the per-read orientation counts (no full field decode);
    falls back to the columnar decoder otherwise."""
    from ..radz import _native
    from ..radz.chunkio import (
        _gather_uint, iter_decoded_blocks, iter_raw_blocks,
    )

    if strand == STRAND_BOTH:
        ori_mode = 0
    elif strand == STRAND_FW:
        ori_mode = 1
    else:
        assert strand == STRAND_RC
        ori_mode = 2
    ref_width = (
        dict(schema.aln_fields).get(schema.ref_field)
        if schema.ref_field is not None
        else None
    )
    native_ok = _native.available() and (ori_mode == 0 or ref_width == 4)
    if native_ok:
        bc_name = schema.barcode_fields[-1]
        bc_off = 0
        bc_width = 0
        for name, w in schema.read_fields:
            if name == bc_name:
                bc_width = w
                break
            bc_off += w
        ref_off = 0
        for name, w in schema.aln_fields:
            if name == schema.ref_field:
                break
            ref_off += w
        for buf, region_starts, chunk_recs in iter_raw_blocks(
            fh, num_chunks, GPL_BLOCK_RECORDS, prefetch=True,
            chunk_range=chunk_range,
        ):
            rec_starts, num_aln = _native.walk_records(
                buf, region_starts, chunk_recs,
                schema.read_bytes, schema.aln_bytes,
            )
            bcs = _gather_uint(buf, rec_starts + 4 + bc_off, bc_width)
            if ori_mode == 0:
                compat = num_aln > 0
            else:
                kept = _native.ori_counts(
                    buf, rec_starts, num_aln,
                    schema.read_bytes, schema.aln_bytes, ref_off, ori_mode,
                )
                compat = kept > 0
            yield bcs, compat, num_aln
        return
    for block in iter_decoded_blocks(
        fh, schema, num_chunks, GPL_BLOCK_RECORDS, prefetch=True,
        chunk_range=chunk_range,
    ):
        compat = read_strand_mask(block.dirs, block.aln_offsets, strand)
        yield block.barcode(), compat, block.num_aln_per_read


def generate_permit_list(opts: GenPermitListOpts) -> int:
    """Run the stage; returns the number of distinct corrected barcodes
    (the reference's return contract, cellfilter.rs:487)."""
    i_dir = Path(opts.input_dir)
    rad_path = i_dir / "map.rad"
    with open(rad_path, "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, info = record_type_from_prelude(prelude, ftm)
        if rec_type == KnownRecordType.ATAC:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" sub-command'
            )
        if rec_type == KnownRecordType.RNA_MULTI_BC:
            from ..parallel import dist
            from ..radz.chunkio import iter_decoded_blocks
            from .gpl_multi import do_generate_permit_list_multi_bc

            dist.initialize()
            mb_rank, mb_world = dist.rank_world()
            mb_range = None
            if mb_world > 1:
                mb_range = dist.host_chunk_plan(
                    prelude.hdr.num_chunks, mb_world, mb_rank
                )
                log.info(
                    "multi-host multi-BC gpl: process %d/%d owns chunks "
                    "[%d, %d)", mb_rank, mb_world, mb_range[0], mb_range[1],
                )
            schema = RecordSchema.from_prelude(prelude)
            blocks = iter_decoded_blocks(
                fh, schema, prelude.hdr.num_chunks, GPL_BLOCK_RECORDS,
                prefetch=True, chunk_range=mb_range,
            )
            return do_generate_permit_list_multi_bc(
                opts, prelude, ftm, blocks, info
            )
        schema = RecordSchema.from_prelude(prelude)
        if prelude.hdr.num_chunks == 0:
            raise ValueError(
                "The RAD file appears to have no chunks; this most commonly "
                "occurs when no reads are mapped due to an incorrect chemistry"
            )
        log.info(
            "record type %s; ref_count %d; num_chunks %d",
            rec_type.value, prelude.hdr.ref_count, prelude.hdr.num_chunks,
        )

        # stream in bounded blocks and accumulate the histogram —
        # memory is bounded by distinct barcodes, not read count
        strand = strand_from_ori_arg(opts.expected_ori)

        # multi-host: each process histograms its own contiguous chunk
        # range; per-host histograms merge with a ragged all-gather
        # below (SURVEY §2.3 — DP over barcodes with a cross-host
        # reduction).  All ranks compute the final result identically;
        # only rank 0 writes the artifacts.
        from ..parallel import dist

        dist.initialize()
        rank, world = dist.rank_world()
        chunk_range = None
        if world > 1:
            chunk_range = dist.host_chunk_plan(
                prelude.hdr.num_chunks, world, rank
            )
            log.info(
                "multi-host gpl: process %d/%d owns chunks [%d, %d)",
                rank, world, chunk_range[0], chunk_range[1],
            )

        num_reads = 0
        num_compat = 0
        max_ambig = 0
        h_bc = np.zeros(0, np.uint64)
        h_ct = np.zeros(0, np.uint64)

        # multi-device regime: matched counts accumulate on the mesh
        # (psum'd sharded histogram); only the unmatched tail is
        # histogrammed on host for the 1-edit rescue
        gpl_mesh = None
        wl_dev = None
        wl_dev_counts = None
        if opts.fmeth.kind == "unfiltered" and world == 1:
            # (multi-host runs merge host-local histograms over the DCN
            # instead — per-host read streams differ, so a global-mesh
            # device_put of host-local arrays would be ill-defined)
            gpl_mesh = gpl_mesh_from_env()
            if gpl_mesh is not None:
                wl_pre, _wl_len = read_barcode_file(opts.fmeth.path)
                wl_dev = np.sort(np.unique(wl_pre))
                wl_dev_counts = np.zeros(len(wl_dev), np.int64)

        from .progress import stage_timer

        # file read of block k+1 overlaps the histogram of block k
        # (the reference's reader/worker split, cellfilter.rs:1775-1830;
        # decode stays on this thread — see chunkio)
        with stage_timer(log, "generate-permit-list histogram", "reads") as pb:
            for bcs, compat, nal in _iter_block_barcodes(
                fh, schema, prelude.hdr.num_chunks, strand,
                chunk_range=chunk_range,
            ):
                pb.update(len(bcs))
                num_reads += len(bcs)
                nc = int(compat.sum())
                num_compat += nc
                if nc:
                    max_ambig = max(max_ambig, int(nal[compat].max()))
                kept = bcs[compat] if nc < len(bcs) else bcs
                if wl_dev is not None and len(kept):
                    from ..parallel.mesh import sharded_histogram

                    cnt, _unm, hit = sharded_histogram(gpl_mesh, kept, wl_dev)
                    wl_dev_counts += np.asarray(cnt, np.int64)
                    kept = kept[~hit]
                    if len(kept) == 0:
                        continue
                b_bc, b_ct = _histogram(kept)
                h_bc, h_ct = _merge_histograms(h_bc, h_ct, b_bc, b_ct)

        if wl_dev is not None:
            nzwl = wl_dev_counts > 0
            h_bc, h_ct = _merge_histograms(
                h_bc, h_ct, wl_dev[nzwl], wl_dev_counts[nzwl].astype(np.uint64)
            )
    if world > 1:
        # merge per-host partial histograms + scalar stats over the DCN
        parts_bc = dist.allgather_ragged(h_bc)
        parts_ct = dist.allgather_ragged(h_ct)
        h_bc = np.zeros(0, np.uint64)
        h_ct = np.zeros(0, np.uint64)
        for part_bc, part_ct in zip(parts_bc, parts_ct):
            h_bc, h_ct = _merge_histograms(
                h_bc, h_ct, part_bc, part_ct.astype(np.uint64)
            )
        stats = np.stack(dist.allgather_ragged(np.asarray(
            [num_reads, num_compat, max_ambig], np.int64
        )))
        num_reads = int(stats[:, 0].sum())
        num_compat = int(stats[:, 1].sum())
        max_ambig = int(stats[:, 2].max())
    log.info(
        "observed %d reads (%d orientation consistent); max ambiguity %d refs",
        num_reads, num_compat, max_ambig,
    )

    bclen = int(ftm["cblen"])
    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    write_artifacts = rank == 0
    if opts.fmeth.kind == "unfiltered":
        return _process_unfiltered(
            opts, h_bc, h_ct, bclen, num_reads, max_ambig, out_dir,
            write_artifacts=write_artifacts,
        )
    return _process_filtered(
        opts, h_bc, h_ct, bclen, max_ambig, out_dir,
        write_artifacts=write_artifacts,
    )


# --- unfiltered external list (cellfilter.rs:105-333) -----------------------

def _process_unfiltered(
    opts: GenPermitListOpts,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    num_reads: int,
    max_ambig: int,
    out_dir: Path,
    write_artifacts: bool = True,
) -> int:
    wl, first_bclen = read_barcode_file(opts.fmeth.path)
    if first_bclen != bclen:
        log.warning(
            "provided permit list has barcodes of length %d but mapped reads "
            "have barcodes of length %d", first_bclen, bclen,
        )
    wl_sorted = np.sort(np.unique(wl))
    log.info("number of unfiltered bcs read = %d", len(wl_sorted))

    idx = np.searchsorted(wl_sorted, uniq)
    idx_c = np.minimum(idx, max(len(wl_sorted) - 1, 0))
    in_wl = (len(wl_sorted) > 0) & (idx < len(wl_sorted)) & (wl_sorted[idx_c] == uniq)

    matched_bc, matched_ct = uniq[in_wl], counts[in_wl]
    unmatched_bc, unmatched_ct = uniq[~in_wl], counts[~in_wl]
    num_unmatched_reads = int(unmatched_ct.sum())

    # diagnostic: warn if too many reads miss the permit list exactly
    # (diagnostics.rs:3-22, threshold 0.3)
    if num_reads > 0:
        frac = num_unmatched_reads / num_reads
        if frac >= 0.3:
            log.warning(
                "Percentage of mapped reads not matching a known barcode "
                "exactly (%.3f%%) is > the suggested fraction (30%%)", frac * 100,
            )
        else:
            log.info(
                "%.3f%% of mapped reads did not match a known barcode exactly "
                "(< 30%% warning threshold)", frac * 100,
            )

    # min_freq split: barcodes below threshold are recycled into the
    # unmatched pool for 1-edit rescue (cellfilter.rs:124-156)
    min_freq = int(opts.fmeth.min_reads)
    keep = matched_ct >= min_freq
    kept_bc = matched_bc[keep]
    kept_ct = matched_ct[keep].copy()
    below_bc, below_ct = matched_bc[~keep], matched_ct[~keep]
    log.info("num_passing = %d", len(kept_bc))

    rescue_bc = np.concatenate([unmatched_bc, below_bc])
    rescue_ct = np.concatenate([unmatched_ct, below_ct])
    order = np.argsort(rescue_bc, kind="stable")
    rescue_bc, rescue_ct = rescue_bc[order], rescue_ct[order]

    kept_sorted = kept_bc  # already sorted (np.unique order)
    ncounts, reps = bcops.find_neighbors(rescue_bc, kept_sorted, bclen)
    # unique single-mismatch neighbor that isn't the barcode itself
    rescued = (ncounts == 1) & (reps != rescue_bc)
    found_approx = int(rescue_ct[rescued].sum())
    ambig_approx = int(rescue_ct[ncounts > 1].sum())
    not_found = int(rescue_ct[ncounts == 0].sum())
    num_corrected = int(rescued.sum())
    log.info(
        "of %d distinct unmatched barcodes: %d recoverable; reads: %d rescued, "
        "%d ambiguous, %d not found",
        len(rescue_bc), num_corrected, found_approx, ambig_approx, not_found,
    )

    # add rescued counts to their kept neighbor
    if num_corrected:
        tgt = np.searchsorted(kept_sorted, reps[rescued])
        np.add.at(kept_ct, tgt, rescue_ct[rescued])

    if write_artifacts:
        bincodeio.write_permit_freq(
            out_dir / "permit_freq.bin", bclen, kept_bc, kept_ct
        )

        # correction map: kept -> itself, rescued -> unique neighbor
        map_keys = np.concatenate([kept_bc, rescue_bc[rescued]])
        map_vals = np.concatenate([kept_bc, reps[rescued]])
        bincodeio.write_u64_map_file(
            out_dir / "permit_map.bin", map_keys, map_vals
        )

        meta = {
            "velo_mode": opts.velo_mode,
            "expected_ori": strand_from_ori_arg(opts.expected_ori),
            "version_str": opts.version,
            "max-ambig-record": max_ambig,
            "cmd": opts.cmdline,
            "permit-list-type": "unfiltered",
            "gpl_options": _serialize_opts(opts),
        }
        write_json(out_dir / "generate_permit_list.json", meta)
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected


# --- filtered methods (cellfilter.rs:336-480) --------------------------------

def _process_filtered(
    opts: GenPermitListOpts,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    max_ambig: int,
    out_dir: Path,
    write_artifacts: bool = True,
) -> int:
    freq = np.sort(counts)[::-1]

    meth = opts.fmeth
    if meth.kind == "knee":
        num_bc = get_knee(freq, 100)
        min_freq = int(freq[num_bc])
        valid_mask = counts >= min_freq
        valid_bc = uniq[valid_mask]
        log.info(
            "knee distance method resulted in the selection of %d permitted "
            "barcodes.", len(valid_bc),
        )
    elif meth.kind == "force":
        top_k = meth.count
        num_bc = len(freq) - 1 if len(freq) < top_k else top_k - 1
        min_freq = int(freq[num_bc])
        valid_mask = counts >= min_freq
        valid_bc = uniq[valid_mask]
    elif meth.kind == "expect":
        robust_quantile = 0.99
        robust_div = 10.0
        robust_ind = int(round(meth.count * robust_quantile))
        ind = min(len(freq) - 1, robust_ind)
        robust_freq = int(freq[ind])
        min_freq = max(1, int(round(robust_freq / robust_div)))
        valid_mask = counts >= min_freq
        valid_bc = uniq[valid_mask]
    elif meth.kind == "explicit":
        valid_bc, _ = read_barcode_file(meth.path, bclen)
        valid_mask = None
    else:
        raise ValueError(f"unsupported filter method {meth.kind}")

    # priority order for contested 1-edit neighbors: for frequency-based
    # methods, higher-count barcodes first (ties: ascending barcode); for
    # an explicit list, file order (matching the reference's iteration
    # over the provided list).
    if meth.kind != "explicit":
        vc = counts[valid_mask]
        order = np.lexsort((valid_bc, -vc.astype(np.int64)))
        prio_bc = valid_bc[order]
    else:
        prio_bc = valid_bc

    map_keys, map_vals = bcops.generate_permitlist_map(prio_bc, bclen)

    # correct the histogram through the full permit map
    ms = np.argsort(map_keys, kind="stable")
    mk, mv = map_keys[ms], map_vals[ms]
    idx = np.searchsorted(mk, uniq)
    idx_c = np.minimum(idx, max(len(mk) - 1, 0))
    hit = (len(mk) > 0) & (idx < len(mk)) & (mk[idx_c] == uniq)
    num_corrected = int(hit.sum())
    corrected_to = mv[idx_c[hit]]
    perm_bc, inv = np.unique(corrected_to, return_inverse=True)
    perm_ct = np.zeros(len(perm_bc), np.uint64)
    np.add.at(perm_ct, inv, counts[hit])

    if write_artifacts:
        bincodeio.write_permit_freq(
            out_dir / "permit_freq.bin", bclen, perm_bc, perm_ct
        )
        bincodeio.write_permit_freq(out_dir / "all_freq.bin", bclen, uniq, counts)
        bincodeio.write_u64_map_file(
            out_dir / "permit_map.bin", map_keys, map_vals
        )

        meta = {
            "velo_mode": opts.velo_mode,
            "expected_ori": strand_from_ori_arg(opts.expected_ori),
            "version_str": opts.version,
            "max-ambig-record": max_ambig,
            "cmd": opts.cmdline,
            "permit-list-type": "filtered",
            "gpl_options": _serialize_opts(opts),
        }
        write_json(out_dir / "generate_permit_list.json", meta)
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected
