"""ctypes bindings for the native RAD codec (csrc/radc.cpp).

The only inherently sequential part of RAD decoding is walking the
variable-length record boundaries (each record's size depends on its
``num_aln`` field).  That walk runs here in C++; everything else is
vectorized NumPy / JAX.  The shared library is built from
``csrc/radc.cpp`` at first use (``ensure_built``); when the build
fails, the pure-NumPy paths run and the compiler's error is logged.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
from pathlib import Path

import numpy as np

log = logging.getLogger("aft.native")

_LIB = None
_TRIED = False


def _stamped_sha256(info: Path) -> str | None:
    """The ``source_sha256`` the Makefile stamped beside the binary."""
    if not info.exists():
        return None
    for line in info.read_text().splitlines():
        if line.startswith("source_sha256:"):
            return line.split(":", 1)[1].strip()
    return None


def ensure_built(csrc: Path) -> Path | None:
    """Build ``csrc/libradc.so`` from ``radc.cpp`` unless the binary
    there is stamped with the source's sha256.  Concurrent processes
    serialise on a lock file, so one builds and the rest load its
    result.  A failed build is logged with the compiler's output and
    returns None (the pure-NumPy paths then run).  ``AFT_RADC_NO_BUILD``
    skips the build."""
    so = csrc / "libradc.so"
    info = csrc / "libradc.buildinfo"
    src = csrc / "radc.cpp"
    if not src.exists():
        return so if so.exists() else None
    want = hashlib.sha256(src.read_bytes()).hexdigest()
    if so.exists() and _stamped_sha256(info) == want:
        return so
    if os.environ.get("AFT_RADC_NO_BUILD"):
        return so if so.exists() else None
    import fcntl
    import subprocess

    with open(csrc / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and _stamped_sha256(info) == want:
            return so
        try:
            proc = subprocess.run(
                ["make", "-B", "-C", str(csrc)],
                capture_output=True, text=True, timeout=900,
            )
        except (OSError, subprocess.TimeoutExpired) as exc:
            log.error("cannot build the native codec in %s: %s", csrc, exc)
            return None
        if proc.returncode != 0:
            log.error(
                "building the native codec failed (make -C %s, exit %d):\n%s",
                csrc, proc.returncode, (proc.stdout + proc.stderr)[-8000:],
            )
            return None
    return so


def _find_lib():
    env = os.environ.get("AFT_RADC_LIB")
    if env and os.path.exists(env):
        return env
    here = Path(__file__).resolve().parent.parent.parent
    so = ensure_built(here / "csrc")
    return str(so) if so is not None else None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.radc_walk_records.restype = ctypes.c_int64
        lib.radc_walk_records.argtypes = [
            ctypes.c_void_p,  # buf
            ctypes.c_int64,  # buf_len
            ctypes.c_void_p,  # region_starts (int64*)
            ctypes.c_void_p,  # region_counts (int64*)
            ctypes.c_int64,  # n_regions
            ctypes.c_int64,  # read_bytes
            ctypes.c_int64,  # aln_bytes
            ctypes.c_void_p,  # out rec_starts (int64*)
            ctypes.c_void_p,  # out num_aln   (int64*)
        ]
        lib.radc_walk_records_mt.restype = ctypes.c_int64
        lib.radc_walk_records_mt.argtypes = (
            lib.radc_walk_records.argtypes + [ctypes.c_int32]
        )
        lib.radc_format_triplets.restype = ctypes.c_int64
        lib.radc_format_triplets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_format_triplets_f32.restype = ctypes.c_int64
        lib.radc_format_triplets_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_em_cells.restype = ctypes.c_int64
        lib.radc_em_cells.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # ceo, lo
            ctypes.c_void_p, ctypes.c_void_p,  # labels, counts
            ctypes.c_int64, ctypes.c_int64,    # n_cells, R
            ctypes.c_int64, ctypes.c_int64,    # uoff, aoff
            ctypes.c_int32, ctypes.c_int32,    # init_uniform, last_round
            ctypes.c_int32,                    # n_threads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outs
        ]
        lib.radc_ori_counts.restype = ctypes.c_int64
        lib.radc_ori_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
            ctypes.c_void_p,                   # num_aln
            ctypes.c_int64, ctypes.c_int64,    # read_bytes, aln_bytes
            ctypes.c_int64, ctypes.c_int32,    # ref_off, ori_mode
            ctypes.c_void_p,                   # kept_out
        ]
        lib.radc_collate_emit.restype = ctypes.c_int64
        lib.radc_collate_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_void_p,  # rec_starts, num_aln
            ctypes.c_void_p,                   # corrected_bc
            ctypes.c_void_p, ctypes.c_int64,   # order, n_out
            ctypes.c_int64, ctypes.c_int64,    # read_bytes, aln_bytes
            ctypes.c_int64, ctypes.c_int64,    # bc_off, bc_width
            ctypes.c_int64, ctypes.c_int32,    # ref_off, ori_mode
            ctypes.c_void_p, ctypes.c_int64,   # chunk_counts, n_chunks
            ctypes.c_void_p, ctypes.c_int64,   # out, out_cap
        ]
        lib.radc_format_f32.restype = ctypes.c_int64
        lib.radc_format_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_scan_names.restype = ctypes.c_int64
        lib.radc_scan_names.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_int64, ctypes.c_void_p,   # count, starts_out
        ]
        lib.radc_counting_sort.restype = None
        lib.radc_counting_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # keys, n
            ctypes.c_int64,                    # n_keys
            ctypes.c_void_p, ctypes.c_void_p,  # order_out, counts_out
        ]
        lib.radc_gather_uint.restype = ctypes.c_int64
        lib.radc_gather_uint.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # starts, n
            ctypes.c_int64, ctypes.c_void_p,   # width, out
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_sort_u64_segments.restype = None
        lib.radc_sort_u64_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # keys, seg_offsets
            ctypes.c_int64, ctypes.c_int32,    # n_segs, n_threads
        ]
        lib.radc_sort_rle_u64_segments.restype = None
        lib.radc_sort_rle_u64_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # keys, seg_offsets
            ctypes.c_int64,                    # n_segs
            ctypes.c_void_p, ctypes.c_void_p,  # uniq_out, cnt_out
            ctypes.c_void_p, ctypes.c_void_p,  # range_starts, range_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_sort2_rle_unpack.restype = ctypes.c_int64
        lib.radc_sort2_rle_unpack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # w0, w1
            ctypes.c_int64,                    # n
            ctypes.c_void_p, ctypes.c_void_p,  # word_idx, shifts
            ctypes.c_void_p, ctypes.c_int32,   # widths, n_cols
            ctypes.c_void_p, ctypes.c_void_p,  # out_cols, cnt_out
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_crlike_wta_unique.restype = None
        lib.radc_crlike_wta_unique.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # cell_ids, cell_read_offsets
            ctypes.c_int64,                    # n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, refs(u32)
            ctypes.c_void_p, ctypes.c_void_p,  # umi(u64), tid_to_gid(u32)
            ctypes.c_int64, ctypes.c_int64,    # n_rows, gbits
            ctypes.c_int32, ctypes.c_int64,    # usa_mode, unspliced_off
            ctypes.c_int64,                    # ambig_off
            ctypes.c_void_p, ctypes.c_void_p,  # out_key, out_cnt
            ctypes.c_void_p, ctypes.c_void_p,  # range_starts, range_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_pug_resolve.restype = ctypes.c_int64
        lib.radc_pug_resolve.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # cell_read_offsets, n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # umi(u64), refs(u32)
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, tid_to_gid
            ctypes.c_int32, ctypes.c_int32,    # gene_level, exact
            ctypes.c_int64,                    # large_thresh
            ctypes.c_void_p, ctypes.c_void_p,  # n_eqc_per_cell, used_alt
            ctypes.c_void_p, ctypes.c_void_p,  # counts_out, lens_out
            ctypes.c_void_p,                   # labels_out
            ctypes.c_void_p, ctypes.c_void_p,  # range_info, label_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_count_u64.restype = ctypes.c_int64
        lib.radc_count_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # keys, n, cap
            ctypes.c_void_p, ctypes.c_void_p,  # uniq_out, cnt_out
        ]
        lib.radc_collate_emit2.restype = ctypes.c_int64
        lib.radc_collate_emit2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_void_p,  # rec_starts, num_aln
            ctypes.c_void_p,                   # corrected_bc
            ctypes.c_void_p, ctypes.c_void_p,  # order, order_offsets
            ctypes.c_void_p, ctypes.c_int64,   # out_offsets, n_chunks
            ctypes.c_int64, ctypes.c_int64,    # read_bytes, aln_bytes
            ctypes.c_int64, ctypes.c_int64,    # bc_off, bc_width
            ctypes.c_int64, ctypes.c_int32,    # ref_off, ori_mode
            ctypes.c_void_p, ctypes.c_int64,   # out, out_cap
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_extract_fields2.restype = ctypes.c_int64
        lib.radc_extract_fields2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
            ctypes.c_void_p, ctypes.c_void_p,  # num_aln, aln_offs
            ctypes.c_void_p, ctypes.c_int64,   # read_widths, n
            ctypes.c_void_p, ctypes.c_int64,   # aln_widths, n
            ctypes.c_void_p, ctypes.c_void_p,  # read_cols**, aln_cols**
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_lookup_u64.restype = ctypes.c_int64
        lib.radc_lookup_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # keys, vals, n
            ctypes.c_void_p, ctypes.c_int64,   # queries, n_q
            ctypes.c_void_p, ctypes.c_void_p,  # hit_out, val_out
        ]
        lib.radc_find_neighbors.restype = None
        lib.radc_find_neighbors.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # queries, n_q
            ctypes.c_void_p, ctypes.c_int64,   # kept, n_k
            ctypes.c_int64,                    # bc_len
            ctypes.c_void_p, ctypes.c_void_p,  # counts_out, rep_out
        ]
        lib.radc_format_bed.restype = ctypes.c_int64
        lib.radc_format_bed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # name_bytes, name_offs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # chrs, starts, ends
            ctypes.c_void_p, ctypes.c_int64,   # bcs, bc_len
            ctypes.c_void_p, ctypes.c_int64,   # counts, n
            ctypes.c_void_p, ctypes.c_int32,   # out, n_threads
        ]
        lib.radc_pug_graph_build.restype = ctypes.c_void_p
        lib.radc_pug_graph_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # cell_read_offsets, n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # umi, refs
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, tid_to_gid
            ctypes.c_int32, ctypes.c_int32,    # gene_level, exact
            ctypes.c_void_p, ctypes.c_void_p,  # n_nodes, sym_entries
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_pug_graph_export.restype = None
        lib.radc_pug_graph_export.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.radc_pug_cover.restype = ctypes.c_int64
        lib.radc_pug_cover.argtypes = [
            ctypes.c_void_p,                   # handle
            ctypes.c_void_p, ctypes.c_int64,   # cell_read_offsets, n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, tid_to_gid
            ctypes.c_int32, ctypes.c_int64,    # gene_level, large_thresh
            ctypes.c_void_p,                   # comp_labels
            ctypes.c_void_p, ctypes.c_void_p,  # n_eqc, used_alt
            ctypes.c_void_p, ctypes.c_void_p,  # counts_out, lens_out
            ctypes.c_void_p,                   # labels_out
            ctypes.c_void_p, ctypes.c_void_p,  # range_info, label_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_pug_free.restype = None
        lib.radc_pug_free.argtypes = [ctypes.c_void_p]
        lib.radc_gather_records.restype = None
        lib.radc_gather_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.radc_bam_scan.restype = ctypes.c_int64
        lib.radc_bam_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.radc_bgzf_inflate.restype = ctypes.c_int64
        lib.radc_bgzf_inflate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.radc_intern_label_sets.restype = ctypes.c_int64
        lib.radc_intern_label_sets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.radc_format_eqc_rows.restype = ctypes.c_int64
        lib.radc_format_eqc_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_crc32c.restype = ctypes.c_uint32
        lib.radc_crc32c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ]
        lib.radc_snappy_max_compressed.restype = ctypes.c_int64
        lib.radc_snappy_max_compressed.argtypes = [ctypes.c_int64]
        lib.radc_snappy_compress.restype = ctypes.c_int64
        lib.radc_snappy_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_snappy_uncompress.restype = ctypes.c_int64
        lib.radc_snappy_uncompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        for name in ("radc_extract_fields", "radc_encode_records"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # buf, len
                ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
                ctypes.c_void_p,                   # num_aln
                ctypes.c_void_p, ctypes.c_int64,   # read_widths, n
                ctypes.c_void_p, ctypes.c_int64,   # aln_widths, n
                ctypes.c_void_p, ctypes.c_void_p,  # read_cols**, aln_cols**
            ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def walk_records(
    buf: np.ndarray,
    region_starts: np.ndarray,
    region_counts: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
):
    lib = _load()
    total = int(region_counts.sum())
    rec_starts = np.empty(total, np.int64)
    num_aln = np.empty(total, np.int64)
    buf = np.ascontiguousarray(buf)
    region_starts = np.ascontiguousarray(region_starts, np.int64)
    region_counts = np.ascontiguousarray(region_counts, np.int64)
    rc = lib.radc_walk_records_mt(
        buf.ctypes.data, buf.nbytes,
        region_starts.ctypes.data, region_counts.ctypes.data,
        len(region_starts), read_bytes, aln_bytes,
        rec_starts.ctypes.data, num_aln.ctypes.data, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("record walk overran the buffer (corrupt RAD chunk?)")
    return rec_starts, num_aln


def _col_ptrs(cols):
    arr = (ctypes.c_void_p * len(cols))()
    for i, c in enumerate(cols):
        arr[i] = c.ctypes.data if c is not None else None
    return arr


def extract_fields(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_widths,
    aln_widths,
):
    """One-pass extraction of all record fields into u64 columns.
    Returns (read_cols list, aln_cols list)."""
    lib = _load()
    n = len(rec_starts)
    total_aln = int(num_aln.sum())
    read_cols = [np.empty(n, np.uint64) for _ in read_widths]
    aln_cols = [np.empty(total_aln, np.uint64) for _ in aln_widths]
    rw = np.asarray(read_widths, np.int64)
    aw = np.asarray(aln_widths, np.int64)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    rc = lib.radc_extract_fields(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, n, num_aln.ctypes.data,
        rw.ctypes.data, len(rw), aw.ctypes.data, len(aw),
        _col_ptrs(read_cols), _col_ptrs(aln_cols),
    )
    if rc < 0:
        raise ValueError("field extraction overran the buffer")
    return read_cols, aln_cols


def ori_counts(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
    ref_off: int,
    ori_mode: int,
) -> np.ndarray:
    """Per-record surviving-alignment counts under the orientation
    filter (ori_mode 1=fw, 2=rc)."""
    lib = _load()
    n = len(rec_starts)
    kept = np.empty(n, np.int64)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    rc = lib.radc_ori_counts(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, n, num_aln.ctypes.data,
        read_bytes, aln_bytes, ref_off, ori_mode,
        kept.ctypes.data,
    )
    if rc < 0:
        raise ValueError("orientation scan overran the buffer")
    return kept


def collate_emit(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    corrected_bc: np.ndarray,
    order: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
    bc_off: int,
    bc_width: int,
    ref_off: int,
    ori_mode: int,
    chunk_counts: np.ndarray,
    out_cap: int,
) -> np.ndarray:
    """Byte-level collated emit (records gathered in `order`, barcode
    patched, orientation-filtered, chunk-framed).  Returns the output
    byte buffer."""
    lib = _load()
    out = np.empty(out_cap, np.uint8)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    corrected_bc = np.ascontiguousarray(corrected_bc, np.uint64)
    order = np.ascontiguousarray(order, np.int64)
    chunk_counts = np.ascontiguousarray(chunk_counts, np.int64)
    n = lib.radc_collate_emit(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, num_aln.ctypes.data,
        corrected_bc.ctypes.data,
        order.ctypes.data, len(order),
        read_bytes, aln_bytes, bc_off, bc_width, ref_off, ori_mode,
        chunk_counts.ctypes.data, len(chunk_counts),
        out.ctypes.data, out_cap,
    )
    if n < 0:
        raise ValueError("collate emit overran a buffer")
    return out[:n]


def find_neighbors(queries: np.ndarray, kept_sorted: np.ndarray, bc_len: int):
    """Native Hamming<=1 neighbor search (binary search per variant).
    Returns (counts[int64], representative[uint64])."""
    lib = _load()
    queries = np.ascontiguousarray(queries, np.uint64)
    kept_sorted = np.ascontiguousarray(kept_sorted, np.uint64)
    counts = np.empty(len(queries), np.int64)
    rep = np.empty(len(queries), np.uint64)
    lib.radc_find_neighbors(
        queries.ctypes.data, len(queries),
        kept_sorted.ctypes.data, len(kept_sorted), bc_len,
        counts.ctypes.data, rep.ctypes.data,
    )
    return counts, rep


_NTHREADS = max(1, min(8, os.cpu_count() or 1))


def set_threads(n: int) -> None:
    """Set the native kernel thread count (the CLI's -t/--threads; the
    reference caps collate/sort at 16 and gpl at 8, main.rs:49-52 —
    callers pass their already-capped value)."""
    global _NTHREADS
    _NTHREADS = max(1, min(int(n), 64))


def gather_uint(buf: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Gather little-endian uints of ``width`` bytes at ``starts``."""
    lib = _load()
    buf = np.ascontiguousarray(buf)
    starts = np.ascontiguousarray(starts, np.int64)
    out = np.empty(len(starts), np.uint64)
    rc = lib.radc_gather_uint(
        buf.ctypes.data, buf.nbytes, starts.ctypes.data, len(starts),
        width, out.ctypes.data, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("gather_uint out of bounds")
    return out


def sort_u64_segments(keys: np.ndarray, seg_offsets: np.ndarray) -> np.ndarray:
    """Sort u64 `keys` in place within each [seg_offsets[i], seg_offsets[i+1])
    segment (threaded).  Returns `keys`."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    lib.radc_sort_u64_segments(
        keys.ctypes.data, seg_offsets.ctypes.data,
        len(seg_offsets) - 1, _NTHREADS,
    )
    return keys


def sort_rle_u64_segments(keys: np.ndarray, seg_offsets: np.ndarray):
    """Fused per-segment sort + run-length encode (threaded).
    Returns (uniq[u64], counts[int64]) over all segments in order.
    ``keys`` is sorted in place as a side effect."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    n = len(keys)
    uniq = np.empty(n, np.uint64)
    cnt = np.empty(n, np.int64)
    rstarts = np.zeros(_NTHREADS, np.int64)
    rcounts = np.zeros(_NTHREADS, np.int64)
    lib.radc_sort_rle_u64_segments(
        keys.ctypes.data, seg_offsets.ctypes.data, len(seg_offsets) - 1,
        uniq.ctypes.data, cnt.ctypes.data,
        rstarts.ctypes.data, rcounts.ctypes.data, _NTHREADS,
    )
    if _NTHREADS == 1 or rcounts[1:].sum() == 0:
        k = int(rcounts[0])
        return uniq[:k], cnt[:k]
    pieces_u = []
    pieces_c = []
    for t in range(_NTHREADS):
        s, c = int(rstarts[t]), int(rcounts[t])
        if c:
            pieces_u.append(uniq[s : s + c])
            pieces_c.append(cnt[s : s + c])
    return np.concatenate(pieces_u), np.concatenate(pieces_c)


def sort2_rle_unpack(
    w0: np.ndarray, w1: np.ndarray,
    word_idx: np.ndarray, shifts: np.ndarray, widths: np.ndarray,
):
    """Fused global 2-word lexicographic sort + RLE + column unpack
    (csrc::radc_sort2_rle_unpack).  Returns (cols[list of int64],
    counts[int64]) over the distinct rows in sorted order."""
    lib = _load()
    w0 = np.ascontiguousarray(w0, np.uint64)
    w1 = np.ascontiguousarray(w1, np.uint64)
    word_idx = np.ascontiguousarray(word_idx, np.int32)
    shifts = np.ascontiguousarray(shifts, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    n = len(w0)
    n_cols = len(word_idx)
    out = np.empty(n_cols * max(n, 1), np.int64)
    cnt = np.empty(max(n, 1), np.int64)
    k = int(lib.radc_sort2_rle_unpack(
        w0.ctypes.data, w1.ctypes.data, n,
        word_idx.ctypes.data, shifts.ctypes.data, widths.ctypes.data,
        n_cols, out.ctypes.data, cnt.ctypes.data, _NTHREADS,
    ))
    cols = [out[c * n : c * n + k].copy() for c in range(n_cols)]
    return cols, cnt[:k].copy()


def crlike_wta_unique(
    cell_ids: np.ndarray,
    cell_read_offsets: np.ndarray,
    aln_offsets: np.ndarray,
    refs: np.ndarray,
    umi: np.ndarray,
    tid_to_gid: np.ndarray,
    n_rows: int,
    gbits: int,
    usa_mode: bool = False,
    unspliced_off: int = 0,
    ambig_off: int = 0,
):
    """Threaded native cr-like WTA resolution.  Non-USA: the
    gene-unique rule; USA: tie-set slotting into the S/U/A blocks.
    Returns (key[u64] = cell*n_rows+slot ascending, counts[int64])."""
    lib = _load()
    cell_ids = np.ascontiguousarray(cell_ids, np.int64)
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    refs = np.ascontiguousarray(refs, np.uint32)
    umi = np.ascontiguousarray(umi, np.uint64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    n_reads = int(cell_read_offsets[-1]) if len(cell_read_offsets) else 0
    out_key = np.empty(max(n_reads, 1), np.uint64)
    out_cnt = np.empty(max(n_reads, 1), np.int64)
    rstarts = np.zeros(_NTHREADS, np.int64)
    rcounts = np.zeros(_NTHREADS, np.int64)
    lib.radc_crlike_wta_unique(
        cell_ids.ctypes.data, cell_read_offsets.ctypes.data,
        len(cell_ids),
        aln_offsets.ctypes.data, refs.ctypes.data,
        umi.ctypes.data, tid_to_gid.ctypes.data,
        n_rows, gbits,
        1 if usa_mode else 0, unspliced_off, ambig_off,
        out_key.ctypes.data, out_cnt.ctypes.data,
        rstarts.ctypes.data, rcounts.ctypes.data, _NTHREADS,
    )
    pieces_k = []
    pieces_c = []
    for t in range(_NTHREADS):
        s, c = int(rstarts[t]), int(rcounts[t])
        if c:
            pieces_k.append(out_key[s : s + c])
            pieces_c.append(out_cnt[s : s + c])
    if not pieces_k:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.concatenate(pieces_k), np.concatenate(pieces_c)


def pug_resolve(
    cell_read_offsets: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    gene_level: bool,
    exact: bool,
    large_thresh: int,
):
    """Threaded batch PUG resolution (ops/pug.py semantics).

    Returns (n_eqc_per_cell[int64], used_alt[bool], counts[int64],
    label_lens[int64], labels[uint32]) with eqclasses concatenated in
    cell order, each cell's classes ordered by (label len, label bytes).
    """
    lib = _load()
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    umi = np.ascontiguousarray(umi, np.uint64)
    refs = np.ascontiguousarray(refs, np.uint32)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    n_cells = len(cell_read_offsets) - 1
    n_reads = int(cell_read_offsets[-1]) if n_cells >= 0 else 0
    n_aln = int(aln_offsets[-1]) if len(aln_offsets) else 0
    n_eqc = np.zeros(max(n_cells, 1), np.int64)
    used_alt = np.zeros(max(n_cells, 1), np.uint8)
    counts = np.empty(max(n_reads, 1), np.int64)
    lens = np.empty(max(n_reads, 1), np.int64)
    labels = np.empty(max(n_aln, 1), np.uint32)
    range_info = np.zeros((_NTHREADS, 4), np.int64)
    label_counts = np.zeros(_NTHREADS, np.int64)
    lib.radc_pug_resolve(
        cell_read_offsets.ctypes.data, n_cells,
        umi.ctypes.data, refs.ctypes.data,
        aln_offsets.ctypes.data, tid_to_gid.ctypes.data,
        1 if gene_level else 0, 1 if exact else 0, large_thresh,
        n_eqc.ctypes.data, used_alt.ctypes.data,
        counts.ctypes.data, lens.ctypes.data, labels.ctypes.data,
        range_info.ctypes.data, label_counts.ctypes.data, _NTHREADS,
    )
    pieces_c, pieces_l, pieces_lab = [], [], []
    for t in range(_NTHREADS):
        c0, rb, lb, ne = (int(x) for x in range_info[t])
        lc = int(label_counts[t])
        if ne:
            pieces_c.append(counts[rb : rb + ne])
            pieces_l.append(lens[rb : rb + ne])
        if lc:
            pieces_lab.append(labels[lb : lb + lc])
    cat = lambda ps, dt: (
        np.concatenate(ps) if ps else np.zeros(0, dt)
    )
    return (
        n_eqc[:n_cells],
        used_alt[:n_cells].view(bool),
        cat(pieces_c, np.int64),
        cat(pieces_l, np.int64),
        cat(pieces_lab, np.uint32),
    )


def count_u64(keys: np.ndarray, cap_hint: int = 0):
    """Hash-based distinct counting.  Returns (uniq sorted, counts)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    cap = int(cap_hint) if cap_hint else n
    cap = max(cap, 1)
    uniq = np.empty(cap, np.uint64)
    cnt = np.empty(cap, np.uint64)
    k = lib.radc_count_u64(keys.ctypes.data, n, cap, uniq.ctypes.data,
                           cnt.ctypes.data)
    uniq, cnt = uniq[:k], cnt[:k]
    order = np.argsort(uniq)
    return uniq[order], cnt[order]


def collate_emit2(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    corrected_bc: np.ndarray,
    order: np.ndarray,
    order_offsets: np.ndarray,
    out_offsets: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
    bc_off: int,
    bc_width: int,
    ref_off: int,
    ori_mode: int,
) -> np.ndarray:
    """Threaded byte-level collated emit over precomputed per-chunk
    record ranges and output offsets.  Returns the output byte buffer."""
    lib = _load()
    out_cap = int(out_offsets[-1])
    out = np.empty(out_cap, np.uint8)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    corrected_bc = np.ascontiguousarray(corrected_bc, np.uint64)
    order = np.ascontiguousarray(order, np.int64)
    order_offsets = np.ascontiguousarray(order_offsets, np.int64)
    out_offsets = np.ascontiguousarray(out_offsets, np.int64)
    rc = lib.radc_collate_emit2(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, num_aln.ctypes.data,
        corrected_bc.ctypes.data,
        order.ctypes.data, order_offsets.ctypes.data,
        out_offsets.ctypes.data, len(order_offsets) - 1,
        read_bytes, aln_bytes, bc_off, bc_width, ref_off, ori_mode,
        out.ctypes.data, out_cap, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("collate emit overran a buffer or sizes mismatched")
    return out


def extract_fields2(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_widths,
    aln_widths,
    read_keep=None,
    aln_keep=None,
):
    """Threaded one-pass extraction of record fields into u64 columns.
    ``read_keep``/``aln_keep`` are optional per-field booleans; skipped
    fields come back as None (no memory traffic spent on them).
    Returns (read_cols list, aln_cols list)."""
    lib = _load()
    n = len(rec_starts)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    aln_offs = np.zeros(n + 1, np.int64)
    np.cumsum(num_aln, out=aln_offs[1:])
    total_aln = int(aln_offs[-1])
    if read_keep is None:
        read_keep = [True] * len(read_widths)
    if aln_keep is None:
        aln_keep = [True] * len(aln_widths)
    read_cols = [np.empty(n, np.uint64) if k else None for k in read_keep]
    aln_cols = [np.empty(total_aln, np.uint64) if k else None for k in aln_keep]
    rw = np.asarray(read_widths, np.int64)
    aw = np.asarray(aln_widths, np.int64)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    rc = lib.radc_extract_fields2(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, n, num_aln.ctypes.data, aln_offs.ctypes.data,
        rw.ctypes.data, len(rw), aw.ctypes.data, len(aw),
        _col_ptrs(read_cols), _col_ptrs(aln_cols), _NTHREADS,
    )
    if rc < 0:
        raise ValueError("field extraction overran the buffer")
    return read_cols, aln_cols


def lookup_u64(keys: np.ndarray, vals: np.ndarray, queries: np.ndarray):
    """Batched u64 hash-map lookup.  Returns (hit[bool], mapped[u64])."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    vals = np.ascontiguousarray(vals, np.uint64)
    queries = np.ascontiguousarray(queries, np.uint64)
    hit = np.empty(len(queries), np.uint8)
    out = np.empty(len(queries), np.uint64)
    lib.radc_lookup_u64(
        keys.ctypes.data, vals.ctypes.data, len(keys),
        queries.ctypes.data, len(queries),
        hit.ctypes.data, out.ctypes.data,
    )
    return hit.view(bool), out


def format_f32(vals: np.ndarray) -> list:
    """Format f32 values Rust-Display-style (shortest round-trip,
    positional). Returns a list of str, one per value."""
    lib = _load()
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(vals)
    if n == 0:
        return []
    out = np.empty(n * 64, np.uint8)
    ln = lib.radc_format_f32(vals.ctypes.data, n, out.ctypes.data)
    return out[: ln - 1].tobytes().decode().split("\n")


def scan_names(buf: np.ndarray, count: int):
    """Scan a [len:u16|utf8]*count name region.  Returns
    (region_nbytes, starts[int64 count+1]) or (-1, starts) when the
    buffer ends mid-region (read more and retry)."""
    lib = _load()
    starts = np.empty(count + 1, np.int64)
    n = lib.radc_scan_names(
        buf.ctypes.data, len(buf), count, starts.ctypes.data
    )
    return int(n), starts


def counting_sort(keys: np.ndarray, n_keys: int):
    """Stable counting sort for small-domain int keys.
    Returns (order[int64], counts[int64])."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.int64)
    order = np.empty(len(keys), np.int64)
    counts = np.empty(n_keys, np.int64)
    lib.radc_counting_sort(
        keys.ctypes.data, len(keys), n_keys,
        order.ctypes.data, counts.ctypes.data,
    )
    return order, counts


def format_triplets(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format integer COO triplets as 'r c v\\n' lines natively."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(rows)
    out = np.empty(max(n, 1) * 62, np.uint8)
    ln = lib.radc_format_triplets(
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, n,
        out.ctypes.data,
    )
    return out[:ln].tobytes()


def format_triplets_f32(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> bytes:
    """Format float COO triplets as 'r c v\\n' lines natively: exact-
    int64 values print as integers, the rest Rust-Display-f32 —
    byte-identical to the Python fallback (radz/mtx.py)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(rows)
    out = np.empty(max(n, 1) * 105, np.uint8)
    ln = lib.radc_format_triplets_f32(
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, n,
        out.ctypes.data,
    )
    return out[:ln].tobytes()


def em_cells(
    cell_eq_offsets: np.ndarray,
    label_offsets: np.ndarray,
    labels: np.ndarray,
    counts: np.ndarray,
    num_rows: int,
    usa_offsets,
    init_uniform: bool,
    with_last_round: bool,
    n_threads: int,
):
    """Threaded native batched per-cell EM — bit-identical to
    ops/em.py::em_optimize_cell_np (same f32 accumulation order).
    Returns (nnz_per_cell[int64], idx[int64], val[f32]) where cell
    ci's nonzeros live at [label_offsets[cell_eq_offsets[ci]] ...] —
    the caller slices per cell."""
    lib = _load()
    ceo = np.ascontiguousarray(cell_eq_offsets, np.int64)
    lo = np.ascontiguousarray(label_offsets, np.int64)
    lab = np.ascontiguousarray(labels, np.uint32)
    cts = np.ascontiguousarray(counts, np.uint32)
    # the C++ kernel indexes dense R-wide scratch with these ids; an
    # out-of-range label would corrupt memory where the NumPy path
    # would raise — validate once up front (vectorized, negligible)
    if len(lab) and int(lab.max()) >= num_rows:
        raise ValueError(
            f"label id {int(lab.max())} >= num_rows {num_rows}"
        )
    n_cells = len(ceo) - 1
    uoff, aoff = usa_offsets if usa_offsets is not None else (-1, -1)
    cap = int(lo[-1])
    out_nnz = np.zeros(max(n_cells, 1), np.int64)
    out_idx = np.empty(max(cap, 1), np.int64)
    out_val = np.empty(max(cap, 1), np.float32)
    lib.radc_em_cells(
        ceo.ctypes.data, lo.ctypes.data, lab.ctypes.data, cts.ctypes.data,
        n_cells, num_rows, uoff, aoff,
        1 if init_uniform else 0, 1 if with_last_round else 0,
        int(n_threads),
        out_nnz.ctypes.data, out_idx.ctypes.data, out_val.ctypes.data,
    )
    return out_nnz, out_idx, out_val


def encode_records_native(
    out_buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_widths,
    aln_widths,
    read_cols,
    aln_cols,
) -> None:
    lib = _load()
    rw = np.asarray(read_widths, np.int64)
    aw = np.asarray(aln_widths, np.int64)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    read_cols = [np.ascontiguousarray(c, np.uint64) for c in read_cols]
    aln_cols = [np.ascontiguousarray(c, np.uint64) for c in aln_cols]
    rc = lib.radc_encode_records(
        out_buf.ctypes.data, out_buf.nbytes,
        rec_starts.ctypes.data, len(rec_starts), num_aln.ctypes.data,
        rw.ctypes.data, len(rw), aw.ctypes.data, len(aw),
        _col_ptrs(read_cols), _col_ptrs(aln_cols),
    )
    if rc < 0:
        raise ValueError("record encoding overran the buffer")


def crc32c(data, init: int = 0) -> int:
    lib = _load()
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    arr = np.ascontiguousarray(arr, np.uint8)
    return int(lib.radc_crc32c(arr.ctypes.data, arr.nbytes, init))


def snappy_compress(data) -> bytes:
    """Compress one snappy block (callers frame <=64KiB chunks)."""
    lib = _load()
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    arr = np.ascontiguousarray(arr, np.uint8)
    out = np.empty(int(lib.radc_snappy_max_compressed(arr.nbytes)), np.uint8)
    n = lib.radc_snappy_compress(arr.ctypes.data, arr.nbytes, out.ctypes.data)
    return out[:n].tobytes()


def snappy_uncompress(data, max_out: int) -> bytes:
    lib = _load()
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    arr = np.ascontiguousarray(arr, np.uint8)
    out = np.empty(max_out, np.uint8)
    n = lib.radc_snappy_uncompress(arr.ctypes.data, arr.nbytes, out.ctypes.data, max_out)
    if n < 0:
        raise ValueError("malformed snappy block")
    return out[:n].tobytes()


def format_bed(
    ref_names, chrs, starts, ends, bcs, bc_len: int, counts, n_threads: int = 1
) -> bytes:
    """Render BED rows natively; ref_names is a sequence of str."""
    lib = _load()
    name_bytes = b"".join(s.encode() for s in ref_names)
    name_offs = np.zeros(len(ref_names) + 1, np.int64)
    np.cumsum([len(s.encode()) for s in ref_names], out=name_offs[1:])
    nb = np.frombuffer(name_bytes, np.uint8) if name_bytes else np.zeros(1, np.uint8)
    chrs = np.ascontiguousarray(chrs, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    bcs = np.ascontiguousarray(bcs, np.uint64)
    counts = np.ascontiguousarray(counts, np.int64)
    n = len(chrs)
    max_name = int((name_offs[1:] - name_offs[:-1]).max()) if len(ref_names) else 0
    out = np.empty(n * (max_name + bc_len + 65), np.uint8)
    w = lib.radc_format_bed(
        nb.ctypes.data, name_offs.ctypes.data,
        chrs.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        bcs.ctypes.data, bc_len, counts.ctypes.data, n,
        out.ctypes.data, n_threads,
    )
    return out[:w].tobytes()


def intern_label_sets(labels: np.ndarray, offsets: np.ndarray):
    """First-encounter-order interning of variable-length u64 label
    sets.  Returns (ids per set, representative set index per id)."""
    lib = _load()
    labels = np.ascontiguousarray(labels, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_sets = len(offsets) - 1
    ids = np.empty(n_sets, np.int64)
    rep = np.empty(max(n_sets, 1), np.int64)
    n_uniq = lib.radc_intern_label_sets(
        labels.ctypes.data, offsets.ctypes.data, n_sets,
        ids.ctypes.data, rep.ctypes.data,
    )
    return ids, rep[:n_uniq]


def format_eqc_rows(vals: np.ndarray, offsets: np.ndarray) -> bytes:
    """Render '<v0>\\t<v1>...\\t<row>\\n' rows natively."""
    lib = _load()
    vals = np.ascontiguousarray(vals, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_rows = len(offsets) - 1
    out = np.empty(21 * len(vals) + 22 * max(n_rows, 1), np.uint8)
    w = lib.radc_format_eqc_rows(
        vals.ctypes.data, offsets.ctypes.data, n_rows, out.ctypes.data
    )
    return out[:w].tobytes()


def pug_graph_build(
    cell_read_offsets: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    gene_level: bool,
    exact: bool,
):
    """Build all per-cell PUGs natively and export the symmetrized
    adjacency for device connected components.  Returns (handle,
    n_nodes_per_cell[int64], degrees[int64 per node], nbrs_flat[int32
    cell-local ids]); the handle must be passed to :func:`pug_cover`
    and then :func:`pug_free`."""
    lib = _load()
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    umi = np.ascontiguousarray(umi, np.uint64)
    refs = np.ascontiguousarray(refs, np.uint32)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    n_cells = len(cell_read_offsets) - 1
    n_nodes = np.zeros(max(n_cells, 1), np.int64)
    sym_entries = np.zeros(max(n_cells, 1), np.int64)
    handle = lib.radc_pug_graph_build(
        cell_read_offsets.ctypes.data, n_cells,
        umi.ctypes.data, refs.ctypes.data,
        aln_offsets.ctypes.data, tid_to_gid.ctypes.data,
        1 if gene_level else 0, 1 if exact else 0,
        n_nodes.ctypes.data, sym_entries.ctypes.data, _NTHREADS,
    )
    total_nodes = int(n_nodes[:n_cells].sum())
    total_entries = int(sym_entries[:n_cells].sum())
    deg = np.zeros(max(total_nodes, 1), np.int64)
    nbrs = np.zeros(max(total_entries, 1), np.int32)
    lib.radc_pug_graph_export(handle, deg.ctypes.data, nbrs.ctypes.data)
    return handle, n_nodes[:n_cells], deg[:total_nodes], nbrs[:total_entries]


def pug_cover(
    handle,
    cell_read_offsets: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    gene_level: bool,
    large_thresh: int,
    comp_labels: np.ndarray,
):
    """Finish PUG resolution from per-node component labels; same
    return contract as :func:`pug_resolve`."""
    lib = _load()
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    comp_labels = np.ascontiguousarray(comp_labels, np.int32)
    n_cells = len(cell_read_offsets) - 1
    n_reads = int(cell_read_offsets[-1]) if n_cells >= 0 else 0
    n_aln = int(aln_offsets[-1]) if len(aln_offsets) else 0
    n_eqc = np.zeros(max(n_cells, 1), np.int64)
    used_alt = np.zeros(max(n_cells, 1), np.uint8)
    counts = np.empty(max(n_reads, 1), np.int64)
    lens = np.empty(max(n_reads, 1), np.int64)
    labels = np.empty(max(n_aln, 1), np.uint32)
    range_info = np.zeros((_NTHREADS, 4), np.int64)
    label_counts = np.zeros(_NTHREADS, np.int64)
    lib.radc_pug_cover(
        handle, cell_read_offsets.ctypes.data, n_cells,
        aln_offsets.ctypes.data, tid_to_gid.ctypes.data,
        1 if gene_level else 0, large_thresh, comp_labels.ctypes.data,
        n_eqc.ctypes.data, used_alt.ctypes.data,
        counts.ctypes.data, lens.ctypes.data, labels.ctypes.data,
        range_info.ctypes.data, label_counts.ctypes.data, _NTHREADS,
    )
    pieces_c, pieces_l, pieces_lab = [], [], []
    for t in range(_NTHREADS):
        _c0, rb, lb, ne = (int(x) for x in range_info[t])
        lc = int(label_counts[t])
        if ne:
            pieces_c.append(counts[rb : rb + ne])
            pieces_l.append(lens[rb : rb + ne])
        if lc:
            pieces_lab.append(labels[lb : lb + lc])
    cat = lambda ps, dt: np.concatenate(ps) if ps else np.zeros(0, dt)
    return (
        n_eqc[:n_cells],
        used_alt[:n_cells].view(bool),
        cat(pieces_c, np.int64),
        cat(pieces_l, np.int64),
        cat(pieces_lab, np.uint32),
    )


def pug_free(handle) -> None:
    _load().radc_pug_free(handle)


def gather_records(
    buf: np.ndarray, rec_starts: np.ndarray, sizes: np.ndarray,
    order: np.ndarray, dst_off: np.ndarray, out: np.ndarray,
) -> None:
    """out[dst_off[i] : +sizes[order[i]]] = record order[i]'s bytes
    (threaded memcpy gather)."""
    lib = _load()
    lib.radc_gather_records(
        np.ascontiguousarray(buf, np.uint8).ctypes.data,
        np.ascontiguousarray(rec_starts, np.int64).ctypes.data,
        np.ascontiguousarray(sizes, np.int64).ctypes.data,
        np.ascontiguousarray(order, np.int64).ctypes.data,
        len(order),
        np.ascontiguousarray(dst_off, np.int64).ctypes.data,
        out.ctypes.data, _NTHREADS,
    )


def bgzf_inflate(
    buf: np.ndarray, offs: np.ndarray, lens: np.ndarray,
    out_offs: np.ndarray, isizes: np.ndarray, out: np.ndarray,
    crcs: np.ndarray | None = None,
) -> None:
    """Inflate BGZF block payloads concurrently (raw deflate per block,
    convert.rs:205-220 semantics) and verify each member's CRC32
    trailer when ``crcs`` is given.  Raises ValueError on a corrupt
    block."""
    lib = _load()
    crcs_arr = (
        np.ascontiguousarray(crcs, np.uint32) if crcs is not None else None
    )
    rc = lib.radc_bgzf_inflate(
        np.ascontiguousarray(buf, np.uint8).ctypes.data,
        np.ascontiguousarray(offs, np.int64).ctypes.data,
        np.ascontiguousarray(lens, np.int64).ctypes.data,
        np.ascontiguousarray(out_offs, np.int64).ctypes.data,
        np.ascontiguousarray(isizes, np.int64).ctypes.data,
        crcs_arr.ctypes.data if crcs_arr is not None else 0,
        len(offs), out.ctypes.data, _NTHREADS,
    )
    if rc != 0:
        raise ValueError(f"corrupt BGZF block at index {-rc - 1}")


def bam_scan(buf, qname_state: np.ndarray):
    """Scan complete BAM records in ``buf``; returns (columns dict,
    bytes_consumed).  ``qname_state`` is a 258-byte uint8 array carried
    across calls (zero-initialized before the first).  Raises
    ValueError on structurally invalid records."""
    lib = _load()
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    arr = np.ascontiguousarray(arr, np.uint8)
    n_max = arr.nbytes // 36 + 1
    flags = np.empty(n_max, np.uint16)
    tid = np.empty(n_max, np.int32)
    bc = np.empty(n_max, np.uint64)
    bclen = np.empty(n_max, np.int32)
    bc_valid = np.empty(n_max, np.uint8)
    umi = np.empty(n_max, np.uint64)
    umilen = np.empty(n_max, np.int32)
    umi_valid = np.empty(n_max, np.uint8)
    as_score = np.empty(n_max, np.int32)
    same = np.empty(n_max, np.uint8)
    consumed = np.zeros(1, np.int64)
    n = lib.radc_bam_scan(
        arr.ctypes.data, arr.nbytes, qname_state.ctypes.data,
        flags.ctypes.data, tid.ctypes.data,
        bc.ctypes.data, bclen.ctypes.data, bc_valid.ctypes.data,
        umi.ctypes.data, umilen.ctypes.data, umi_valid.ctypes.data,
        as_score.ctypes.data, same.ctypes.data, consumed.ctypes.data,
        n_max,
    )
    if n < 0:
        raise ValueError("structurally invalid BAM record")
    cols = {
        "flags": flags[:n], "tid": tid[:n],
        "bc": bc[:n], "bclen": bclen[:n], "bc_valid": bc_valid[:n] != 0,
        "umi": umi[:n], "umilen": umilen[:n],
        "umi_valid": umi_valid[:n] != 0,
        "as": as_score[:n], "same_qname": same[:n] != 0,
    }
    return cols, int(consumed[0])
