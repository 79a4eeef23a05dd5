"""Vectorized UMI resolution: cr-like (winner-take-all / prefer-ambig),
trivial, and USA-mode count extraction.

The reference resolves each cell independently with sort-based streaming
loops (pugutils.rs:504-850, quant.rs:453-641) — here every cell in the
batch is resolved at once with one global lexicographic sort plus
segmented reductions, which is the shape that maps onto a device sort
and segmented reductions.

Semantics proven equivalent to the reference:

* ``resolve_num_molecules_crlike_from_vec`` (pugutils.rs:644-749)
  computes, per (cell, umi), the set of genes attaining the maximum
  aggregated count; the streaming update with its Greater/Equal/Less
  cases is exactly an argmax tie-set over per-gene aggregate counts
  (gene lists sorted ascending, each gene once).  Both the small-cell
  per-read path and the EqMap path aggregate to the same per-(umi, gene)
  totals, so one vectorized path serves both.
* ``..._prefer_ambig`` (pugutils.rs:505-641) aggregates per
  gene-modulo-splicing and emits each winning gene's observed spliced /
  unspliced variants.
* USA slotting follows extract_counts (utils.rs:656-739) and the
  identical rules inlined in quantify_small_cell_sparse
  (quant.rs:541-589): len-1 direct, len-2 same-gene -> ambiguous else
  prefer-spliced, len 3..10 single-spliced rule, len > 10 dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

U32MAX = np.iinfo(np.uint32).max


@dataclass
class UmiGroups:
    """Per-(cell, umi) resolved tie-set labels, CSR layout.

    ``labels`` are ascending distinct gene ids per group.
    """

    cell: np.ndarray        # (G,) int64 cell index per group
    umi: np.ndarray         # (G,) uint64
    label_offsets: np.ndarray  # (G+1,) int64
    labels: np.ndarray      # flat uint32 gene ids


def _bits_for(n: int) -> int:
    return max(int(n) - 1, 1).bit_length()


def _sort_packed(key: np.ndarray, seg_offsets=None) -> np.ndarray:
    """Sort a packed u64 key array.  When ``seg_offsets`` delimit runs
    whose relative order is already correct (e.g. reads arrive grouped
    by cell in collated-file order), sort only within each segment —
    native + threaded, O(sum n_i log n_i) over small segments instead of
    one global O(n log n)."""
    from ..radz import _native

    if seg_offsets is not None and _native.available() and len(key) > 4096:
        return _native.sort_u64_segments(
            np.ascontiguousarray(key, np.uint64), seg_offsets
        )
    return np.sort(key)


def _sort_unique_counts(key: np.ndarray, seg_offsets=None):
    """Sort + run-length encode a packed u64 key array: returns
    (unique keys in sorted order, run counts).  Uses the fused native
    segmented kernel when segment offsets are available."""
    from ..radz import _native

    if seg_offsets is not None and _native.available() and len(key) > 4096:
        return _native.sort_rle_u64_segments(
            np.ascontiguousarray(key, np.uint64), seg_offsets
        )
    key = np.sort(key)
    if not len(key):
        return key, np.zeros(0, np.int64)
    new = np.ones(len(key), bool)
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    return key[starts], np.diff(np.append(starts, len(key)))


def _segments_of_sorted(col: np.ndarray) -> np.ndarray:
    """Offsets of the runs of a nondecreasing column, or None if the
    column isn't nondecreasing."""
    n = len(col)
    if n == 0:
        return None
    if not bool((col[1:] >= col[:-1]).all()):
        return None
    starts = np.flatnonzero(col[1:] != col[:-1]) + 1
    offs = np.empty(len(starts) + 2, np.int64)
    offs[0] = 0
    offs[1:-1] = starts
    offs[-1] = n
    return offs


def _dedup_read_genes(
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project per-alignment refs to genes and dedup within each read.
    Returns (pair_read, pair_gene).  Uses a packed single-key sort when
    (read, gene) fits in 64 bits — one radix-style sort instead of a
    two-key lexsort."""
    n = len(aln_offsets) - 1
    num_aln = np.diff(aln_offsets)
    read_of_aln = np.repeat(np.arange(n, dtype=np.int64), num_aln)
    genes = tid_to_gid[refs]
    gbits = _bits_for(int(genes.max()) + 1 if len(genes) else 1)
    rbits = _bits_for(n if n else 1)
    if gbits + rbits <= 63:
        key = (read_of_aln.astype(np.uint64) << np.uint64(gbits)) | genes.astype(
            np.uint64
        )
        # alignments are already contiguous per read, so only the gene
        # suffix needs sorting — segment per read, fused sort + dedup
        key, _ = _sort_unique_counts(
            key, np.ascontiguousarray(aln_offsets, np.int64)
        )
        return (key >> np.uint64(gbits)).astype(np.int64), (
            key & np.uint64((1 << gbits) - 1)
        ).astype(tid_to_gid.dtype)
    order = np.lexsort((genes, read_of_aln))
    r_s = read_of_aln[order]
    g_s = genes[order]
    first = np.ones(len(r_s), bool)
    first[1:] = (r_s[1:] != r_s[:-1]) | (g_s[1:] != g_s[:-1])
    return r_s[first], g_s[first]


def resolve_crlike(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    prefer_ambig: bool = False,
) -> UmiGroups:
    """Winner-take-all resolution across all cells at once."""
    pair_read, pair_gene = _dedup_read_genes(refs, aln_offsets, tid_to_gid)
    c = cell_of_read[pair_read]
    u = umi[pair_read]
    g = pair_gene

    # sort triplets by (cell, umi, gene); pack into one u64 key when the
    # bit budget allows (cells + umi + gene bits <= 64)
    cbits = _bits_for(int(c.max()) + 1 if len(c) else 1)
    ubits = _bits_for(int(u.max()) + 1 if len(u) else 1)
    gbits = _bits_for(int(g.max()) + 1 if len(g) else 1)
    if cbits + ubits + gbits <= 64:
        key = (
            (c.astype(np.uint64) << np.uint64(ubits + gbits))
            | (u.astype(np.uint64) << np.uint64(gbits))
            | g.astype(np.uint64)
        )
        # collated input arrives grouped by cell: sort within cell runs,
        # fused with the per-(cell, umi, gene) run-length aggregation
        uniq, counts = _sort_unique_counts(key, _segments_of_sorted(c))
        tg = (uniq & np.uint64((1 << gbits) - 1)).astype(pair_gene.dtype)
        tu = (uniq >> np.uint64(gbits)) & np.uint64((1 << ubits) - 1)
        tc = (uniq >> np.uint64(ubits + gbits)).astype(np.int64)
        t_counts = counts.astype(np.uint32)
    else:
        order = np.lexsort((g, u, c))
        c, u, g = c[order], u[order], g[order]

        # aggregate counts per (cell, umi, gene)
        new_t = np.ones(len(c), bool)
        if len(c):
            new_t[1:] = (
                (c[1:] != c[:-1]) | (u[1:] != u[:-1]) | (g[1:] != g[:-1])
            )
        t_start = np.flatnonzero(new_t)
        tc, tu, tg = c[t_start], u[t_start], g[t_start]
        t_counts = np.diff(np.append(t_start, len(c))).astype(np.uint32)

    if prefer_ambig:
        return _winners_prefer_ambig(tc, tu, tg, t_counts)
    return _winners_wta(tc, tu, tg, t_counts)


def _winners_wta(tc, tu, tg, t_counts) -> UmiGroups:
    # group boundaries per (cell, umi); data is sorted, so segment
    # reductions use reduceat (much faster than ufunc.at scatter)
    if len(tc) == 0:
        return UmiGroups(
            cell=tc, umi=tu,
            label_offsets=np.zeros(1, np.int64), labels=tg.astype(np.uint32),
        )
    new_g = np.ones(len(tc), bool)
    new_g[1:] = (tc[1:] != tc[:-1]) | (tu[1:] != tu[:-1])
    g_start = np.flatnonzero(new_g)
    gid = np.cumsum(new_g) - 1
    gmax = np.maximum.reduceat(t_counts, g_start)
    win = t_counts == gmax[gid]

    label_counts = np.add.reduceat(win.astype(np.int64), g_start)
    offsets = np.zeros(len(g_start) + 1, np.int64)
    np.cumsum(label_counts, out=offsets[1:])
    return UmiGroups(
        cell=tc[g_start], umi=tu[g_start],
        label_offsets=offsets, labels=tg[win].astype(np.uint32),
    )


def _winners_prefer_ambig(tc, tu, tg, t_counts) -> UmiGroups:
    """Prefer-ambiguity: aggregate per gene-pair (spliced id), winners
    keep all observed variants (pugutils.rs:505-641)."""
    pair = tg & ~np.uint32(1)
    new_p = np.ones(len(tc), bool)
    if len(tc):
        new_p[1:] = (tc[1:] != tc[:-1]) | (tu[1:] != tu[:-1]) | (pair[1:] != pair[:-1])
    pid = np.cumsum(new_p) - 1
    n_pairs = int(pid[-1]) + 1 if len(tc) else 0
    pair_counts = np.zeros(n_pairs, np.uint64)
    np.add.at(pair_counts, pid, t_counts.astype(np.uint64))

    p_start = np.flatnonzero(new_p)
    pc, pu = tc[p_start], tu[p_start]
    new_g = np.ones(n_pairs, bool)
    if n_pairs:
        new_g[1:] = (pc[1:] != pc[:-1]) | (pu[1:] != pu[:-1])
    gid_of_pair = np.cumsum(new_g) - 1
    n_groups = int(gid_of_pair[-1]) + 1 if n_pairs else 0
    gmax = np.zeros(n_groups, np.uint64)
    np.maximum.at(gmax, gid_of_pair, pair_counts)
    pair_wins = pair_counts == gmax[gid_of_pair]
    # a variant (tg entry) is emitted iff its pair won
    win = pair_wins[pid]

    label_counts = np.zeros(n_groups, np.int64)
    np.add.at(label_counts, gid_of_pair[pid[win]], 1)
    offsets = np.zeros(n_groups + 1, np.int64)
    np.cumsum(label_counts, out=offsets[1:])
    g_start_pairs = np.flatnonzero(new_g)
    return UmiGroups(
        cell=pc[g_start_pairs], umi=pu[g_start_pairs],
        label_offsets=offsets, labels=tg[win].astype(np.uint32),
    )


def accelerator_present() -> bool:
    """True when jax's default backend is an accelerator (the jax
    import is deferred so host-only runs never pay for it).  Every
    ``auto`` backend policy in the pipeline consults this one probe."""
    import jax

    return jax.default_backend() != "cpu"


def device_backend_enabled(n_pairs: int) -> bool:
    """Whether the jitted device WTA kernel should handle this batch.

    ``AFT_CRLIKE_BACKEND`` = ``jax`` forces it, ``host`` disables it;
    ``auto`` (default) resolves on the device whenever jax's default
    backend is an accelerator (quant.rs:643-1283 is the behavioral
    spec; the host kernel is the CPU path)."""
    import os

    del n_pairs
    mode = os.environ.get("AFT_CRLIKE_BACKEND", "auto")
    if mode == "host":
        return False
    if mode == "jax":
        return True
    return accelerator_present()


def wta_counts_native(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    n_rows: int,
    usa_offsets=None,
):
    """Single-pass threaded native cr-like WTA counting — the non-USA
    gene-unique rule, or USA tie-set slotting when ``usa_offsets``
    (unspliced_off, ambig_off) is given.  Returns COO triplets
    (rows, cols, counts[f32]) or None when ineligible (native lib
    missing, cells not grouped, bit overflow)."""
    from ..radz import _native

    if not _native.available() or len(cell_of_read) == 0:
        return None
    segs = _segments_of_sorted(cell_of_read)
    if segs is None:
        return None
    # genes are tid_to_gid values (USA: even/odd interleaved ids),
    # bounded by the tg-map id space rather than n_rows
    max_gid = int(tid_to_gid.max()) if len(tid_to_gid) else 0
    gbits = _bits_for(max(max_gid + 1, n_rows))
    ubits = _bits_for(int(umi.max()) + 1 if len(umi) else 1)
    if ubits + gbits > 64:
        return None
    cell_ids = cell_of_read[segs[:-1]].astype(np.int64)
    key, cnt = _native.crlike_wta_unique(
        cell_ids, segs, aln_offsets, refs, umi, tid_to_gid, n_rows, gbits,
        usa_mode=usa_offsets is not None,
        unspliced_off=usa_offsets[0] if usa_offsets else 0,
        ambig_off=usa_offsets[1] if usa_offsets else 0,
    )
    key = key.astype(np.int64)
    return (
        (key // n_rows).astype(np.int64),
        (key % n_rows).astype(np.int64),
        cnt.astype(np.float32),
    )


def wta_counts_device(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    n_rows: int,
    usa: bool = False,
    prefer_ambig: bool = False,
    async_: bool = False,
):
    """cr-like WTA resolution + counting on device: gene-unique (non-
    USA) or USA tie-set slotting (``usa=True``; gene ids must be the
    interleaved USA ids and ``n_rows`` the 3-section space;
    ``prefer_ambig`` switches to gene-pair aggregation).  Returns
    COO triplets (rows, cols, counts[f32]) — or, with ``async_``, a
    PendingWta whose .get() yields them after the device finishes — or
    None when the key doesn't fit the packed-u64 bit budget (caller
    falls back to host)."""
    import os

    from .crlike_device import (
        resolve_crlike_wta_device,
        resolve_crlike_wta_device_packed,
    )

    pair_read, pair_gene = _dedup_read_genes(refs, aln_offsets, tid_to_gid)
    c = cell_of_read[pair_read]
    u = umi[pair_read]
    g = pair_gene
    max_cell = int(c.max()) if len(c) else 0
    cbits = _bits_for(max_cell + 1 if len(c) else 1)
    ubits = _bits_for(int(u.max()) + 1 if len(u) else 1)
    gbits = _bits_for(int(g.max()) + 1 if len(g) else 1)
    if cbits + ubits + gbits > 64 or len(c) == 0:
        return None
    # packed upload: when (umi, gene) fits 40 bits (12bp UMIs + any
    # realistic gene space) and cells arrive sorted, ship u32 low-keys
    # (+ a u8 overflow plane above 32 bits) + a tiny per-cell delta
    # sideband and rebuild the u64 keys on device - 4-5 B/pair instead
    # of 8 (AFT_WTA_PACKED_UPLOAD=0 restores whole-key upload, as does
    # the uncompacted output mode AFT_WTA_COMPACT=0)
    if (
        ubits + gbits <= 40
        and cbits <= 32
        and os.environ.get("AFT_WTA_PACKED_UPLOAD", "1") != "0"
        and os.environ.get("AFT_WTA_COMPACT", "1") != "0"
    ):
        segs = _segments_of_sorted(c)
        if segs is not None:
            cell_ids = c[segs[:-1]].astype(np.int64)
            low = (
                u.astype(np.uint64) << np.uint64(gbits)
            ) | g.astype(np.uint64)
            lowkey = (low & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            lowhi = (
                (low >> np.uint64(32)).astype(np.uint8)
                if ubits + gbits > 32 else None
            )
            return resolve_crlike_wta_device_packed(
                cell_ids, segs, lowkey, ubits, gbits, n_rows, usa=usa,
                prefer_ambig=prefer_ambig, async_=async_, lowhi=lowhi,
            )
    key = (
        (c.astype(np.uint64) << np.uint64(ubits + gbits))
        | (u.astype(np.uint64) << np.uint64(gbits))
        | g.astype(np.uint64)
    )
    return resolve_crlike_wta_device(
        key, ubits, gbits, n_rows, usa=usa, prefer_ambig=prefer_ambig,
        async_=async_, n_cells=max_cell + 1,
    )


# --- USA slotting (utils.rs:656-739 / quant.rs:516-589) ----------------------

def usa_slots_for_groups(groups: UmiGroups, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Map each group's label set to a USA output slot.

    Returns (slot, valid) arrays of length G.  ``slot`` is the row index
    in the spliced/unspliced/ambiguous stacked gene space; ``valid`` is
    False where the UMI is discarded (gene-ambiguous or >10 labels).
    """
    unspliced_off = num_rows // 3
    ambig_off = 2 * unspliced_off
    G = len(groups.cell)
    lens = np.diff(groups.label_offsets)
    slot = np.zeros(G, np.int64)
    valid = np.zeros(G, bool)
    labels = groups.labels
    offs = groups.label_offsets

    # len == 1
    m1 = lens == 1
    if m1.any():
        g0 = labels[offs[:-1][m1]]
        sp = (g0 & 1) == 0
        slot[m1] = np.where(sp, g0 >> 1, unspliced_off + (g0 >> 1))
        valid[m1] = True

    # len == 2
    m2 = lens == 2
    if m2.any():
        s = offs[:-1][m2]
        g1 = labels[s].astype(np.int64)
        g2 = labels[s + 1].astype(np.int64)
        same = (g1 & ~1) == (g2 & ~1)
        sp1 = (g1 & 1) == 0
        sp2 = (g2 & 1) == 0
        sl = np.where(
            same,
            ambig_off + (g1 >> 1),
            np.where(sp1 & ~sp2, g1 >> 1, np.where(~sp1 & sp2, g2 >> 1, -1)),
        )
        slot[m2] = np.where(sl >= 0, sl, 0)
        valid[m2] = sl >= 0

    # len 3..10: single-spliced rule
    mm = (lens >= 3) & (lens <= 10)
    if mm.any():
        idx_g = np.flatnonzero(mm)
        elem_group = np.repeat(np.arange(G), lens)
        in_mm = mm[elem_group]
        eg = elem_group[in_mm]
        el = labels[in_mm]
        spl = (el & 1) == 0
        # count of spliced labels per group
        nspl = np.zeros(G, np.int64)
        np.add.at(nspl, eg[spl], 1)
        single = nspl == 1
        # the (unique) spliced gene per group
        sgene = np.zeros(G, np.uint32)
        sgene[eg[spl]] = el[spl]  # unique within group when single
        # does the set contain that gene's unspliced partner?
        partner = np.zeros(G, bool)
        is_partner = (~spl) & ((el & ~np.uint32(1)) == (sgene[eg] & ~np.uint32(1)))
        np.bitwise_or.at(partner, eg[is_partner], True)
        ok = mm & single
        slot[ok] = np.where(
            partner[ok],
            ambig_off + (sgene[ok] >> 1),
            sgene[ok] >> 1,
        )
        valid[ok] = True
        del idx_g
    # len > 10 or len == 0: dropped (valid stays False)
    return slot, valid


def nonusa_unique_slots(groups: UmiGroups) -> Tuple[np.ndarray, np.ndarray]:
    """Non-USA gene-unique counting: only singleton tie sets count
    (cr-like only_unique / fast-path discard of ties)."""
    lens = np.diff(groups.label_offsets)
    valid = lens == 1
    slot = np.zeros(len(valid), np.int64)
    slot[valid] = groups.labels[groups.label_offsets[:-1][valid]]
    return slot, valid


def counts_from_slots(
    cell: np.ndarray, slot: np.ndarray, valid: np.ndarray, n_cells: int, n_rows: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate +1 per valid (cell, slot); returns COO triplets sorted
    by (cell, slot): (rows, cols, counts[f32])."""
    c = cell[valid]
    s = slot[valid]
    key = c.astype(np.uint64) * np.uint64(n_rows) + s.astype(np.uint64)
    uniq, cts = _sort_unique_counts(key, _segments_of_sorted(c))
    uniq = uniq.astype(np.int64)
    return (
        (uniq // n_rows).astype(np.int64),
        (uniq % n_rows).astype(np.int64),
        cts.astype(np.float32),
    )


# --- gene-level eqclass grouping (for EM modes & dump-eq) --------------------

@dataclass
class CellEqClasses:
    """Per-cell gene-level equivalence classes, CSR over CSR.

    cell_eq_offsets[(C+1)] delimits each cell's classes; class i has
    label labels[label_offsets[i]:label_offsets[i+1]] and count counts[i].
    """

    cell_ids: np.ndarray       # (C,) distinct cell indices, ascending
    cell_eq_offsets: np.ndarray  # (C+1,)
    label_offsets: np.ndarray  # (E+1,)
    labels: np.ndarray         # flat uint32
    counts: np.ndarray         # (E,) uint32


def group_eqclasses(groups: UmiGroups) -> CellEqClasses:
    """Group identical label sets within each cell and count them
    (the reference's gene_eqclass_hash increments,
    pugutils.rs:676-679)."""
    G = len(groups.cell)
    lens = np.diff(groups.label_offsets)
    # 128-bit content hash of each label list (order-sensitive; labels
    # are ascending so equal sets hash equal)
    h1 = np.full(G, np.uint64(1469598103934665603))
    h2 = np.full(G, np.uint64(0x9E3779B97F4A7C15))
    elem_group = np.repeat(np.arange(G), lens)
    el = groups.labels.astype(np.uint64)
    # positional mixing: h = h * P + elem, computed per group via
    # iterative passes over label positions (bounded by max label len)
    maxlen = int(lens.max()) if G else 0
    P1 = np.uint64(1099511628211)
    P2 = np.uint64(0x100000001B3)
    pos_in_group = np.arange(len(el), dtype=np.int64) - np.repeat(
        groups.label_offsets[:-1], lens
    )
    for p in range(maxlen):
        sel = pos_in_group == p
        gidx = elem_group[sel]
        h1[gidx] = (h1[gidx] * P1) ^ el[sel]
        h2[gidx] = (h2[gidx] * P2) ^ (el[sel] + np.uint64(0x9E3779B9))
    h1 ^= lens.astype(np.uint64)

    order = np.lexsort((h2, h1, groups.cell))
    c_s, h1_s, h2_s = groups.cell[order], h1[order], h2[order]
    new_e = np.ones(G, bool)
    if G:
        new_e[1:] = (c_s[1:] != c_s[:-1]) | (h1_s[1:] != h1_s[:-1]) | (h2_s[1:] != h2_s[:-1])
    eq_of_sorted = np.cumsum(new_e) - 1
    E = int(eq_of_sorted[-1]) + 1 if G else 0
    counts = np.zeros(E, np.uint32)
    np.add.at(counts, eq_of_sorted, 1)

    rep = order[np.flatnonzero(new_e)]  # representative group per class
    rep_lens = lens[rep]
    label_offsets = np.zeros(E + 1, np.int64)
    np.cumsum(rep_lens, out=label_offsets[1:])
    gather = np.repeat(groups.label_offsets[:-1][rep], rep_lens) + (
        np.arange(int(label_offsets[-1])) - np.repeat(label_offsets[:-1], rep_lens)
    )
    labels = groups.labels[gather]

    eq_cell = c_s[np.flatnonzero(new_e)]
    cell_ids, cell_counts = np.unique(eq_cell, return_counts=True)
    cell_eq_offsets = np.zeros(len(cell_ids) + 1, np.int64)
    np.cumsum(cell_counts, out=cell_eq_offsets[1:])
    return CellEqClasses(
        cell_ids=cell_ids,
        cell_eq_offsets=cell_eq_offsets,
        label_offsets=label_offsets,
        labels=labels,
        counts=counts,
    )


def usa_transform_labels(
    eqc: CellEqClasses, num_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """extract_usa_eqmap label transform (utils.rs:825-909): map each
    gene id in each label to its USA slot, collapsing a spliced gene
    immediately followed by its unspliced partner into one ambiguous id.
    Returns (new_label_offsets, new_labels)."""
    unspliced_off = num_rows // 3
    ambig_off = 2 * unspliced_off
    E = len(eqc.counts)
    lens = np.diff(eqc.label_offsets)
    el = eqc.labels
    n = len(el)
    eg = np.repeat(np.arange(E), lens)
    pos = np.arange(n, dtype=np.int64) - np.repeat(eqc.label_offsets[:-1], lens)
    nxt = np.zeros(n, np.uint32)
    nxt[:-1] = el[1:]
    has_next = pos < np.repeat(lens - 1, lens)
    spl = (el & 1) == 0
    next_same = has_next & ((el & ~np.uint32(1)) == (nxt & ~np.uint32(1)))
    # element consumed by the previous one (it is the unspliced partner)
    consumed = np.zeros(n, bool)
    merge = spl & next_same
    consumed[1:] = merge[:-1]
    # note: merges can't chain (gene ids are distinct within a label)
    slot = np.where(
        merge,
        ambig_off + (el >> 1),
        np.where(spl, el >> 1, unspliced_off + (el >> 1)),
    ).astype(np.uint32)
    keep = ~consumed
    new_labels = slot[keep]
    new_lens = np.zeros(E, np.int64)
    np.add.at(new_lens, eg[keep], 1)
    new_offsets = np.zeros(E + 1, np.int64)
    np.cumsum(new_lens, out=new_offsets[1:])
    return new_offsets, new_labels


# --- trivial resolution (pugutils.rs:852-911) --------------------------------

def resolve_trivial(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    n_cells: int,
    n_genes: int,
):
    """Trivial resolution: per transcript-level eqclass, discard
    multi-gene classes; count distinct UMIs per gene (merged across
    classes).  Returns (rows, cols, vals) COO triplets plus the
    per-cell multimapping rate (multi-gene UMIs / total UMIs)."""
    n = len(aln_offsets) - 1
    num_aln = np.diff(aln_offsets)
    read_of_aln = np.repeat(np.arange(n, dtype=np.int64), num_aln)
    genes = tid_to_gid[refs].astype(np.uint32)

    # single-gene mask per read (all alignments project to one gene)
    first_gene = np.zeros(n, np.uint32)
    first_gene[read_of_aln[::-1]] = genes[::-1]  # first element wins
    single = np.ones(n, bool)
    np.logical_and.at(single, read_of_aln, genes == first_gene[read_of_aln])

    # eqclass identity = verbatim transcript list; hash it (order-sensitive,
    # matching the reference's hashing of the raw refs slice)
    h = np.full(n, np.uint64(1469598103934665603))
    h2 = np.full(n, np.uint64(14029467366897019727))
    P1 = np.uint64(1099511628211)
    P2 = np.uint64(0x100000001B3)
    r64 = refs.astype(np.uint64)
    pos_in_read = np.arange(len(refs), dtype=np.int64) - np.repeat(
        aln_offsets[:-1], num_aln
    )
    maxlen = int(num_aln.max()) if n else 0
    for p in range(maxlen):
        sel = pos_in_read == p
        ridx = read_of_aln[sel]
        h[ridx] = (h[ridx] * P1) ^ r64[sel]
        h2[ridx] = (h2[ridx] * P2) ^ (r64[sel] + np.uint64(0x9E3779B9))
    h ^= num_aln.astype(np.uint64)

    # distinct UMIs per (cell, eqclass): for the mm-rate statistic
    order = np.lexsort((umi, h2, h, cell_of_read))
    c_s = cell_of_read[order]
    h_s, h2_s, u_s = h[order], h2[order], umi[order]
    sg_s = single[order]
    new_umi = np.ones(n, bool)
    if n:
        new_umi[1:] = (
            (c_s[1:] != c_s[:-1]) | (h_s[1:] != h_s[:-1]) | (h2_s[1:] != h2_s[:-1])
            | (u_s[1:] != u_s[:-1])
        )
    total_umis = np.zeros(n_cells, np.int64)
    multi_umis = np.zeros(n_cells, np.int64)
    np.add.at(total_umis, c_s[new_umi], 1)
    mg = new_umi & ~sg_s
    np.add.at(multi_umis, c_s[mg], 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        mmrate = np.where(total_umis > 0, multi_umis / np.maximum(total_umis, 1), 0.0)

    # counts: distinct (cell, gene, umi) over single-gene reads
    cs = cell_of_read[single]
    gs = first_gene[single]
    us = umi[single]
    key_order = np.lexsort((us, gs, cs))
    cs, gs, us = cs[key_order], gs[key_order], us[key_order]
    uniq = np.ones(len(cs), bool)
    if len(cs):
        uniq[1:] = (cs[1:] != cs[:-1]) | (gs[1:] != gs[:-1]) | (us[1:] != us[:-1])
    cs, gs = cs[uniq], gs[uniq]
    key = cs * np.int64(n_genes) + gs
    ukey, cts = np.unique(key, return_counts=True)
    return (
        (ukey // n_genes).astype(np.int64),
        (ukey % n_genes).astype(np.int64),
        cts.astype(np.float32),
        mmrate,
    )
