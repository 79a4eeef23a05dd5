"""Device (JAX/XLA) cr-like winner-take-all resolution.

The host path (ops/crlike.py) resolves UMIs with native segmented
sorts; this module is the device equivalent: ONE jitted program
over a padded, packed u64 key array - sort, run-length aggregate,
segmented argmax with tie sets, and (non-USA) gene-unique counting -
all with fixed shapes so XLA compiles one program per pad bucket.

Semantics mirror resolve_num_molecules_crlike_from_vec
(reference src/pugutils.rs:644-749): per (cell, umi) the genes attaining
the maximal aggregated count form the tie set; a UMI contributes one
count to its gene iff the tie set is a singleton (non-USA "unique"
rule, reference src/quant.rs:541-589 fast path).

Key packing matches ops/crlike.py::resolve_crlike: the (cell, umi,
gene) triplet packs into one u64 as cell << (ubits+gbits) | umi <<
gbits | gene; PAD entries are all-ones (sorts to the end and is never a
valid key because gene ids never reach the all-ones pattern).

Sharding: resolution is embarrassingly parallel over cells, so the key
array shards over a 1-D device mesh at cell boundaries (pad each shard
to the common length); every program instance runs this same kernel —
no collectives are needed until the final count-matrix assembly.
"""

from __future__ import annotations

import functools
import os
from functools import partial

import numpy as np

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# Scatter-free segmented reductions over CONTIGUOUS segments.
#
# After the key sort every segment (triplet, (cell,umi) group, pair) is a
# contiguous run, so segmented reductions never need scatter: a segmented
# sum is cumsum + two boundary propagations, and a segmented min/max is two
# cumulative ops over (segment_ordinal << bits | value) packed words.  The
# propagations are plain lax.cummax/cummin because the propagated values
# are monotone in row order (running sums are non-decreasing; the packed
# words carry the non-decreasing segment ordinal in their high bits).
#
# These helpers replace every scatter in both WTA kernels (the scatter
# formulation stays behind AFT_WTA_SEGRED=scatter); cumsum/cummax are
# single XLA primitives, where an associative-scan formulation with a
# custom pair operator compiled for tens of minutes.
# ---------------------------------------------------------------------------


def _seg_ends(start):
    """Bool mask of each contiguous segment's LAST row (the row before
    the next start; the final row closes the last segment)."""
    import jax.numpy as jnp

    return jnp.concatenate([start[1:], jnp.ones((1,), bool)])


def _seg_sum(x, start, with_rank=False):
    """Per-row segment total of non-negative int32 ``x`` over contiguous
    segments delimited by ``start``.  Rows before the first start (none,
    in sorted valid data) read garbage and must be masked by callers.
    ``with_rank`` also returns the inclusive running sum within the
    row's segment (the row's 1-based "rank" when x marks rows)."""
    import jax.lax as lax
    import jax.numpy as jnp

    c = jnp.cumsum(x)
    cprev = jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])
    # running sum is non-decreasing, so cummax propagates the most
    # recent segment's base ...
    base = lax.cummax(jnp.where(start, cprev, x.dtype.type(-1)))
    big = jnp.iinfo(c.dtype).max
    # ... and the nearest end to the right holds the smallest end total
    tot = lax.cummin(jnp.where(_seg_ends(start), c, big), reverse=True)
    if with_rank:
        return tot - base, c - base
    return tot - base


def _last_marked(val, mark, grp_ord, val_bits=32, strict=False):
    """At each row, the MAX ``val`` over marked rows at-or-before it —
    or strictly before it with ``strict`` — within the same segment; -1
    when none.  When values ascend over a segment's marked rows (the
    kernels' case: gene ids ascend within a sorted group) this is
    exactly the value at the nearest earlier mark.  One forward cummax
    over (segment_ordinal | value) packed words (plus a one-row shift
    for the strict variant) — half the cost of a full segmented
    reduction when only look-back visibility is needed."""
    import jax.lax as lax
    import jax.numpy as jnp

    mask = (jnp.int64(1) << val_bits) - 1
    p = (grp_ord.astype(jnp.int64) << val_bits) | val
    run = lax.cummax(jnp.where(mark, p, jnp.int64(-1)))
    if strict:
        run = jnp.concatenate([jnp.full((1,), -1, jnp.int64), run[:-1]])
    got = (run >> val_bits) == grp_ord
    return jnp.where(got, run & mask, -1)


def _seg_reduce(val, mark, start, grp_ord, *, val_bits=32):
    """Per-row max of int64 ``val`` >= 0 over MARKED rows of the row's
    contiguous segment; -1 where the segment has no marked row.

    ``grp_ord`` is the 1-based segment ordinal (cumsum of ``start``);
    packing it above the value makes the running cummax segment-local:
    earlier segments' words are always smaller, so the running max at a
    segment's end row is that segment's own reduction, and the packed
    words at end rows are non-decreasing, so a reverse cummin broadcasts
    each end's word back over exactly its own segment."""
    import jax.lax as lax
    import jax.numpy as jnp

    mask = (jnp.int64(1) << val_bits) - 1
    p = (grp_ord.astype(jnp.int64) << val_bits) | val
    run = lax.cummax(jnp.where(mark, p, jnp.int64(-1)))
    big = jnp.iinfo(jnp.int64).max
    r = lax.cummin(jnp.where(_seg_ends(start), run, big), reverse=True)
    got = (r >> val_bits) == grp_ord
    return jnp.where(got, r & mask, -1)


def _wta_output_mode() -> str:
    """Effective output-tail mode (``AFT_WTA_COMPACT``):

    * ``fuse`` (default, also ``auto``) - two-sort fused tail: no
      third compaction sort; the host fetches one sorted row per
      resolved UMI and drops adjacent duplicates.
    * ``1`` - three-sort compacted tail (fetch = nnz unique pairs).
    * ``0`` - no compaction; fetch the full padded arrays."""
    mode = os.environ.get("AFT_WTA_COMPACT", "auto")
    return "fuse" if mode == "auto" else mode


def _use_scatter_segred() -> bool:
    """AFT_WTA_SEGRED=scatter selects the scatter formulation (kept for
    A/B profiling); the default is the scatter-free cumulative form."""
    return os.environ.get("AFT_WTA_SEGRED", "cum") == "scatter"


def _segred_cache_key() -> str:
    """Trace-time formulation selector that must key the jit caches."""
    return os.environ.get("AFT_WTA_SEGRED", "cum")


def _kernel(key, ubits, gbits, n_rows, fuse_shift=None):
    if _use_scatter_segred():
        assert fuse_shift is None
        return _kernel_scatter(key, ubits, gbits, n_rows)
    import jax.numpy as jnp

    key = jnp.sort(key)
    valid = key != PAD

    prev = jnp.concatenate([key[:1] ^ jnp.uint64(1), key[:-1]])
    trip_start = (key != prev) & valid

    gkey = key >> jnp.uint64(gbits)  # (cell, umi)
    gprev = jnp.concatenate([gkey[:1] ^ jnp.uint64(1), gkey[:-1]])
    grp_start = (gkey != gprev) & valid
    grp_ord = jnp.cumsum(grp_start.astype(jnp.int32))  # 1-based

    # per-triplet multiplicity, broadcast to every row of the triplet
    t_count = _seg_sum(valid.astype(jnp.int32), trip_start)
    tc = jnp.where(trip_start, t_count, 0)
    # per-group winning count, broadcast to every row of the group
    # counts fit 31 bits (bounded by the array length)
    gmax = _seg_reduce(
        tc.astype(jnp.int64), trip_start, grp_start, grp_ord, val_bits=31
    )
    winner = trip_start & (tc.astype(jnp.int64) == gmax)

    # tie-set size per group; non-USA unique rule keeps singletons
    tie_sz = _seg_sum(winner.astype(jnp.int32), grp_start)
    unique_win = winner & (tie_sz == 1)

    # count matrix contribution: +1 at (cell, gene) per unique winner.
    # re-pack to (cell, gene), sort, and run-length aggregate.
    cell = key >> jnp.uint64(ubits + gbits)
    gene = key & jnp.uint64((1 << gbits) - 1)
    cg = jnp.where(
        unique_win, cell * jnp.uint64(n_rows) + gene, PAD
    )
    cg = jnp.sort(cg)
    cg_valid = cg != PAD
    cg_prev = jnp.concatenate([cg[:1] ^ jnp.uint64(1), cg[:-1]])
    cg_start = (cg != cg_prev) & cg_valid
    cg_count = _seg_sum(cg_valid.astype(jnp.int32), cg_start)
    if fuse_shift is not None:
        return _emit_fused(cg, cg_valid, cg_count, fuse_shift)
    # emit (key, count) at the segment-start positions; PAD elsewhere
    out_key = jnp.where(cg_start, cg, PAD)
    out_cnt = jnp.where(cg_start, cg_count, 0)
    return out_key, out_cnt


def _emit_fused(cg, cg_valid, cg_count, fuse_shift):
    """Two-sort tail (VERDICT r4 Next #4): after the (cell, gene) sort
    the VALID rows are already compact at the front, so instead of
    masking non-start rows to PAD and paying a third sort to
    re-compact (`_compact`), broadcast each run's total to every row
    of the run (``_seg_sum`` already does) and emit it AT EVERY valid
    row.  The prefix is sorted with adjacent duplicates carrying
    identical values; the host drops duplicates with one vectorized
    compare.  Saves one full-width sort at the price of fetching one
    row per resolved UMI instead of one per unique (cell, gene).

    ``fuse_shift == 32`` (cellgene < 2^32) emits two u32 planes; the
    wider 24-bit layout packs a u64 because cellgene needs 40 bits."""
    import jax.numpy as jnp

    nnz = cg_valid.sum(dtype=jnp.int32)
    if fuse_shift == 32:
        lo = jnp.where(
            cg_valid, cg.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF)
        )
        return nnz, lo, cg_count.astype(jnp.uint32)
    packed = jnp.where(
        cg_valid,
        (cg << jnp.uint64(fuse_shift)) | cg_count.astype(jnp.uint64),
        PAD,
    )
    return nnz, packed


def _kernel_scatter(key, ubits, gbits, n_rows):
    import jax.numpy as jnp

    N = key.shape[0]
    key = jnp.sort(key)
    valid = key != PAD

    prev = jnp.concatenate([key[:1] ^ jnp.uint64(1), key[:-1]])
    trip_start = (key != prev) & valid
    # triplet segment ids (0-based over the sorted array; PAD tail
    # collapses into the last segment but is masked everywhere)
    trip_id = jnp.cumsum(trip_start.astype(jnp.int32)) - 1
    trip_id = jnp.maximum(trip_id, 0)
    # per-triplet multiplicity
    t_count = jnp.zeros(N, jnp.int32).at[trip_id].add(valid.astype(jnp.int32))

    gkey = key >> jnp.uint64(gbits)  # (cell, umi)
    gprev = jnp.concatenate([gkey[:1] ^ jnp.uint64(1), gkey[:-1]])
    grp_start = (gkey != gprev) & valid
    grp_id = jnp.cumsum(grp_start.astype(jnp.int32)) - 1
    grp_id = jnp.maximum(grp_id, 0)

    # per-group max triplet count: scatter-max of each triplet's count
    # at its group id (only triplet-start rows carry the count)
    t_count_at_start = jnp.where(trip_start, t_count[trip_id], 0)
    gmax = jnp.zeros(N, jnp.int32).at[grp_id].max(t_count_at_start)
    winner = trip_start & (t_count_at_start == gmax[grp_id])

    # tie-set size per group; non-USA unique rule keeps singletons
    tie_sz = jnp.zeros(N, jnp.int32).at[grp_id].add(winner.astype(jnp.int32))
    unique_win = winner & (tie_sz[grp_id] == 1)

    # count matrix contribution: +1 at (cell, gene) per unique winner.
    # re-pack to (cell, gene), sort, and run-length aggregate.
    cell = key >> jnp.uint64(ubits + gbits)
    gene = key & jnp.uint64((1 << gbits) - 1)
    cg = jnp.where(
        unique_win, cell * jnp.uint64(n_rows) + gene, PAD
    )
    cg = jnp.sort(cg)
    cg_valid = cg != PAD
    cg_prev = jnp.concatenate([cg[:1] ^ jnp.uint64(1), cg[:-1]])
    cg_start = (cg != cg_prev) & cg_valid
    cg_id = jnp.maximum(jnp.cumsum(cg_start.astype(jnp.int32)) - 1, 0)
    cg_count = jnp.zeros(N, jnp.int32).at[cg_id].add(cg_valid.astype(jnp.int32))
    # emit (key, count) at the segment-start positions; PAD elsewhere
    out_key = jnp.where(cg_start, cg, PAD)
    out_cnt = jnp.where(cg_start, cg_count[cg_id], 0)
    return out_key, out_cnt


def _kernel_usa(key, ubits, gbits, n_rows, prefer_ambig=False,
                fuse_shift=None):
    """USA-mode WTA: per (cell, umi) the winner tie set maps to a
    spliced/unspliced/ambiguous slot by the reference's len-1/2/3..10
    rules (utils.rs:656-739, quant.rs:516-589).  Gene ids are the USA
    interleaved ids (even = spliced, odd = unspliced); ``n_rows`` is the
    3-section output space.

    ``prefer_ambig``: counts aggregate per gene PAIR (spliced id) and a
    winning pair emits all its observed variants
    (pugutils.rs:505-641)."""
    if _use_scatter_segred():
        assert fuse_shift is None
        return _kernel_usa_scatter(key, ubits, gbits, n_rows, prefer_ambig)
    import jax.numpy as jnp

    key = jnp.sort(key)
    valid = key != PAD

    prev = jnp.concatenate([key[:1] ^ jnp.uint64(1), key[:-1]])
    trip_start = (key != prev) & valid

    gkey = key >> jnp.uint64(gbits)  # (cell, umi)
    gprev = jnp.concatenate([gkey[:1] ^ jnp.uint64(1), gkey[:-1]])
    grp_start = (gkey != gprev) & valid
    grp_ord = jnp.cumsum(grp_start.astype(jnp.int32))  # 1-based

    t_count = _seg_sum(valid.astype(jnp.int32), trip_start)
    tc = jnp.where(trip_start, t_count, 0)
    if prefer_ambig:
        # pair segments: a spliced/unspliced pair {2k, 2k+1} is adjacent
        # in the sorted keys, so key >> 1 merges it
        pkey = key >> jnp.uint64(1)
        pprev = jnp.concatenate([pkey[:1] ^ jnp.uint64(1), pkey[:-1]])
        pair_start = (pkey != pprev) & valid
        p_count = _seg_sum(tc, pair_start)
        pc = jnp.where(trip_start, p_count, 0)
        gmax_ct = _seg_reduce(
            pc.astype(jnp.int64), trip_start, grp_start, grp_ord,
            val_bits=31,
        )
        winner = trip_start & (pc.astype(jnp.int64) == gmax_ct)
    else:
        gmax_ct = _seg_reduce(
            tc.astype(jnp.int64), trip_start, grp_start, grp_ord,
            val_bits=31,
        )
        winner = trip_start & (tc.astype(jnp.int64) == gmax_ct)

    tie_sz, wrank = _seg_sum(winner.astype(jnp.int32), grp_start, with_rank=True)
    # one emission row per group: its LAST winner (winners are gene-
    # ascending within the sorted group, so the last winner's own gene
    # IS gmax, the previous winner's gene IS gmin when |tie|=2, and the
    # last even winner at-or-before it IS the max spliced gene — three
    # of the five tie-set reductions become free or one-pass look-backs)
    last_win = winner & (wrank == tie_sz)

    # gene-id arithmetic runs in int32 (gbits is always << 31); only
    # the grp-packed look-back words need 64 bits
    gi = (key & jnp.uint64((1 << gbits) - 1)).astype(jnp.int32)
    even = (gi & 1) == 0
    uoff = jnp.int32(n_rows // 3)
    aoff = jnp.int32(2 * (n_rows // 3))

    vb = gbits + 1
    g1p = _last_marked(
        gi, winner, grp_ord, val_bits=vb, strict=True
    ).astype(jnp.int32)
    sg = _last_marked(
        gi, winner & even, grp_ord, val_bits=vb
    ).astype(jnp.int32)
    nspl = _seg_sum((winner & even).astype(jnp.int32), grp_start)
    # does the tie set contain the unique spliced gene's unspliced
    # partner?  pair ids are adjacent, so the partner row's previous
    # winner is exactly its even pair mate (nothing sorts between 2k
    # and 2k+1); only consumed when nspl == 1
    podd = winner & ~even & (g1p == gi - 1)
    partner = _seg_sum(podd.astype(jnp.int32), grp_start) > 0

    # slot rules evaluated at the last-winner rows
    l_ = tie_sz
    g2 = gi
    g1 = jnp.where(l_ == 1, gi, g1p)
    sp1 = (g1 & 1) == 0
    sp2 = (g2 & 1) == 0
    same = (g1 & ~jnp.int32(1)) == (g2 & ~jnp.int32(1))
    slot1 = jnp.where(sp2, g2 >> 1, uoff + (g2 >> 1))
    slot2 = jnp.where(
        same, aoff + (g1 >> 1),
        jnp.where(sp1 & ~sp2, g1 >> 1, g2 >> 1),
    )
    ok2 = same | (sp1 & ~sp2) | (~sp1 & sp2)
    slot3 = jnp.where(partner, aoff + (sg >> 1), sg >> 1)
    ok3 = nspl == 1
    slot = jnp.where(
        l_ == 1, slot1, jnp.where(l_ == 2, slot2, slot3)
    )
    ok = jnp.where(
        l_ == 1, True,
        jnp.where(l_ == 2, ok2, (l_ >= 3) & (l_ <= 10) & ok3),
    )

    cell = key >> jnp.uint64(ubits + gbits)
    cs = jnp.where(
        last_win & ok,
        cell * jnp.uint64(n_rows) + slot.astype(jnp.uint64),
        PAD,
    )
    cs = jnp.sort(cs)
    cs_valid = cs != PAD
    cs_prev = jnp.concatenate([cs[:1] ^ jnp.uint64(1), cs[:-1]])
    cs_start = (cs != cs_prev) & cs_valid
    cs_count = _seg_sum(cs_valid.astype(jnp.int32), cs_start)
    if fuse_shift is not None:
        return _emit_fused(cs, cs_valid, cs_count, fuse_shift)
    out_key = jnp.where(cs_start, cs, PAD)
    out_cnt = jnp.where(cs_start, cs_count, 0)
    return out_key, out_cnt


def _kernel_usa_scatter(key, ubits, gbits, n_rows, prefer_ambig=False):
    """Round-3 scatter formulation of the USA kernel (A/B reference;
    see _use_scatter_segred)."""
    import jax.numpy as jnp

    N = key.shape[0]
    key = jnp.sort(key)
    valid = key != PAD

    prev = jnp.concatenate([key[:1] ^ jnp.uint64(1), key[:-1]])
    trip_start = (key != prev) & valid
    trip_id = jnp.maximum(jnp.cumsum(trip_start.astype(jnp.int32)) - 1, 0)
    t_count = jnp.zeros(N, jnp.int32).at[trip_id].add(valid.astype(jnp.int32))

    gkey = key >> jnp.uint64(gbits)  # (cell, umi)
    gprev = jnp.concatenate([gkey[:1] ^ jnp.uint64(1), gkey[:-1]])
    grp_start = (gkey != gprev) & valid
    grp_id = jnp.maximum(jnp.cumsum(grp_start.astype(jnp.int32)) - 1, 0)

    t_count_at_start = jnp.where(trip_start, t_count[trip_id], 0)
    if prefer_ambig:
        # pair segments: a spliced/unspliced pair {2k, 2k+1} is adjacent
        # in the sorted keys, so key >> 1 merges it
        pkey = key >> jnp.uint64(1)
        pprev = jnp.concatenate([pkey[:1] ^ jnp.uint64(1), pkey[:-1]])
        pair_start = (pkey != pprev) & valid
        pair_id = jnp.maximum(
            jnp.cumsum(pair_start.astype(jnp.int32)) - 1, 0
        )
        p_count = jnp.zeros(N, jnp.int32).at[pair_id].add(t_count_at_start)
        p_count_at_start = jnp.where(pair_start, p_count[pair_id], 0)
        gmax_ct = jnp.zeros(N, jnp.int32).at[grp_id].max(p_count_at_start)
        winner = trip_start & (p_count[pair_id] == gmax_ct[grp_id])
    else:
        gmax_ct = jnp.zeros(N, jnp.int32).at[grp_id].max(t_count_at_start)
        winner = trip_start & (t_count_at_start == gmax_ct[grp_id])

    tie_sz = jnp.zeros(N, jnp.int32).at[grp_id].add(winner.astype(jnp.int32))

    gi = (key & jnp.uint64((1 << gbits) - 1)).astype(jnp.int64)
    even = (gi & 1) == 0
    uoff = n_rows // 3
    aoff = 2 * uoff

    BIG = jnp.int64(1) << jnp.int64(62)
    gmin = jnp.full(N, BIG, jnp.int64).at[grp_id].min(
        jnp.where(winner, gi, BIG)
    )
    gmax = jnp.full(N, -1, jnp.int64).at[grp_id].max(
        jnp.where(winner, gi, -1)
    )
    nspl = jnp.zeros(N, jnp.int32).at[grp_id].add(
        (winner & even).astype(jnp.int32)
    )
    sgene = jnp.full(N, -1, jnp.int64).at[grp_id].max(
        jnp.where(winner & even, gi, -1)
    )
    # does the tie set contain the unique spliced gene's unspliced
    # partner?  (second scatter pass over sgene)
    partner_elem = winner & ~even & (
        (gi & ~jnp.int64(1)) == (sgene[grp_id] & ~jnp.int64(1))
    )
    partner = jnp.zeros(N, bool).at[grp_id].max(partner_elem)

    # slot rules evaluated per group (at grp_start rows)
    g = grp_id
    l_ = tie_sz[g]
    g1, g2 = gmin[g], gmax[g]
    sg, pt, ns = sgene[g], partner[g], nspl[g]
    sp1 = (g1 & 1) == 0
    sp2 = (g2 & 1) == 0
    same = (g1 & ~jnp.int64(1)) == (g2 & ~jnp.int64(1))
    slot1 = jnp.where(sp2, g2 >> 1, uoff + (g2 >> 1))
    slot2 = jnp.where(
        same, aoff + (g1 >> 1),
        jnp.where(sp1 & ~sp2, g1 >> 1, g2 >> 1),
    )
    ok2 = same | (sp1 & ~sp2) | (~sp1 & sp2)
    slot3 = jnp.where(pt, aoff + (sg >> 1), sg >> 1)
    ok3 = ns == 1
    slot = jnp.where(
        l_ == 1, slot1, jnp.where(l_ == 2, slot2, slot3)
    )
    ok = jnp.where(
        l_ == 1, True,
        jnp.where(l_ == 2, ok2, (l_ >= 3) & (l_ <= 10) & ok3),
    )

    cell = (key >> jnp.uint64(ubits + gbits)).astype(jnp.int64)
    cs = jnp.where(
        grp_start & ok,
        (cell * jnp.int64(n_rows) + slot).astype(jnp.uint64),
        PAD,
    )
    cs = jnp.sort(cs)
    cs_valid = cs != PAD
    cs_prev = jnp.concatenate([cs[:1] ^ jnp.uint64(1), cs[:-1]])
    cs_start = (cs != cs_prev) & cs_valid
    cs_id = jnp.maximum(jnp.cumsum(cs_start.astype(jnp.int32)) - 1, 0)
    cs_count = jnp.zeros(N, jnp.int32).at[cs_id].add(cs_valid.astype(jnp.int32))
    out_key = jnp.where(cs_start, cs, PAD)
    out_cnt = jnp.where(cs_start, cs_count[cs_id], 0)
    return out_key, out_cnt


def _compact(out_key, out_cnt, pack32: bool):
    """Compact the scattered (key, count) output on device: valid
    entries sort to the front in key order (PAD is the u64 maximum), so
    the host only fetches an nnz-sized prefix instead of the full
    padded array.

    ``pack32`` (host-static: max key < 2^32) fuses key and count into
    one u64 so the prefix fetch moves 8 bytes/entry instead of 12."""
    import jax
    import jax.numpy as jnp

    valid = out_key != PAD
    nnz = valid.sum(dtype=jnp.int32)
    if pack32:
        packed = jnp.where(
            valid,
            (out_key << jnp.uint64(32)) | out_cnt.astype(jnp.uint64),
            PAD,
        )
        return nnz, jnp.sort(packed)
    sk, sc = jax.lax.sort((out_key, out_cnt), num_keys=1)
    return nnz, sk, sc


@functools.lru_cache(maxsize=None)
def _slice_fn(b: int):
    import jax

    return jax.jit(lambda x: x[:b])


def _fetch_prefix(arr, nnz: int, pad_to: int):
    """Fetch the first ``nnz`` entries of a device array.

    At most ONE slice shape per pad shape: when nnz fits the half-pad
    prefix, a single jitted half slice halves the fetched bytes;
    otherwise fetch the full array (a slice program per nnz bucket
    would compile once per bucket)."""
    import jax

    if nnz == 0:
        return np.zeros(0, np.dtype(arr.dtype))
    half = pad_to // 2
    if nnz > half or half < 1024:
        return np.asarray(arr)[:nnz]
    with jax.enable_x64(True):
        return np.asarray(_slice_fn(half)(arr))[:nnz]


class PendingWtaFused:
    """Pending handle for the two-sort fused kernel tail
    (`_emit_fused`): fetches an nnz-row sorted prefix — two u32
    planes (shift=32) or one packed u64 plane (shift=24) — with
    adjacent duplicates, and drops the duplicates host-side with one
    vectorized compare on the unique (cell, gene) key."""

    def __init__(self, nnz_dev, arrays, n_rows: int, shift: int, pad_to: int):
        self._nnz = nnz_dev
        self._arrays = arrays
        self._n_rows = n_rows
        self._shift = shift
        self._pad_to = pad_to

    def get(self):
        nnz = int(np.asarray(self._nnz))
        if self._shift == 32:
            lo = _fetch_prefix(self._arrays[0], nnz, self._pad_to)
            cn = _fetch_prefix(self._arrays[1], nnz, self._pad_to)
            self._arrays = None
            if nnz == 0:
                z = np.zeros(0, np.int64)
                return z, z, np.zeros(0, np.float32)
            keep = np.ones(nnz, bool)
            keep[1:] = lo[1:] != lo[:-1]
            uniq = lo[keep].astype(np.int64)
            cnt = cn[keep].astype(np.int64)
        else:
            packed = _fetch_prefix(self._arrays[0], nnz, self._pad_to)
            self._arrays = None
            if nnz == 0:
                z = np.zeros(0, np.int64)
                return z, z, np.zeros(0, np.float32)
            keep = np.ones(nnz, bool)
            keep[1:] = packed[1:] != packed[:-1]
            packed = packed[keep]
            uniq = (packed >> np.uint64(self._shift)).astype(np.int64)
            cnt = (
                packed & np.uint64((1 << self._shift) - 1)
            ).astype(np.int64)
        return (
            (uniq // self._n_rows).astype(np.int64),
            (uniq % self._n_rows).astype(np.int64),
            cnt.astype(np.float32),
        )


def _fuse_shift_for(max_cells: int, n_rows: int, pad_to: int):
    """Packed-word layout for the fused tail, or None when the
    (cell, gene) space + count can't share a u64: counts are bounded
    by the block's row count, so shift=32 needs cellgene < 2^32 and
    shift=24 needs cellgene < 2^40 with blocks under 16M rows."""
    if max_cells * n_rows < (1 << 32):
        return 32
    if max_cells * n_rows < (1 << 40) and pad_to < (1 << 24):
        return 24
    return None


class PendingWta:
    """A submitted-but-unfetched device WTA resolution.  Holding the
    fetch until ``get()`` lets JAX's async dispatch overlap the
    host→device transfer and on-chip sort of block k with the host-side
    decode of block k+1 (the reference's reader/worker overlap,
    quant.rs:1527-1743, reborn as an input pipeline)."""

    def __init__(self, nnz_dev, arrays, n_rows: int, pack32: bool, pad_to: int):
        self._nnz = nnz_dev
        self._arrays = arrays
        self._n_rows = n_rows
        self._pack32 = pack32
        self._pad_to = pad_to

    def get(self):
        n_rows = self._n_rows
        nnz = int(np.asarray(self._nnz))
        if self._pack32:
            packed = _fetch_prefix(self._arrays[0], nnz, self._pad_to)
            uniq = (packed >> np.uint64(32)).astype(np.int64)
            cnt = (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
        else:
            uniq = _fetch_prefix(self._arrays[0], nnz, self._pad_to).astype(
                np.int64
            )
            cnt = _fetch_prefix(self._arrays[1], nnz, self._pad_to)
        self._arrays = None
        return (
            (uniq // n_rows).astype(np.int64),
            (uniq % n_rows).astype(np.int64),
            cnt.astype(np.float32),
        )


def _pad_bucket(n: int) -> int:
    """Padded key-array length: power-of-two ladder with midpoints
    (1.5x steps) — halves the average padding waste vs pure powers of
    two while keeping the compiled-program count bounded."""
    n = max(n, 1024)
    p = 1 << (int(n - 1).bit_length())
    mid = (p >> 1) + (p >> 2)
    return mid if n <= mid else p


_STICKY_PAD = 0


def _sticky_pad_bucket(n: int) -> int:
    """Monotone pad bucket: never smaller than any bucket this process
    already compiled for.  A large run streams equal blocks plus ONE
    smaller final block; without stickiness that tail block compiles
    a whole extra program to save a few MB of padding.
    ``AFT_WTA_STICKY_PAD=0`` disables."""
    global _STICKY_PAD
    pad = _pad_bucket(n)
    if os.environ.get("AFT_WTA_STICKY_PAD", "1") == "0":
        return pad
    pad = max(pad, _STICKY_PAD)
    _STICKY_PAD = pad
    return pad


def _cell_bucket(n: int) -> int:
    """Padded cell-count bucket for the packed-upload sideband."""
    return max(256, 1 << int(max(n - 1, 1)).bit_length())


@functools.lru_cache(maxsize=None)
def _wta_fused_fn(usa: bool, shift: int, segred: str = "cum"):
    import jax

    def run(k, ub, gb, nr, pa):
        if usa:
            return _kernel_usa(k, ub, gb, nr, pa, fuse_shift=shift)
        return _kernel(k, ub, gb, nr, fuse_shift=shift)

    return jax.jit(run, static_argnums=(1, 2, 3, 4))


@functools.lru_cache(maxsize=None)
def _wta_packed_fused_fn(usa: bool, shift: int, with_hi: bool,
                         segred: str = "cum"):
    """Packed-upload front end (u32 lowkeys + cell-delta sideband)
    combined with the fused two-sort tail."""
    import jax
    import jax.numpy as jnp

    def run(lowkey, hi8, pos, delta, n, ub, gb, nr, pa):
        npad = lowkey.shape[0]
        ind = jnp.zeros(npad, jnp.uint32).at[pos].add(delta, mode="drop")
        cid = jnp.cumsum(ind).astype(jnp.uint64)
        key = (cid << jnp.uint64(ub + gb)) | lowkey.astype(jnp.uint64)
        if with_hi:
            key = key | (hi8.astype(jnp.uint64) << jnp.uint64(32))
        key = jnp.where(jnp.arange(npad) < n, key, PAD)
        if usa:
            return _kernel_usa(key, ub, gb, nr, pa, fuse_shift=shift)
        return _kernel(key, ub, gb, nr, fuse_shift=shift)

    return jax.jit(run, static_argnums=(5, 6, 7, 8))


@functools.lru_cache(maxsize=None)
def _wta_packed_fn(usa: bool, pack32: bool, with_hi: bool, segred: str = "cum"):
    """Variant of _wta_compact_fn whose key stream arrives as u32
    low-keys (plus a u8 overflow plane when (umi, gene) needs 33-40
    bits) and a per-cell-boundary delta sideband: the u64 (cell, umi,
    gene) keys rebuild ON DEVICE with one scatter + cumsum (cells are
    sorted within a block, so the cell id per row is the running sum of
    boundary deltas).  4-5 B/pair instead of 8 host->device."""
    import jax
    import jax.numpy as jnp

    def run(lowkey, hi8, pos, delta, n, ub, gb, nr, pa):
        npad = lowkey.shape[0]
        ind = jnp.zeros(npad, jnp.uint32).at[pos].add(
            delta, mode="drop"
        )
        cid = jnp.cumsum(ind).astype(jnp.uint64)
        key = (cid << jnp.uint64(ub + gb)) | lowkey.astype(jnp.uint64)
        if with_hi:
            key = key | (hi8.astype(jnp.uint64) << jnp.uint64(32))
        key = jnp.where(jnp.arange(npad) < n, key, PAD)
        ok, oc = (
            _kernel_usa(key, ub, gb, nr, pa) if usa else _kernel(key, ub, gb, nr)
        )
        return _compact(ok, oc, pack32)

    return jax.jit(run, static_argnums=(5, 6, 7, 8))


def resolve_crlike_wta_device_packed(
    cell_ids: np.ndarray, segs: np.ndarray, lowkey: np.ndarray,
    ubits: int, gbits: int, n_rows: int,
    usa: bool = False, prefer_ambig: bool = False, async_: bool = False,
    lowhi: np.ndarray | None = None,
):
    """Packed-upload WTA resolution: ``lowkey`` holds the low 32 bits
    of (umi << gbits | gene) per pair, ``lowhi`` the 33rd-40th bits
    (when needed), ``cell_ids``/``segs`` the sorted per-cell id and
    pair-offset runs (``_segments_of_sorted`` layout).  Semantically
    identical to resolve_crlike_wta_device on the reassembled keys."""
    import jax
    import jax.numpy as jnp

    n = len(lowkey)
    n_cells = len(cell_ids)
    pad_to = _sticky_pad_bucket(n)
    cpad = _cell_bucket(n_cells)
    buf = np.full(pad_to, 0xFFFFFFFF, np.uint32)
    buf[:n] = lowkey
    with_hi = lowhi is not None
    if with_hi:
        hbuf = np.full(pad_to, 0xFF, np.uint8)
        hbuf[:n] = lowhi
    else:
        hbuf = np.zeros(0, np.uint8)
    pos = np.full(cpad, pad_to, np.int32)  # OOB -> dropped by scatter
    pos[:n_cells] = segs[:-1]
    delta = np.zeros(cpad, np.uint32)
    if n_cells:
        delta[0] = cell_ids[0]
        delta[1:n_cells] = np.diff(cell_ids).astype(np.uint32)
    max_cells = int(cell_ids[-1]) + 1 if n_cells else 1
    pack32 = max_cells * n_rows < (1 << 32)
    fuse = _wta_output_mode() == "fuse"
    shift = _fuse_shift_for(max_cells, n_rows, pad_to) if fuse else None
    with jax.enable_x64(True):
        if shift is not None:
            fn = _wta_packed_fused_fn(usa, shift, with_hi, _segred_cache_key())
            out = fn(
                jnp.asarray(buf), jnp.asarray(hbuf), jnp.asarray(pos),
                jnp.asarray(delta), np.int32(n), ubits, gbits, n_rows,
                prefer_ambig,
            )
            pending = PendingWtaFused(out[0], out[1:], n_rows, shift, pad_to)
            return pending if async_ else pending.get()
        fn = _wta_packed_fn(usa, pack32, with_hi, _segred_cache_key())
        out = fn(
            jnp.asarray(buf), jnp.asarray(hbuf), jnp.asarray(pos),
            jnp.asarray(delta), np.int32(n), ubits, gbits, n_rows,
            prefer_ambig,
        )
    pending = PendingWta(out[0], out[1:], n_rows, pack32, pad_to)
    return pending if async_ else pending.get()


@functools.lru_cache(maxsize=None)
def _wta_compact_fn(usa: bool, pack32: bool, segred: str = "cum"):
    # ``segred`` is purely a cache key: the kernels read the env var at
    # trace time, and without it a mode flip would silently reuse the
    # previously traced program
    import jax

    def run(k, ub, gb, nr, pa):
        ok, oc = (
            _kernel_usa(k, ub, gb, nr, pa) if usa else _kernel(k, ub, gb, nr)
        )
        return _compact(ok, oc, pack32)

    return jax.jit(run, static_argnums=(1, 2, 3, 4))


@functools.lru_cache(maxsize=None)
def _wta_plain_fn(usa: bool, segred: str = "cum"):
    import jax

    def run(k, ub, gb, nr, pa):
        return _kernel_usa(k, ub, gb, nr, pa) if usa else _kernel(k, ub, gb, nr)

    return jax.jit(run, static_argnums=(1, 2, 3, 4))


class PendingWtaFull:
    """Non-compacted pending handle (AFT_WTA_COMPACT=0): fetches the
    full padded output and filters on host."""

    def __init__(self, arrays, n_rows: int):
        self._arrays = arrays
        self._n_rows = n_rows

    def get(self):
        out_key = np.asarray(self._arrays[0])
        out_cnt = np.asarray(self._arrays[1])
        self._arrays = None
        keep = out_key != PAD
        uniq = out_key[keep].astype(np.int64)  # start slots are sorted
        cnt = out_cnt[keep]
        return (
            (uniq // self._n_rows).astype(np.int64),
            (uniq % self._n_rows).astype(np.int64),
            cnt.astype(np.float32),
        )


def resolve_crlike_wta_device(
    key: np.ndarray, ubits: int, gbits: int, n_rows: int, pad_to: int | None = None,
    usa: bool = False, prefer_ambig: bool = False, async_: bool = False,
    n_cells: int | None = None,
):
    """Resolve packed (cell, umi, gene) keys on device; returns COO
    triplets (rows, cols, counts[f32]) sorted by (cell, gene) —
    identical to ops/crlike.py resolve_crlike + nonusa_unique_slots +
    counts_from_slots for deduplicated input pairs.

    ``key`` must already be deduplicated per (read, gene) — i.e. the
    output of _dedup_read_genes repacked — duplicates from one read
    would inflate multiplicities.

    ``async_=True`` returns a :class:`PendingWta` immediately after
    submitting the program; the caller fetches later, letting device
    work overlap host decode of subsequent blocks.
    """
    import jax
    import jax.numpy as jnp

    n = len(key)
    if pad_to is None:
        pad_to = _sticky_pad_bucket(n)
    buf = np.full(pad_to, PAD, np.uint64)
    buf[:n] = key
    # counts are bounded by the block's pair count, so they always fit
    # 32 bits; keys pack alongside when the (cell, gene) space does
    max_cells = n_cells if n_cells is not None else 1 << (64 - ubits - gbits)
    # strict bound: a key of exactly 0xFFFFFFFF packed with a count of
    # 0xFFFFFFFF would collide with PAD
    pack32 = max_cells * n_rows < (1 << 32)

    segred = _segred_cache_key()
    mode = _wta_output_mode()
    shift = (
        _fuse_shift_for(max_cells, n_rows, pad_to) if mode == "fuse" else None
    )
    if shift is not None:
        fn = _wta_fused_fn(usa, shift, segred)
        with jax.enable_x64(True):
            out = fn(jnp.asarray(buf), ubits, gbits, n_rows, prefer_ambig)
        pending = PendingWtaFused(out[0], out[1:], n_rows, shift, pad_to)
    elif mode != "0":
        fn = _wta_compact_fn(usa, pack32, segred)
        with jax.enable_x64(True):
            out = fn(jnp.asarray(buf), ubits, gbits, n_rows, prefer_ambig)
        pending = PendingWta(out[0], out[1:], n_rows, pack32, pad_to)
    else:
        fn = _wta_plain_fn(usa, segred)
        with jax.enable_x64(True):
            out = fn(jnp.asarray(buf), ubits, gbits, n_rows, prefer_ambig)
        pending = PendingWtaFull(out, n_rows)
    return pending if async_ else pending.get()


def sharded_crlike_wta(
    mesh, keys_per_shard, ubits: int, gbits: int, n_rows: int,
    usa: bool = False, prefer_ambig: bool = False,
):
    """Run the WTA kernel data-parallel over a device mesh.

    ``keys_per_shard`` is a (n_shards, L) u64 array, each row one
    shard's padded key block split at CELL boundaries (a cell's triplets
    must live in exactly one shard).  ``usa``/``prefer_ambig`` select
    the USA tie-set slotting kernel.  Returns per-shard (out_key,
    out_cnt) blocks gathered to the host; no cross-shard collective is
    needed because cells are independent (SURVEY.md §2.3).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))

    @partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
    def run(blocks, ubits, gbits, n_rows, usa, pa):
        blocks = jax.lax.with_sharding_constraint(blocks, sharding)
        kern = (
            (lambda k: _kernel_usa(k, ubits, gbits, n_rows, pa))
            if usa else (lambda k: _kernel(k, ubits, gbits, n_rows))
        )
        ok, oc = jax.vmap(kern)(blocks)
        return (
            jax.lax.with_sharding_constraint(ok, sharding),
            jax.lax.with_sharding_constraint(oc, sharding),
        )

    with jax.enable_x64(True):
        ok, oc = run(
            jnp.asarray(keys_per_shard), ubits, gbits, n_rows, usa,
            prefer_ambig,
        )
        return np.asarray(ok), np.asarray(oc)
