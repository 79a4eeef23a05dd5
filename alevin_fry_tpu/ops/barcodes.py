"""2-bit packed barcode utilities and batched 1-edit correction.

The reference encodes barcodes as 2-bit packed u64 (A=0, C=1, G=2, T=3;
needletail ``BitNuclKmer``; ``cb_string_to_u64`` at src/convert.rs:75-89
maps N->A).  One-edit machinery:

* substitution (SNP) and indel neighbor generation mirror
  src/utils.rs:917-981 (``get_all_snps`` / ``get_all_indels``), with
  position index counted from the *right* (LSB end).
* ``generate_permitlist_map`` (src/utils.rs:1026-1051) maps every 1-edit
  neighbor of a permitted barcode back to that barcode, exact entries
  first, and on contested neighbors first-writer-wins.  The reference's
  "first" follows seeded-hash iteration order; we instead use an explicit
  priority order supplied by the caller (descending frequency, then
  ascending barcode) which is deterministic and documented.
* ``find_neighbors_batch`` is the unfiltered-list rescue kernel: for a
  batch of query barcodes, count permitted barcodes within Hamming
  distance 1 (substitutions only — matching libradicl's
  ``BarcodeLookupMap::find_neighbors`` as used at src/cellfilter.rs:198-233)
  and return the unique neighbor when there is exactly one.

All kernels are batched array programs (gather/sort/searchsorted); on
an accelerator the rescue's membership tests run as one XLA program
per query block (ops/rescue_device.py).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

_ASCII_TO_2BIT = np.full(256, 255, np.uint8)
for _b, _v in zip(b"ACGT", range(4)):
    _ASCII_TO_2BIT[_b] = _v
for _b, _v in zip(b"acgt", range(4)):
    _ASCII_TO_2BIT[_b] = _v
_ASCII_TO_2BIT[ord("N")] = 0  # N -> A (cb_string_to_u64, src/convert.rs:80)
_ASCII_TO_2BIT[ord("n")] = 0

_BASES = np.frombuffer(b"ACGT", np.uint8)


def pack_seq(seq: str) -> int:
    """Pack a single nucleotide string into a 2-bit u64 (A=0 C=1 G=2 T=3)."""
    v = 0
    for ch in seq:
        v = (v << 2) | int(_ASCII_TO_2BIT[ord(ch)])
    return v


def pack_seqs(lines: Iterable[bytes | str], length: int | None = None) -> np.ndarray:
    """Vectorized packing of equal-length sequences; returns uint64 array."""
    rows = [l.encode() if isinstance(l, str) else l for l in lines]
    if not rows:
        return np.zeros(0, np.uint64)
    if length is None:
        length = len(rows[0])
    mat = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, length)
    codes = _ASCII_TO_2BIT[mat].astype(np.uint64)
    shifts = np.uint64(2) * np.arange(length - 1, -1, -1, dtype=np.uint64)
    return (codes << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def unpack_seq(bc: int, length: int) -> str:
    out = []
    for i in range(length - 1, -1, -1):
        out.append("ACGT"[(int(bc) >> (2 * i)) & 3])
    return "".join(out)


def unpack_seqs(bcs: np.ndarray, length: int) -> np.ndarray:
    """Vectorized unpacking to an (n, length) uint8 ASCII matrix."""
    bcs = np.asarray(bcs, np.uint64)
    shifts = np.uint64(2) * np.arange(length - 1, -1, -1, dtype=np.uint64)
    codes = ((bcs[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return _BASES[codes]


def unpack_seqs_to_strings(bcs: np.ndarray, length: int) -> list:
    mat = unpack_seqs(bcs, length)
    return [bytes(row).decode() for row in mat]


def revcomp_packed(bcs: np.ndarray, length: int) -> np.ndarray:
    """Reverse-complement 2-bit packed barcodes (vectorized)."""
    bcs = np.asarray(bcs, np.uint64)
    out = np.zeros_like(bcs)
    for i in range(length):
        base = (bcs >> np.uint64(2 * i)) & np.uint64(3)
        comp = base ^ np.uint64(3)  # A<->T, C<->G under 2-bit encoding
        out |= comp << np.uint64(2 * (length - 1 - i))
    return out


def hamming_2bit(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between 2-bit packed sequences
    (reference: count_diff_2_bit_packed, src/utils.rs:372-376)."""
    x = np.bitwise_xor(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
    two_bit = (x | (x >> np.uint64(1))) & np.uint64(0x5555555555555555)
    return popcount_u64(two_bit)


def popcount_u64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    return np.unpackbits(x.view(np.uint8).reshape(-1, 8), axis=1).sum(axis=1)


# --- neighbor generation ----------------------------------------------------

def snp_neighbors(bcs: np.ndarray, length: int) -> np.ndarray:
    """All substitution variants of each barcode, including the barcode
    itself at positions where the substituted base equals the original.
    Returns (n, 4*length) uint64 (callers filter self-matches as needed).
    Matches the neighbor *set* of get_all_snps (src/utils.rs:917-943)."""
    bcs = np.asarray(bcs, np.uint64)
    n = len(bcs)
    out = np.empty((n, 4 * length), np.uint64)
    col = 0
    for nt_index in range(1, length + 1):
        clear_mask = ~(np.uint64(3) << np.uint64(2 * (nt_index - 1)))
        cleared = bcs & clear_mask
        for i in range(4):
            out[:, col] = cleared | (np.uint64(i) << np.uint64(2 * (nt_index - 1)))
            col += 1
    return out


def indel_neighbors(bcs: np.ndarray, length: int) -> np.ndarray:
    """All 1-indel variants (insertion + deletion at interior positions),
    matching the set produced by get_all_indels (src/utils.rs:945-981).
    Returns (n, 8*(length-1)) uint64; may contain the original barcode."""
    bcs = np.asarray(bcs, np.uint64)
    n = len(bcs)
    out = np.empty((n, 8 * (length - 1)), np.uint64)
    col = 0
    for nt_index in range(1, length):
        bit_mask = np.uint64((1 << (2 * nt_index)) - 1)
        upper = bcs & ~bit_mask
        lower = bcs & bit_mask
        for i in range(4):
            ins = (
                upper
                | (np.uint64(i) << np.uint64(2 * (nt_index - 1)))
                | (lower >> np.uint64(2))
            )
            del_mask = ~(np.uint64(3) << np.uint64(2 * nt_index))
            dele = (
                upper
                | np.uint64(i)
                | ((lower & del_mask) << np.uint64(2))
            )
            out[:, col] = ins
            out[:, col + 1] = dele
            col += 2
    return out


def get_all_snps(bc: int, length: int) -> np.ndarray:
    """Scalar helper matching get_all_snps exactly (excludes self)."""
    nb = snp_neighbors(np.asarray([bc], np.uint64), length)[0]
    return nb[nb != np.uint64(bc)]


def get_all_indels(bc: int, length: int) -> np.ndarray:
    nb = indel_neighbors(np.asarray([bc], np.uint64), length)[0]
    return nb[nb != np.uint64(bc)]


def generate_permitlist_map(
    permit_bcs: np.ndarray, length: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the (neighbor -> permitted barcode) correction map.

    ``permit_bcs`` must already be in priority order: on a contested
    neighbor the earlier barcode wins (the reference's first-wins over
    hash iteration order, src/utils.rs:1043-1048).  Exact permit entries
    always map to themselves.  Returns (keys, values) arrays.
    """
    permit_bcs = np.asarray(permit_bcs, np.uint64)
    k = len(permit_bcs)
    if k == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    snps = snp_neighbors(permit_bcs, length)
    inds = indel_neighbors(permit_bcs, length)
    neigh = np.concatenate([snps, inds], axis=1)
    m = neigh.shape[1]
    owners = np.repeat(np.arange(k, dtype=np.int64), m)
    flat = neigh.reshape(-1)
    # drop self-neighbors (they're re-added as exact entries with top priority)
    keep = flat != permit_bcs[owners]
    flat, owners = flat[keep], owners[keep]
    # exact entries get priority rank -1 (always win)
    keys = np.concatenate([permit_bcs, flat])
    prio = np.concatenate([np.full(k, -1, np.int64), owners])
    vals = np.concatenate([permit_bcs, permit_bcs[owners]])
    # first-wins: stable sort by (key, priority) and keep the first of
    # each key group
    order = np.lexsort((prio, keys))
    keys, vals = keys[order], vals[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], vals[first]


def find_neighbors_batch(
    queries: np.ndarray, kept_sorted: np.ndarray, length: int,
    block: int = 1 << 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each query barcode, count kept barcodes within Hamming
    distance <= 1 (substitutions, including exact) and return a
    representative hit.

    Returns (neighbor_counts[int64], representative[uint64]); the
    representative is only meaningful where count >= 1 (and unique where
    count == 1, which is the only case the rescue logic uses,
    src/cellfilter.rs:198-233).
    """
    queries = np.asarray(queries, np.uint64)
    kept_sorted = np.asarray(kept_sorted, np.uint64)
    counts = np.zeros(len(queries), np.int64)
    rep = np.zeros(len(queries), np.uint64)
    if len(kept_sorted) == 0:
        return counts, rep
    from ..radz import _native

    if _native.available():
        return _native.find_neighbors(queries, kept_sorted, length)
    for s in range(0, len(queries), block):
        q = queries[s : s + block]
        cand = snp_neighbors(q, length)  # (b, 4L) includes exact copies
        # dedup within each row: the 4 variants per position include the
        # original base, so the query itself appears `length` times.
        # Sort each row so duplicates are adjacent and count unique hits.
        cand_sorted = np.sort(cand, axis=1)
        uniq = np.ones_like(cand_sorted, dtype=bool)
        uniq[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
        idx = np.searchsorted(kept_sorted, cand_sorted)
        idx_c = np.minimum(idx, len(kept_sorted) - 1) if len(kept_sorted) else idx
        hit = (
            (len(kept_sorted) > 0)
            & (idx < len(kept_sorted))
            & (kept_sorted[idx_c] == cand_sorted)
            & uniq
        )
        counts[s : s + block] = hit.sum(axis=1)
        # representative: first hit per row (sorted order -> smallest)
        any_hit = hit.any(axis=1)
        firstcol = np.argmax(hit, axis=1)
        reps = cand_sorted[np.arange(len(q)), firstcol]
        rep[s : s + block] = np.where(any_hit, reps, np.uint64(0))
    return counts, rep


def find_neighbors(
    queries: np.ndarray, kept_sorted: np.ndarray, length: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Backend-dispatched Hamming<=1 rescue search: the production
    entry point for the unfiltered-permit-list rescue
    (src/cellfilter.rs:190-233).

    ``AFT_RESCUE_BACKEND`` selects the engine:

    * ``host`` - native C++/NumPy variant expansion + binary search;
    * ``jax``  - the device searchsorted program
      (ops/rescue_device.py), the same algorithm as one XLA program
      per query block;
    * ``auto`` (default) - the device program on an accelerator when
      the batch holds at least 32k queries, the host path otherwise.

    Every backend implements the same contract and is tested against
    the host path (tests/test_pallas_hamming.py)."""
    import os

    from .crlike import accelerator_present

    mode = os.environ.get("AFT_RESCUE_BACKEND", "auto")
    if len(queries) and len(kept_sorted) and (
        mode == "jax"
        or (mode == "auto" and len(queries) >= (1 << 15) and accelerator_present())
    ):
        from .rescue_device import find_neighbors_searchsorted

        return find_neighbors_searchsorted(queries, kept_sorted, length)
    return find_neighbors_batch(queries, kept_sorted, length)
