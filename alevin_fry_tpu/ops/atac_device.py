"""Device (JAX/XLA) sort + run-length dedup for the ATAC pipeline.

The reference sorts ``HitInfo{chr, start, frag_len, barcode}`` rows per
genomic-bin bucket (src/atac/sort.rs:45-131) and per cell with the cell
as the outer key (src/atac/deduplicate.rs:175-226), then run-length
counts duplicates.  The host path mirrors that with ``np.lexsort`` +
RLE; this module is the device equivalent: the integer sort columns
pack MSB-first into one-to-three u64 key words (a column never splits
across words, so multi-word lexicographic order equals column
lexicographic order), one jitted program sorts the words with
``lax.sort(num_keys=W)``, marks run starts, segment-sums the run
lengths, and compacts the unique rows to the front so the host fetches
only an nnz-sized prefix (same transfer discipline as
ops/crlike_device.py).

Dispatch: :func:`device_backend_enabled` follows the crlike pattern —
``AFT_ATAC_SORT_BACKEND`` = ``jax`` forces the device kernel, ``host``
disables it, ``auto`` (default) uses it whenever jax's default backend
is an accelerator.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .crlike_device import PAD, _pad_bucket

_MAX_WORDS = 3


def device_backend_enabled() -> bool:
    import os

    mode = os.environ.get("AFT_ATAC_SORT_BACKEND", "auto")
    if mode == "host":
        return False
    if mode == "jax":
        return True
    from .crlike import accelerator_present

    return accelerator_present()


def _bits_for(n: int) -> int:
    return max(int(n).bit_length(), 1)


def _pack_words(
    cols: Sequence[np.ndarray], widths: Sequence[int]
) -> Optional[List[np.ndarray]]:
    """Pack integer columns MSB-first into u64 words (greedy first-fit
    in column order; a column never splits across words).  Returns None
    when more than _MAX_WORDS words would be needed."""
    words: List[np.ndarray] = []
    layouts: List[List[Tuple[int, int]]] = []  # per word: (col idx, width)
    used = 0
    cur: List[Tuple[int, int]] = []
    for i, w in enumerate(widths):
        if w > 64:
            return None
        if used + w > 64:
            layouts.append(cur)
            cur = []
            used = 0
        cur.append((i, w))
        used += w
    layouts.append(cur)
    if len(layouts) > _MAX_WORDS:
        return None
    n = len(cols[0]) if cols else 0
    for lay in layouts:
        word = np.zeros(n, np.uint64)
        shift = sum(w for _, w in lay)
        for ci, w in lay:
            shift -= w
            word |= cols[ci].astype(np.uint64) << np.uint64(shift)
        words.append(word)
    return words, layouts  # type: ignore[return-value]


def _unpack_cols(
    words: Sequence[np.ndarray], layouts, n_cols: int
) -> List[np.ndarray]:
    out: List[np.ndarray] = [None] * n_cols  # type: ignore[list-item]
    for word, lay in zip(words, layouts):
        shift = sum(w for _, w in lay)
        for ci, w in lay:
            shift -= w
            out[ci] = (
                (word >> np.uint64(shift)) & np.uint64((1 << w) - 1)
            ).astype(np.int64)
    return out


@functools.lru_cache(maxsize=None)
def _sort_rle_fn(n_words: int):
    import jax
    import jax.numpy as jnp

    def kernel(*words):
        # words: n_words u64 arrays of length N; PAD rows sort last
        from .crlike_device import _seg_sum

        N = words[0].shape[0]
        ws = jax.lax.sort(words, num_keys=n_words)
        valid = ws[0] != PAD
        new = jnp.ones(N, bool)
        neq = jnp.zeros(N - 1, bool)
        for w in ws:
            neq = neq | (w[1:] != w[:-1])
        new = new.at[1:].set(neq)
        new = new & valid
        # run lengths via the scatter-free contiguous-segment sum
        # (ops/crlike_device.py toolkit) — replaces a 4M-row scatter-add
        # plus a 4M-row gather
        counts = _seg_sum(valid.astype(jnp.int32), new)
        nnz = new.sum(dtype=jnp.int32)
        # compact: stable-move run-start rows to the front in order
        pos = jnp.arange(N, dtype=jnp.uint64)
        skey = jnp.where(new, pos, PAD)
        packed = jax.lax.sort(
            (skey,) + ws + (jnp.where(new, counts, 0),), num_keys=1
        )
        return (nnz,) + packed[1:]

    return jax.jit(kernel)


class PendingSortRle:
    """A submitted-but-unfetched device sort+RLE; ``get()`` fetches the
    nnz-sized prefix and unpacks the original columns."""

    def __init__(self, nnz_dev, word_devs, cnt_dev, layouts, n_cols, pad_to):
        self._nnz = nnz_dev
        self._words = word_devs
        self._cnt = cnt_dev
        self._layouts = layouts
        self._n_cols = n_cols
        self._pad_to = pad_to

    def get(self):
        from .crlike_device import _fetch_prefix

        nnz = int(np.asarray(self._nnz))
        words = [
            _fetch_prefix(w, nnz, self._pad_to) for w in self._words
        ]
        counts = _fetch_prefix(self._cnt, nnz, self._pad_to)
        self._words = self._cnt = None
        cols = _unpack_cols(words, self._layouts, self._n_cols)
        return cols, counts.astype(np.int64)


def sort_rle_host(cols: Sequence[np.ndarray]):
    """Host lexicographic sort + RLE over packed u64 words: the same
    MSB-first packing as the device kernel halves the lexsort key count
    (4-5 integer columns usually fit 2 words), which is the dominant
    cost of the ATAC sort stage.  Falls back to a raw-column lexsort
    when the columns exceed the word budget."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return [c[:0] for c in cols], np.zeros(0, np.int64)
    maxes = [int(np.max(c)) if len(c) else 0 for c in cols]
    packed = None
    if all(int(np.min(c)) >= 0 for c in cols):
        widths = [_bits_for(m + 1) for m in maxes]
        packed = _pack_words(list(cols), widths)
    if packed is None:
        order = np.lexsort(tuple(cols[::-1]))
        sc = [np.asarray(c)[order] for c in cols]
        neq = np.zeros(n - 1, bool)
        for c in sc:
            neq |= c[1:] != c[:-1]
        new = np.ones(n, bool)
        new[1:] = neq
        si = np.flatnonzero(new)
        counts = np.diff(np.append(si, n))
        return [c[si] for c in sc], counts
    words, layouts = packed
    if len(words) == 1:
        # one packed key: the fused threaded native sort+RLE kernel
        # returns (uniq, counts) directly (same path crlike's dedup
        # uses)
        from .crlike import _sort_unique_counts

        uniq, counts = _sort_unique_counts(
            words[0], np.asarray([0, n], np.int64)
        )
        return _unpack_cols([uniq], layouts, len(cols)), counts
    if len(words) == 2:
        # two packed words: the fused native 2-word sort + RLE + unpack
        # replaces the lexsort/compare/shift-mask chain below (measured
        # the bulk of the ATAC sort and dedup host stages)
        from ..radz import _native

        if _native.available():
            n_cols = len(cols)
            word_idx = np.empty(n_cols, np.int32)
            shifts_pc = np.empty(n_cols, np.int32)
            widths_pc = np.empty(n_cols, np.int32)
            for wi, lay in enumerate(layouts):
                shift = sum(w for _, w in lay)
                for ci, w in lay:
                    shift -= w
                    word_idx[ci] = wi
                    shifts_pc[ci] = shift
                    widths_pc[ci] = w
            ucols, counts = _native.sort2_rle_unpack(
                words[0], words[1], word_idx, shifts_pc, widths_pc
            )
            return ucols, counts
    order = np.lexsort(tuple(words[::-1]))
    sw = [w[order] for w in words]
    neq = np.zeros(n - 1, bool)
    for w in sw:
        neq |= w[1:] != w[:-1]
    new = np.ones(n, bool)
    new[1:] = neq
    si = np.flatnonzero(new)
    counts = np.diff(np.append(si, n))
    return _unpack_cols([w[si] for w in sw], layouts, len(cols)), counts


def sort_rle(cols: Sequence[np.ndarray]):
    """Backend dispatch: the device segmented sort+RLE when enabled and
    eligible, else the packed-word host sort.  Identical output either
    way (== np.lexsort(cols[::-1]) + run-length counts)."""
    if device_backend_enabled():
        got = sort_rle_device(cols)
        if got is not None:
            return got
    return sort_rle_host(cols)


def sort_rle_device(
    cols: Sequence[np.ndarray], async_: bool = False
):
    """Lexicographic sort of integer columns + run-length counts on
    device.  Returns (sorted_unique_cols, counts) — identical to
    ``np.lexsort(cols[::-1])`` + RLE — or None when the columns exceed
    the u64 word budget or are empty (caller falls back to host).
    """
    import jax
    import jax.numpy as jnp

    n = len(cols[0]) if cols else 0
    if n == 0:
        return None
    maxes = [int(np.max(c)) if len(c) else 0 for c in cols]
    if any(int(np.min(c)) < 0 for c in cols):
        return None
    widths = [_bits_for(m + 1) for m in maxes]
    packed = _pack_words(list(cols), widths)
    if packed is None:
        return None
    words, layouts = packed
    # reserve the all-ones pattern for PAD: if a row could equal PAD in
    # word 0, widen by one bit via the width list (cheap retry)
    if len(layouts[0]) and sum(w for _, w in layouts[0]) == 64:
        if int(words[0].max()) == int(PAD):
            return None
    pad_to = _pad_bucket(n)
    bufs = []
    for w in words:
        b = np.full(pad_to, PAD, np.uint64)
        b[:n] = w
        bufs.append(b)
    fn = _sort_rle_fn(len(words))
    with jax.enable_x64(True):
        out = fn(*[jnp.asarray(b) for b in bufs])
    pending = PendingSortRle(
        out[0], out[1 : 1 + len(words)], out[-1], layouts, len(cols), pad_to
    )
    return pending if async_ else pending.get()
