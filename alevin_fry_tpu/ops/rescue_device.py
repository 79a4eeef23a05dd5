"""Device Hamming<=1 barcode rescue.

The unfiltered-permit-list rescue asks, for every unmatched barcode,
how many *kept* barcodes lie within Hamming distance 1 (substitutions
over the 2-bit encoding, distance 0 included) and which one, when it
is unique (cellfilter.rs:198-233 via BarcodeLookupMap).  Same contract
as ``ops.barcodes.find_neighbors_batch``: ``(counts, rep)`` with
``rep`` the smallest neighbor wherever ``counts >= 1``.

``find_neighbors_searchsorted`` is one XLA program per query block:
each query expands to itself plus its 3L substitution variants (base
code XOR 1, 2 or 3 at each position, so all 3L+1 are distinct and need
no dedup), and every variant is binary-searched in the replicated
sorted kept table.  Work is O(Q * L * log K) gathers over 64-bit keys,
so barcodes of up to 32 bases fit.

A one-hot contraction on the tensor cores (distance = L - matches, one
(Q x 4L) @ (4L x K) bf16 product with the count/min-index epilogue
fused in a Pallas/Triton kernel) was measured against this program on
an H100 and lost at every shape tried (PERF.md, Findings), so only the
binary-search form is kept.
"""

from __future__ import annotations

import functools

import numpy as np

_QBLOCK = 1 << 18  # queries per dispatch: bounds the (Q, 3L+1) intermediates
_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _searchsorted_fn(length: int):
    import jax
    import jax.numpy as jnp

    def run(q, kept, nk):
        # q: (Qb,) u64 queries; kept: (Kp,) u64 sorted, padded at the
        # high end with all-ones.  A 32-base all-T barcode IS all-ones,
        # so hits are masked to idx < nk rather than by value.
        shifts = jnp.arange(length, dtype=jnp.uint64) * jnp.uint64(2)
        flips = jnp.arange(1, 4, dtype=jnp.uint64)
        var = q[:, None, None] ^ (flips[None, None, :] << shifts[None, :, None])
        var = jnp.concatenate([q[:, None], var.reshape(q.shape[0], -1)], axis=1)
        idx = jnp.searchsorted(kept, var)
        found = kept[jnp.minimum(idx, kept.shape[0] - 1)]
        hit = (idx < nk) & (found == var)
        counts = hit.sum(axis=1, dtype=jnp.int32)
        rep = jnp.where(hit, var, jnp.uint64(_ALL_ONES)).min(axis=1)
        return counts, rep

    return jax.jit(run)


def find_neighbors_searchsorted(
    queries: np.ndarray, kept_sorted: np.ndarray, length: int
):
    """Device Hamming<=1 search for barcodes of 1..32 bases; same
    contract as ``ops.barcodes.find_neighbors_batch``.  ``kept_sorted``
    must be sorted ascending and duplicate-free."""
    import jax
    import jax.numpy as jnp

    if not 1 <= length <= 32:
        raise ValueError(f"barcode length {length} does not fit 64 bits")
    queries = np.asarray(queries, np.uint64)
    kept_sorted = np.asarray(kept_sorted, np.uint64)
    nq, nk = len(queries), len(kept_sorted)
    if nq == 0 or nk == 0:
        return np.zeros(nq, np.int64), np.zeros(nq, np.uint64)

    kcap = max(1024, 1 << (nk - 1).bit_length())
    kp = np.full(kcap, _ALL_ONES, np.uint64)
    kp[:nk] = kept_sorted
    qblock = min(_QBLOCK, max(1024, 1 << (nq - 1).bit_length()))
    fn = _searchsorted_fn(length)
    pending = []
    with jax.enable_x64(True):
        kp_dev = jnp.asarray(kp)  # uploaded once, reused by every block
        for s in range(0, nq, qblock):
            blk = queries[s : s + qblock]
            qp = np.zeros(qblock, np.uint64)
            qp[: len(blk)] = blk
            pending.append(fn(jnp.asarray(qp), kp_dev, np.int64(nk)))
        cnt = np.concatenate([np.asarray(c) for c, _ in pending])[:nq]
        rep = np.concatenate([np.asarray(r) for _, r in pending])[:nq]
    cnt = cnt.astype(np.int64)
    return cnt, np.where(cnt > 0, rep, np.uint64(0))
