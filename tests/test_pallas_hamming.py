"""Device Hamming<=1 rescue (ops/rescue_device.py) against the host
reference ``find_neighbors_batch``: counts always, the representative
wherever a neighbor exists (the smallest one, which is the unique one
where count == 1, the only case the rescue consumes)."""

import numpy as np
import pytest

from alevin_fry_tpu.ops import barcodes as bcops
from alevin_fry_tpu.ops.rescue_device import find_neighbors_searchsorted

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _case(length, seed, n_kept=1500):
    rng = np.random.RandomState(seed)
    top = ALL_ONES if length == 32 else np.uint64((1 << (2 * length)) - 1)
    kept = np.unique(
        rng.randint(0, 1 << 62, size=n_kept, dtype=np.uint64)
        & top
    )
    exact = rng.choice(kept, 60)
    muts = bcops.snp_neighbors(rng.choice(kept, 90), length)
    mutants = muts[np.arange(90), rng.randint(0, muts.shape[1], 90)]
    randoms = rng.randint(0, 1 << 62, size=200, dtype=np.uint64) & top
    queries = np.concatenate([exact, mutants, randoms])
    return queries, kept


def _assert_same(got, queries, kept, length):
    ref_cnt, ref_rep = bcops.find_neighbors_batch(queries, kept, length)
    cnt, rep = got
    np.testing.assert_array_equal(cnt, ref_cnt)
    hit = ref_cnt >= 1
    np.testing.assert_array_equal(rep[hit], ref_rep[hit])
    np.testing.assert_array_equal(rep[~hit], 0)


def test_searchsorted_device_matches_host_reference():
    length = 16
    queries, kept = _case(length, 23, n_kept=2000)
    # include the all-T barcode: its padded-table collision case
    allt = np.array([(1 << 32) - 1], np.uint64)
    queries = np.concatenate([queries, allt])
    _assert_same(
        find_neighbors_searchsorted(queries, kept, length), queries, kept, length
    )


@pytest.mark.parametrize("length", [8, 10, 12, 14, 16, 20, 24, 28, 31, 32])
def test_searchsorted_lengths_match_host(length):
    queries, kept = _case(length, 41 + length)
    _assert_same(
        find_neighbors_searchsorted(queries, kept, length), queries, kept, length
    )


@pytest.mark.parametrize("length", [16, 32])
def test_searchsorted_pad_aliasing(length):
    """The all-A (zero) and all-T barcodes alias the query pad (zero)
    and the kept pad (all-ones at 32 bases): both must count exactly
    as real barcodes, present or absent from the kept table."""
    allt = np.uint64((1 << (2 * length)) - 1) if length < 32 else ALL_ONES
    one_sub_a = np.uint64(1)  # A...AC: one substitution from all-A
    one_sub_t = allt ^ np.uint64(1)
    for kept in (
        np.array([0, allt], np.uint64),
        np.array([5], np.uint64),
        np.array([0], np.uint64),
        np.array([allt], np.uint64),
    ):
        queries = np.array([0, allt, one_sub_a, one_sub_t, 7], np.uint64)
        _assert_same(
            find_neighbors_searchsorted(queries, kept, length),
            queries, kept, length,
        )


def test_searchsorted_duplicate_queries_and_blocks(monkeypatch):
    """Duplicate queries and a batch spanning several query blocks
    (the block size shrunk so the CPU test stays small)."""
    from alevin_fry_tpu.ops import rescue_device

    monkeypatch.setattr(rescue_device, "_QBLOCK", 1024)
    queries, kept = _case(16, 5)
    queries = np.concatenate([queries, queries, queries[:500]] * 2)
    assert len(queries) > 2 * 1024
    _assert_same(
        find_neighbors_searchsorted(queries, kept, 16), queries, kept, 16
    )


@pytest.mark.parametrize(
    "nq,nk", [(0, 5), (3, 0), (0, 0)], ids=["no-queries", "no-kept", "neither"]
)
def test_searchsorted_empty_inputs(nq, nk):
    cnt, rep = find_neighbors_searchsorted(
        np.arange(nq, dtype=np.uint64), np.arange(nk, dtype=np.uint64), 8
    )
    np.testing.assert_array_equal(cnt, np.zeros(nq))
    np.testing.assert_array_equal(rep, np.zeros(nq))


def test_searchsorted_rejects_wide_barcodes():
    with pytest.raises(ValueError):
        find_neighbors_searchsorted(
            np.zeros(3, np.uint64), np.zeros(2, np.uint64), 33
        )


def test_find_neighbors_dispatcher_backends(monkeypatch):
    rng = np.random.RandomState(7)
    length = 12
    kept = np.sort(
        np.unique(rng.randint(0, 1 << 24, size=500).astype(np.uint64))
    )
    queries = np.concatenate([
        rng.choice(kept, 40),
        rng.randint(0, 1 << 24, size=100).astype(np.uint64),
    ])
    ref = bcops.find_neighbors_batch(queries, kept, length)
    for mode in ("host", "jax", "auto"):
        monkeypatch.setenv("AFT_RESCUE_BACKEND", mode)
        cnt, rep = bcops.find_neighbors(queries, kept, length)
        np.testing.assert_array_equal(cnt, ref[0])
        uniq = ref[0] == 1
        np.testing.assert_array_equal(rep[uniq], ref[1][uniq])


def test_find_neighbors_auto_choice(monkeypatch):
    """``auto`` sends a batch of >= 32k queries to the device program
    when an accelerator is present, and everything else to the host."""
    from alevin_fry_tpu.ops import crlike, rescue_device

    calls = []

    def fake_device(q, k, length):
        calls.append(len(q))
        return bcops.find_neighbors_batch(q, k, length)

    monkeypatch.setattr(rescue_device, "find_neighbors_searchsorted", fake_device)
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)
    kept = np.arange(0, 4000, 7, dtype=np.uint64)
    small = np.arange(100, dtype=np.uint64)
    big = np.arange(1 << 15, dtype=np.uint64)
    for present in (False, True):
        monkeypatch.setattr(crlike, "accelerator_present", lambda: present)
        bcops.find_neighbors(small, kept, 8)
        bcops.find_neighbors(big, kept, 8)
    assert calls == [1 << 15]


@pytest.mark.gpu
def test_rescue_on_gpu_matches_host():
    """On the card: the device program at a few hundred thousand
    queries against the native host search."""
    rng = np.random.RandomState(3)
    kept = np.unique(rng.randint(0, 1 << 32, size=200_000, dtype=np.uint64))
    muts = bcops.snp_neighbors(rng.choice(kept, 100_000), 16)
    queries = np.concatenate([
        muts[np.arange(100_000), rng.randint(0, 64, 100_000)],
        rng.randint(0, 1 << 32, size=200_000, dtype=np.uint64),
    ])
    _assert_same(
        find_neighbors_searchsorted(queries, kept, 16), queries, kept, 16
    )
