"""Device kernels on the card against their host references.

Marked ``gpu``: they skip without an NVIDIA GPU and run on the card
through ``python chip_smoke.py`` (phase 7) or
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests``.  The CPU tests of
the same kernels run their XLA programs on the CPU backend."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _wta_case(rng, n=200_000, n_cells=3000, n_genes=36_601):
    c = np.sort(rng.randint(0, n_cells, n)).astype(np.uint64)
    u = rng.randint(0, 1 << 24, n).astype(np.uint64)
    nal = np.where(rng.rand(n) < 0.8, 1, 2)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(nal, out=offs[1:])
    refs = rng.randint(0, 4 * n_genes, int(offs[-1])).astype(np.uint32)
    return c, u, refs, offs


@pytest.mark.parametrize("usa", [False, True], ids=["plain", "usa"])
def test_wta_device_matches_native(usa):
    from alevin_fry_tpu.ops import crlike

    n_genes = 36_601
    c, u, refs, offs = _wta_case(np.random.RandomState(3), n_genes=n_genes)
    tx = np.arange(4 * n_genes)
    if usa:
        t2g = (2 * (tx // 4) + tx % 2).astype(np.uint32)
        nr = 3 * n_genes
        usa_off = (nr // 3, 2 * (nr // 3))
    else:
        t2g = (tx // 4).astype(np.uint32)
        nr, usa_off = n_genes, None
    want = crlike.wta_counts_native(c, u, refs, offs, t2g, nr, usa_offsets=usa_off)
    got = crlike.wta_counts_device(c, u, refs, offs, t2g, nr, usa=usa)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dense_em_matches_numpy():
    from alevin_fry_tpu.ops.em import em_cells_batched

    rng = np.random.RandomState(0)
    R = 2000
    ceo, lo, labs, cts = [0], [0], [], []
    for _ in range(300):
        ne = rng.randint(2, 60)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labs += rng.choice(R, ll, replace=False).tolist()
            lo.append(lo[-1] + ll)
            cts.append(rng.randint(1, 20))
        ceo.append(ceo[-1] + ne)
    args = (np.asarray(ceo, np.int64), np.asarray(lo, np.int64),
            np.asarray(labs, np.uint32), np.asarray(cts, np.uint32), R, None,
            False, True)
    want = em_cells_batched(*args, use_jax=False)
    got = em_cells_batched(*args, use_jax=True)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=2e-4)


def test_atac_sort_rle_device_matches_host():
    from alevin_fry_tpu.ops import atac_device

    rng = np.random.RandomState(5)
    n = 500_000
    cols = [rng.randint(0, 24, n), rng.randint(0, 200_000_000, n),
            rng.randint(30, 1000, n), rng.randint(0, 1 << 32, n)]
    cols = [np.concatenate([c, c[: n // 5]]).astype(np.int64) for c in cols]
    wc, wn = atac_device.sort_rle_host(cols)
    gc, gn = atac_device.sort_rle_device(cols)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gn, wn)


def test_collation_order_device_matches_argsort():
    from alevin_fry_tpu.pipeline.collate import collation_order_device

    ranks = np.random.RandomState(2).randint(0, 5000, 2_000_000).astype(np.int64)
    order, per_cell = collation_order_device(ranks, 5000)
    np.testing.assert_array_equal(order, np.argsort(ranks, kind="stable"))
    np.testing.assert_array_equal(per_cell, np.bincount(ranks, minlength=5000))
