"""EM kernel tests: reference semantics (hand-computed cases) and
NumPy-vs-JAX implementation agreement."""

import numpy as np
import pytest

from alevin_fry_tpu.ops.em import em_cells_batched, em_optimize_cell_np


def _em_np(label_lists, counts, R, usa=None, uniform=False, last_round=True):
    offs = np.zeros(len(label_lists) + 1, np.int64)
    for i, l in enumerate(label_lists):
        offs[i + 1] = offs[i] + len(l)
    labels = np.concatenate([np.asarray(l, np.uint32) for l in label_lists]) \
        if label_lists else np.zeros(0, np.uint32)
    return em_optimize_cell_np(
        offs, labels, np.asarray(counts, np.uint32), R, usa, uniform, last_round
    )


def test_unique_only_shortcut():
    # all singleton classes -> direct counts, no EM
    out = _em_np([[0], [2], [0]], [3, 5, 2], 4)
    np.testing.assert_array_equal(out, [5, 0, 5, 0])


def test_em_splits_multimappers():
    # 10 unique on gene0, 10 unique on gene1, 10 shared between them:
    # EM splits the shared class evenly (informative init is symmetric)
    out = _em_np([[0], [1], [0, 1]], [10, 10, 10], 2)
    assert abs(out[0] - 15.0) < 0.1
    assert abs(out[1] - 15.0) < 0.1
    assert abs(out.sum() - 30.0) < 1e-3


def test_em_asymmetric():
    # strong evidence for gene0 pulls the ambiguous mass toward it
    out = _em_np([[0], [1], [0, 1]], [90, 10, 20], 2)
    assert out[0] > 105  # most of the 20 go to gene 0
    assert abs(out.sum() - 120.0) < 0.05


def test_min_output_floor():
    # tiny abundances are floored to zero (MIN_OUTPUT_ALPHA = 0.01)
    out = _em_np([[0], [0, 1]], [1000, 1], 2)
    assert out[1] == 0.0 or out[1] >= 0.01


def test_usa_abundance_coupling():
    # USA offsets: R=6 (2 genes x S/U/A); spliced idx 0, unspliced 2,
    # ambiguous 4 belong to gene 0.  A class over {0} and one ambiguous
    # class over {0, 1}: the USA abundance for slot 0 includes the
    # ambiguous mass.
    R = 6
    usa = (2, 4)
    out = _em_np([[0], [4], [0, 1]], [10, 5, 4], R, usa=usa)
    assert abs(out.sum() - 19.0) < 0.05
    assert out[0] > out[1]  # slot 0 (with its ambig partner) wins the split


@pytest.mark.parametrize("usa", [None, (4, 8)])
@pytest.mark.parametrize("with_last_round", [True, False])
def test_jax_matches_numpy(usa, with_last_round):
    rng = np.random.RandomState(42)
    R = 12
    C = 17
    cell_eq_offsets = [0]
    lab_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(1, 9)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lab_offsets.append(len(labels))
            counts.append(rng.randint(1, 20))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    cell_eq_offsets = np.asarray(cell_eq_offsets, np.int64)
    lab_offsets = np.asarray(lab_offsets, np.int64)
    labels = np.asarray(labels, np.uint32)
    counts = np.asarray(counts, np.uint32)

    res_np = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False,
        with_last_round, use_jax=False,
    )
    res_jx = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False,
        with_last_round, use_jax=True,
    )
    for ci, ((ni, nv), (ji, jv)) in enumerate(zip(res_np, res_jx)):
        np.testing.assert_array_equal(ni, ji, err_msg=f"cell {ci} support")
        np.testing.assert_allclose(nv, jv, rtol=2e-4, atol=2e-4,
                                   err_msg=f"cell {ci} values")


def test_weighted_em_jax_matches_numpy():
    """The long-read per-label-weighted E-step (em.rs:716-844) through
    the batched device kernel matches the per-cell NumPy path."""
    rng = np.random.RandomState(5)
    R = 10
    C = 13
    cell_eq_offsets = [0]
    lab_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(1, 7)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lab_offsets.append(len(labels))
            counts.append(rng.randint(1, 15))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    cell_eq_offsets = np.asarray(cell_eq_offsets, np.int64)
    lab_offsets = np.asarray(lab_offsets, np.int64)
    labels = np.asarray(labels, np.uint32)
    counts = np.asarray(counts, np.uint32)
    weights = rng.uniform(0.05, 1.0, size=len(labels)).astype(np.float32)

    res_np = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, None, False,
        False, use_jax=False, class_weights=weights,
    )
    res_jx = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, None, False,
        False, use_jax=True, class_weights=weights,
    )
    for ci, ((ni, nv), (ji, jv)) in enumerate(zip(res_np, res_jx)):
        np.testing.assert_array_equal(ni, ji, err_msg=f"cell {ci} support")
        np.testing.assert_allclose(nv, jv, rtol=2e-4, atol=2e-4,
                                   err_msg=f"cell {ci} values")
    # weighted != unweighted on at least one multi-label cell
    res_un = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, None, False,
        False, use_jax=False,
    )
    diff = any(
        len(a[1]) != len(b[1]) or not np.allclose(a[1], b[1])
        for a, b in zip(res_np, res_un)
    )
    assert diff


def test_count_conservation():
    rng = np.random.RandomState(3)
    R = 30
    label_lists = []
    counts = []
    for _ in range(50):
        ll = rng.randint(1, 5)
        label_lists.append(rng.choice(R, size=ll, replace=False))
        counts.append(rng.randint(1, 50))
    out = _em_np(label_lists, counts, R)
    # total mass conserved up to the output floor
    assert abs(out.sum() - sum(counts)) < 0.05 * len(counts)


@pytest.mark.parametrize("usa", [None, (100, 200)])
@pytest.mark.parametrize("with_last_round", [True, False])
def test_compact_kernel_matches_full_and_numpy(usa, with_last_round, monkeypatch):
    """The compact-gene-space device kernel (per-cell local
    dictionaries, ops/em.py::_get_em_kernel_compact) must agree with
    both the full-space device kernel and the per-cell NumPy reference
    at a gene-space size that actually engages it (U + 1 < R)."""
    rng = np.random.RandomState(3)
    R = 300  # >> the padded dictionary width
    C = 23
    cell_eq_offsets = [0]
    lab_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(1, 10)
        for _ in range(ne):
            ll = rng.randint(1, 5)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lab_offsets.append(len(labels))
            counts.append(rng.randint(1, 25))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    cell_eq_offsets = np.asarray(cell_eq_offsets, np.int64)
    lab_offsets = np.asarray(lab_offsets, np.int64)
    labels = np.asarray(labels, np.uint32)
    counts = np.asarray(counts, np.uint32)

    res_np = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False,
        with_last_round, use_jax=False,
    )
    monkeypatch.setenv("AFT_EM_COMPACT", "1")
    res_c = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False,
        with_last_round, use_jax=True,
    )
    monkeypatch.setenv("AFT_EM_COMPACT", "0")
    res_f = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False,
        with_last_round, use_jax=True,
    )
    for ci, ((ni, nv), (jci, jcv), (jfi, jfv)) in enumerate(
        zip(res_np, res_c, res_f)
    ):
        np.testing.assert_array_equal(ni, jci, err_msg=f"cell {ci} support")
        np.testing.assert_allclose(nv, jcv, rtol=2e-4, atol=2e-4,
                                   err_msg=f"cell {ci} values")
        np.testing.assert_array_equal(jfi, jci, err_msg=f"cell {ci} full/compact")
        np.testing.assert_allclose(jfv, jcv, rtol=2e-4, atol=2e-4)


def test_compact_local_ids_partner_coverage():
    """USA partner ids must always resolve inside the dictionary: for
    every label, its one- and two-shift coupling partners
    (em.rs:94-114) map to real local slots, and local ids round-trip
    to the original global ids."""
    from alevin_fry_tpu.ops.em import compact_local_ids

    rng = np.random.RandomState(9)
    R, uoff, aoff = 300, 100, 200
    lab = rng.randint(0, R, (5, 7, 3)).astype(np.int64)
    lab[0, 0, :] = R  # pad slots
    lab_loc, p1, p2, U = compact_local_ids(lab, R, (uoff, aoff))
    assert lab_loc.max() <= U and p1.max() <= U and p2.max() <= U
    # reconstruct dictionaries per row and check the mapping
    for b in range(5):
        ids = lab[b].ravel()
        ids = ids[ids < R]
        amb = ids >= aoff
        uns = (ids >= uoff) & ~amb
        p1g = np.where(amb, ids - uoff, np.where(uns, ids + uoff, ids + aoff))
        p2g = ids[amb] - aoff
        want = np.unique(np.concatenate([ids, p1g, p2g]))
        d = np.full(U + 1, R)
        d[np.sort(np.unique(lab_loc[b][lab[b] < R]))] = 0  # touched slots exist
        # every global id and partner resolves to a slot < U
        got_lab = lab_loc[b][lab[b] < R]
        assert (got_lab < U).all()
        assert len(want) <= U


@pytest.mark.parametrize("dmode", ["onehot", "vpu", "factored"])
@pytest.mark.parametrize("usa", [None, (100, 200)])
def test_dense_mxu_kernel_matches_gather(usa, dmode, monkeypatch):
    """Every dense EM formulation (AFT_EM_DENSE=1 x AFT_EM_DENSE_MODE:
    materialized one-hot matvecs, fused VPU compare-select, and the
    two-digit factored bf16 matmuls) must agree with the compact gather
    kernel and the NumPy reference — they are the same linear maps."""
    monkeypatch.setenv("AFT_EM_DENSE_MODE", dmode)
    rng = np.random.RandomState(13)
    R = 300
    C = 31
    cell_eq_offsets = [0]
    lab_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(1, 12)
        for _ in range(ne):
            ll = rng.randint(1, 5)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lab_offsets.append(len(labels))
            counts.append(rng.randint(1, 25))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    cell_eq_offsets = np.asarray(cell_eq_offsets, np.int64)
    lab_offsets = np.asarray(lab_offsets, np.int64)
    labels = np.asarray(labels, np.uint32)
    counts = np.asarray(counts, np.uint32)

    res_np = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False, True,
        use_jax=False,
    )
    monkeypatch.setenv("AFT_EM_DENSE", "1")
    res_d = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False, True,
        use_jax=True,
    )
    monkeypatch.setenv("AFT_EM_DENSE", "0")
    res_g = em_cells_batched(
        cell_eq_offsets, lab_offsets, labels, counts, R, usa, False, True,
        use_jax=True,
    )
    for ci, ((ni, nv), (di, dv), (gi, gv)) in enumerate(
        zip(res_np, res_d, res_g)
    ):
        np.testing.assert_array_equal(ni, di, err_msg=f"cell {ci} support")
        np.testing.assert_allclose(nv, dv, rtol=2e-4, atol=2e-4,
                                   err_msg=f"cell {ci} values")
        np.testing.assert_array_equal(gi, di)
        np.testing.assert_allclose(gv, dv, rtol=2e-4, atol=2e-4)


def test_bootstrap_jax_compact_matches_numpy_stats(monkeypatch):
    """The device bootstrap path (forced AFT_BOOT_BACKEND=jax; compact
    dictionaries + dense one-hot rounds) must produce replicate means close
    to the NumPy backend's: the multinomial resamples are identical
    per-cell host RNG streams, only the EM init generator differs, and
    the EM converges to the same optimum."""
    from alevin_fry_tpu.ops.bootstrap import run_bootstraps
    from alevin_fry_tpu.ops.crlike import CellEqClasses

    rng = np.random.RandomState(5)
    R = 200  # engages the compact path (U << R)
    C = 6
    cell_eq_offsets = [0]
    label_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(3, 8)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            label_offsets.append(len(labels))
            counts.append(rng.randint(5, 40))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    eqc = CellEqClasses(
        cell_ids=np.arange(C, dtype=np.int64),
        cell_eq_offsets=np.asarray(cell_eq_offsets, np.int64),
        label_offsets=np.asarray(label_offsets, np.int64),
        labels=np.asarray(labels, np.uint32),
        counts=np.asarray(counts, np.uint32),
    )
    lo = np.asarray(label_offsets, np.int64)
    lb = np.asarray(labels, np.uint32)

    monkeypatch.setenv("AFT_BOOT_BACKEND", "host")
    (rm, cm, vm), _ = run_bootstraps(eqc, lo, lb, R, 32, False, True)
    monkeypatch.setenv("AFT_BOOT_BACKEND", "jax")
    (rj, cj, vj), _ = run_bootstraps(eqc, lo, lb, R, 32, False, True)

    a = np.zeros((C, R))
    a[rm, cm] = vm
    b = np.zeros((C, R))
    b[rj, cj] = vj
    # totals conserved and entries close (init noise shrinks with reps)
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-3)
    np.testing.assert_allclose(a, b, atol=1.5, rtol=0.2)


def test_native_em_cells_bit_identical_to_numpy():
    """The r5 threaded C++ batched EM (csrc radc_em_cells) must be
    BIT-identical to em_optimize_cell_np — same f32 accumulation
    order — across non-USA and USA modes, single-label-only cells,
    empty cells, and convergence-length diversity."""
    import numpy as np

    from alevin_fry_tpu.ops.em import em_optimize_cell_np
    from alevin_fry_tpu.radz import _native

    if not _native.available():
        import pytest

        pytest.skip("native lib absent")
    rng = np.random.RandomState(11)
    for usa in (False, True):
        R = 3 * 40 if usa else 50
        uoff, aoff = (R // 3, 2 * (R // 3)) if usa else (None, None)
        usa_offsets = (uoff, aoff) if usa else None
        n_cells = 60
        ceo = [0]
        lo = [0]
        labels = []
        counts = []
        for ci in range(n_cells):
            ne = rng.randint(0, 12)  # incl. empty cells
            for _ in range(ne):
                ll = rng.randint(1, 6)
                top = R // 3 if usa else R
                labels.extend(
                    rng.choice(top, size=ll, replace=False).tolist()
                )
                lo.append(len(labels))
                counts.append(rng.randint(1, 60))
            ceo.append(len(counts))
        ceo = np.asarray(ceo, np.int64)
        lo = np.asarray(lo, np.int64)
        labels = np.asarray(labels, np.uint32)
        counts = np.asarray(counts, np.uint32)
        for init_uniform in (False, True):
            for wlr in (False, True):
                nnz, oi, ov = _native.em_cells(
                    ceo, lo, labels, counts, R, usa_offsets,
                    init_uniform, wlr, 2,
                )
                for ci in range(n_cells):
                    s, e = ceo[ci], ceo[ci + 1]
                    want = em_optimize_cell_np(
                        lo[s : e + 1] - lo[s],
                        labels[lo[s] : lo[e]] if e > s else labels[:0],
                        counts[s:e], R, usa_offsets, init_uniform, wlr,
                    )
                    wn = np.flatnonzero(want)
                    base = lo[s] if e > s else lo[s]
                    k = int(nnz[ci])
                    np.testing.assert_array_equal(
                        oi[base : base + k], wn,
                        err_msg=f"usa={usa} ci={ci}",
                    )
                    # BIT identical: same f32 accumulation order
                    np.testing.assert_array_equal(
                        ov[base : base + k], want[wn].astype(np.float32),
                        err_msg=f"usa={usa} ci={ci}",
                    )


def test_native_em_cells_matches_numpy_batch_with_empty_classes(monkeypatch):
    """Zero-length classes (possible from degenerate eq-class maps)
    must route identically through the native batch and the pure-NumPy
    batch path — including cells whose classes are all singles+empties
    (the caller's seed fast path)."""
    import numpy as np

    from alevin_fry_tpu.ops import em
    from alevin_fry_tpu.radz import _native

    if not _native.available():
        import pytest

        pytest.skip("native lib absent")
    rng = np.random.RandomState(23)
    R = 60
    ceo = [0]
    lo = [0]
    labels = []
    counts = []
    for ci in range(40):
        ne = rng.randint(1, 8)
        for _ in range(ne):
            ll = rng.randint(0, 4)  # INCLUDING zero-length classes
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lo.append(len(labels))
            counts.append(rng.randint(1, 30))
        ceo.append(len(counts))
    args = (
        np.asarray(ceo, np.int64), np.asarray(lo, np.int64),
        np.asarray(labels, np.uint32), np.asarray(counts, np.uint32),
        R, None, False, True,
    )
    got = em.em_cells_batched(*args, use_jax=False)
    monkeypatch.setattr(_native, "available", lambda: False)
    want = em.em_cells_batched(*args, use_jax=False)
    assert len(got) == len(want)
    for ci, ((gi, gv), (wi, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"ci={ci}")
        np.testing.assert_array_equal(gv, wv, err_msg=f"ci={ci}")
