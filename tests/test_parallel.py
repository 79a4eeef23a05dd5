"""Multi-chip sharding tests on the virtual 8-device CPU mesh:
the psum-merged histogram and the sharded EM round must match their
host (NumPy) equivalents."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from alevin_fry_tpu.parallel.mesh import (
    example_em_inputs, make_mesh, sharded_em_step, sharded_histogram,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    return make_mesh()


def test_sharded_histogram_matches_host(mesh):
    rng = np.random.RandomState(1)
    # barcodes wider than 32 bits exercise the x64 path (bc_len > 16)
    wl = np.sort(
        rng.choice(1 << 20, size=128, replace=False).astype(np.uint64)
        << np.uint64(20)
    )
    n = 16 * len(jax.devices())
    bcs = wl[rng.choice(len(wl), size=n)]
    bcs[: n // 4] = rng.choice(1 << 20, size=n // 4).astype(np.uint64)
    cnt, unmatched, dev_hit = sharded_histogram(mesh, bcs, wl)
    cnt = np.asarray(cnt)
    # host reference
    idx = np.searchsorted(wl, bcs)
    idx_c = np.minimum(idx, len(wl) - 1)
    hit = wl[idx_c] == bcs
    ref = np.zeros(len(wl), np.int64)
    np.add.at(ref, idx_c[hit], 1)
    np.testing.assert_array_equal(cnt, ref)
    assert int(unmatched) == int((~hit).sum())
    np.testing.assert_array_equal(dev_hit, hit)

    # length not divisible by the mesh: padding must not leak
    bcs_odd = bcs[: n - 3]
    cnt2, unm2, hit2 = sharded_histogram(mesh, bcs_odd, wl)
    ref2 = np.zeros(len(wl), np.int64)
    np.add.at(ref2, idx_c[: n - 3][hit[: n - 3]], 1)
    np.testing.assert_array_equal(np.asarray(cnt2), ref2)
    assert int(unm2) == int((~hit[: n - 3]).sum())
    np.testing.assert_array_equal(hit2, hit[: n - 3])


def test_em_cells_batched_mesh_matches_host(mesh):
    """The full batched EM with the cell axis sharded over the mesh must
    equal the single-device result."""
    from alevin_fry_tpu.ops.em import em_cells_batched

    rng = np.random.RandomState(9)
    R = 24
    C = 100
    cell_eq_offsets = [0]
    lab_offsets = [0]
    labels = []
    counts = []
    for _ in range(C):
        ne = rng.randint(2, 7)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lab_offsets.append(len(labels))
            counts.append(rng.randint(1, 15))
        cell_eq_offsets.append(cell_eq_offsets[-1] + ne)
    args = (
        np.asarray(cell_eq_offsets, np.int64),
        np.asarray(lab_offsets, np.int64),
        np.asarray(labels, np.uint32),
        np.asarray(counts, np.uint32),
        R, None, False, True,
    )
    base = em_cells_batched(*args, use_jax=True)
    sharded = em_cells_batched(*args, use_jax=True, mesh=mesh)
    for (bi, bv), (si, sv) in zip(base, sharded):
        np.testing.assert_array_equal(bi, si)
        np.testing.assert_allclose(bv, sv, rtol=1e-6)


def test_sharded_em_memory_capped_batch_splits_evenly():
    """A memory-capped batch size (here 70 cells) is rounded down to a
    multiple of the mesh size before the batch is sharded."""
    from alevin_fry_tpu.ops.em import em_cells_batched
    from alevin_fry_tpu.parallel.mesh import make_mesh

    rng = np.random.RandomState(9)
    R = 24
    ceo, lo, labels, counts = [0], [0], [], []
    for _ in range(100):
        ne = rng.randint(2, 7)
        for _ in range(ne):
            ll = rng.randint(1, 4)
            labels.extend(rng.choice(R, size=ll, replace=False).tolist())
            lo.append(len(labels))
            counts.append(rng.randint(1, 15))
        ceo.append(ceo[-1] + ne)
    args = (np.asarray(ceo, np.int64), np.asarray(lo, np.int64),
            np.asarray(labels, np.uint32), np.asarray(counts, np.uint32),
            R, None, False, True)
    # per-cell budget (R+1)*3 + 64*4*2 = 587 elements -> 70 cells
    cap = 587 * 70
    base = em_cells_batched(*args, use_jax=True)
    sharded = em_cells_batched(*args, use_jax=True, max_batch_elems=cap,
                               mesh=make_mesh(4))
    for (bi, bv), (si, sv) in zip(base, sharded):
        np.testing.assert_array_equal(bi, si)
        np.testing.assert_allclose(bv, sv, rtol=1e-6)


def test_sharded_em_round_matches_numpy(mesh):
    R = 32
    B = 2 * len(jax.devices())
    labels, lens, counts, alphas = example_em_inputs(B=B, E=8, L=4, R=R, seed=3)
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    step = sharded_em_step(mesh)
    out = np.asarray(step(
        jax.device_put(labels, shard), jax.device_put(lens, shard),
        jax.device_put(counts, shard), jax.device_put(alphas, shard), R,
    ))

    # numpy reference for one EM round
    lab = np.asarray(labels)
    ln = np.asarray(lens)
    ct = np.asarray(counts)
    al = np.asarray(alphas)
    ref = np.zeros_like(al)
    for b in range(B):
        for e in range(lab.shape[1]):
            ll = ln[b, e]
            if ll == 0:
                continue
            idx = lab[b, e, :ll]
            if ll == 1:
                ref[b, idx[0]] += ct[b, e]
                continue
            ab = al[b, idx]
            denom = ab.sum(dtype=np.float32)
            if denom > 0:
                ref[b, idx] += ab * (ct[b, e] / denom)
    np.testing.assert_allclose(out[:, :R], ref[:, :R], rtol=2e-5, atol=2e-5)
    assert np.all(out[:, R] == 0)


def _random_crlike_case(rng, n_cells=40, n_genes=50, n_pairs=3000):
    """Random deduplicated (cell, umi, gene) pairs, cell-sorted."""
    c = np.sort(rng.randint(0, n_cells, size=n_pairs)).astype(np.int64)
    u = rng.randint(0, 1 << 10, size=n_pairs).astype(np.uint64)
    g = rng.randint(0, n_genes, size=n_pairs).astype(np.uint64)
    # dedup (cell, umi, gene) triplet duplicates are ALLOWED (they model
    # multiple reads); no per-read dedup needed here
    return c, u, g


@pytest.mark.parametrize("segred", ["cum", "scatter"])
def test_crlike_device_matches_host(segred, monkeypatch):
    """The jitted device WTA kernel must reproduce the host resolver's
    COO counts exactly (integer counts, same ordering) — in both the
    scatter-free cumulative segmented-reduction form (the default) and
    the round-3 scatter form kept for A/B profiling."""
    from alevin_fry_tpu.ops import crlike
    from alevin_fry_tpu.ops.crlike_device import resolve_crlike_wta_device

    monkeypatch.setenv("AFT_WTA_SEGRED", segred)
    rng = np.random.RandomState(5)
    n_cells, n_genes = 40, 50
    c, u, g = _random_crlike_case(rng, n_cells, n_genes)
    ubits, gbits = 10, 6
    key = (
        (c.astype(np.uint64) << np.uint64(ubits + gbits))
        | (u << np.uint64(gbits))
        | g
    )

    r_dev, c_dev, v_dev = resolve_crlike_wta_device(key, ubits, gbits, n_genes)

    # host reference: resolve + unique slots + counts
    aln_offsets = np.arange(len(c) + 1, dtype=np.int64)  # 1 'aln' per pair
    tid_to_gid = np.arange(n_genes, dtype=np.uint32)
    groups = crlike.resolve_crlike(c, u, g.astype(np.uint32), aln_offsets, tid_to_gid)
    slot, valid = crlike.nonusa_unique_slots(groups)
    r_h, c_h, v_h = crlike.counts_from_slots(
        groups.cell, slot, valid, n_cells, n_genes
    )
    np.testing.assert_array_equal(r_dev, r_h)
    np.testing.assert_array_equal(c_dev, c_h)
    np.testing.assert_array_equal(v_dev, v_h)


@pytest.mark.parametrize("segred", ["cum", "scatter"])
def test_crlike_device_usa_matches_host(segred, monkeypatch):
    """The USA-mode device WTA (tie-set slotting, utils.rs:656-739)
    must reproduce the host usa_slots_for_groups counts exactly —
    including the len-2 same/spliced rules and the 3..10
    single-spliced-with-partner rule — in both segmented-reduction
    forms."""
    from alevin_fry_tpu.ops import crlike
    from alevin_fry_tpu.ops.crlike_device import resolve_crlike_wta_device

    monkeypatch.setenv("AFT_WTA_SEGRED", segred)
    rng = np.random.RandomState(11)
    n_cells, n_genes = 30, 12          # USA ids in [0, 2*n_genes)
    num_rows = 3 * (n_genes + 1)       # 3-section space w/ mid padding
    num_rows -= num_rows % 3
    n_pairs = 4000
    c = rng.randint(0, n_cells, size=n_pairs).astype(np.uint64)
    u = rng.randint(0, 1 << 9, size=n_pairs).astype(np.uint64)
    g = rng.randint(0, 2 * n_genes, size=n_pairs).astype(np.uint64)
    ubits, gbits = 9, 6

    key = (
        (c.astype(np.uint64) << np.uint64(ubits + gbits))
        | (u << np.uint64(gbits))
        | g
    )
    r_dev, c_dev, v_dev = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=True
    )

    aln_offsets = np.arange(len(c) + 1, dtype=np.int64)
    tid_to_gid = np.arange(2 * n_genes, dtype=np.uint32)
    groups = crlike.resolve_crlike(
        c, u, g.astype(np.uint32), aln_offsets, tid_to_gid
    )
    slot, valid = crlike.usa_slots_for_groups(groups, num_rows)
    r_h, c_h, v_h = crlike.counts_from_slots(
        groups.cell, slot, valid, n_cells, num_rows
    )
    np.testing.assert_array_equal(r_dev, r_h)
    np.testing.assert_array_equal(c_dev, c_h)
    np.testing.assert_array_equal(v_dev, v_h)

    # prefer-ambig variant: pair-level aggregation (pugutils.rs:505-641)
    rp_dev, cp_dev, vp_dev = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=True, prefer_ambig=True
    )
    groups_pa = crlike.resolve_crlike(
        c, u, g.astype(np.uint32), aln_offsets, tid_to_gid, prefer_ambig=True
    )
    slot_pa, valid_pa = crlike.usa_slots_for_groups(groups_pa, num_rows)
    rp_h, cp_h, vp_h = crlike.counts_from_slots(
        groups_pa.cell, slot_pa, valid_pa, n_cells, num_rows
    )
    np.testing.assert_array_equal(rp_dev, rp_h)
    np.testing.assert_array_equal(cp_dev, cp_h)
    np.testing.assert_array_equal(vp_dev, vp_h)
    # the two models must differ on this data (pairs exist by design)
    assert not (
        len(vp_h) == len(v_h)
        and np.array_equal(rp_h, r_h) and np.array_equal(vp_h, v_h)
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_crlike_device_usa_dense_ties_fuzz(seed):
    """Adversarial tie-set coverage for the last-winner-emission USA
    kernel: a tiny (cell, umi, gene) space forces deep tie sets, len-2
    pairs, and partner adjacency through every slot rule
    (utils.rs:656-739), in both aggregation models."""
    from alevin_fry_tpu.ops import crlike
    from alevin_fry_tpu.ops.crlike_device import resolve_crlike_wta_device

    rng = np.random.RandomState(seed)
    n_cells, n_genes = 12, 8
    num_rows = 3 * (n_genes + 1)
    num_rows -= num_rows % 3
    n_pairs = 3000
    c = rng.randint(0, n_cells, n_pairs).astype(np.uint64)
    u = rng.randint(0, 1 << 4, n_pairs).astype(np.uint64)
    g = rng.randint(0, 2 * n_genes, n_pairs).astype(np.uint64)
    ubits, gbits = 4, 5
    key = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g
    aln = np.arange(len(c) + 1, dtype=np.int64)
    t2g = np.arange(2 * n_genes, dtype=np.uint32)
    for pa in (False, True):
        rd, cd, vd = resolve_crlike_wta_device(
            key, ubits, gbits, num_rows, usa=True, prefer_ambig=pa
        )
        groups = crlike.resolve_crlike(
            c, u, g.astype(np.uint32), aln, t2g, prefer_ambig=pa
        )
        slot, valid = crlike.usa_slots_for_groups(groups, num_rows)
        rh, ch, vh = crlike.counts_from_slots(
            groups.cell, slot, valid, n_cells, num_rows
        )
        np.testing.assert_array_equal(rd, rh)
        np.testing.assert_array_equal(cd, ch)
        np.testing.assert_array_equal(vd, vh)


@pytest.mark.parametrize("usa", [False, True])
def test_crlike_packed_upload_matches_whole_key(usa, monkeypatch):
    """The u32 low-key + cell-delta packed upload must reassemble the
    exact key stream on device: COO output identical to the whole-u64
    upload path for the same pairs (incl. USA slotting)."""
    from alevin_fry_tpu.ops.crlike_device import (
        resolve_crlike_wta_device, resolve_crlike_wta_device_packed,
    )

    rng = np.random.RandomState(7)
    n_cells = 60
    n_genes = 24 if usa else 48          # USA uses interleaved 2*g ids
    n_rows = 3 * (n_genes + 1) if usa else n_genes
    n_rows -= n_rows % 3 if usa else 0
    n_pairs = 5000
    c = np.sort(rng.randint(0, n_cells, n_pairs)).astype(np.int64)
    u = rng.randint(0, 1 << 9, n_pairs).astype(np.uint64)
    g = rng.randint(
        0, 2 * n_genes if usa else n_genes, n_pairs
    ).astype(np.uint64)
    ubits, gbits = 9, 7
    key = (
        (c.astype(np.uint64) << np.uint64(ubits + gbits))
        | (u << np.uint64(gbits))
        | g
    )
    r0, c0, v0 = resolve_crlike_wta_device(
        key, ubits, gbits, n_rows, usa=usa, n_cells=n_cells
    )
    # segments of the sorted cell array
    bounds = np.flatnonzero(np.diff(c)) + 1
    segs = np.concatenate([[0], bounds, [n_pairs]]).astype(np.int64)
    cell_ids = c[segs[:-1]]
    lowkey = (u.astype(np.uint32) << np.uint32(gbits)) | g.astype(np.uint32)
    r1, c1, v1 = resolve_crlike_wta_device_packed(
        cell_ids, segs, lowkey, ubits, gbits, n_rows, usa=usa
    )
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(v0, v1)

    # u8 overflow plane: widen the umi field past 32 bits (the 12bp-UMI
    # regime) and split the low key into u32 + u8 planes
    ubits_w = 30
    key_w = (
        (c.astype(np.uint64) << np.uint64(ubits_w + gbits))
        | (u << np.uint64(gbits + ubits_w - ubits))  # same umi values, shifted field
        | g
    )
    rw, cw, vw = resolve_crlike_wta_device(
        key_w, ubits_w, gbits, n_rows, usa=usa, n_cells=n_cells
    )
    low = (u << np.uint64(gbits + ubits_w - ubits)) | g
    r2, c2, v2 = resolve_crlike_wta_device_packed(
        cell_ids, segs, (low & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        ubits_w, gbits, n_rows, usa=usa,
        lowhi=(low >> np.uint64(32)).astype(np.uint8),
    )
    np.testing.assert_array_equal(rw, r2)
    np.testing.assert_array_equal(cw, c2)
    np.testing.assert_array_equal(vw, v2)


def test_crlike_sharded_usa_matches_single(mesh):
    """Cell-boundary-sharded USA-mode WTA over the mesh == single-device
    result (the tie-set slotting kernel vmapped across shards)."""
    from alevin_fry_tpu.ops.crlike_device import (
        PAD, resolve_crlike_wta_device, sharded_crlike_wta,
    )

    rng = np.random.RandomState(17)
    n_shards = len(jax.devices())
    n_cells, n_genes = 6 * n_shards, 10
    num_rows = 3 * (n_genes + 1)
    num_rows -= num_rows % 3
    ubits, gbits = 8, 6
    n_pairs = 1800
    c = np.sort(rng.randint(0, n_cells, n_pairs)).astype(np.uint64)
    u = rng.randint(0, 1 << ubits, n_pairs).astype(np.uint64)
    g = rng.randint(0, 2 * n_genes, n_pairs).astype(np.uint64)
    key = (
        (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g
    )
    r1, c1, v1 = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=True
    )
    bounds = np.searchsorted(c, np.arange(1, n_shards) * 6)
    blocks = np.split(key, bounds)
    L = 1 << int(max(len(b) for b in blocks) - 1).bit_length()
    padded = np.full((n_shards, L), PAD, np.uint64)
    for i, b in enumerate(blocks):
        padded[i, : len(b)] = b
    ok, oc = sharded_crlike_wta(
        mesh, padded, ubits, gbits, num_rows, usa=True
    )
    keep = ok != PAD
    uniq = ok[keep].astype(np.int64)
    cnt = oc[keep]
    np.testing.assert_array_equal(uniq // num_rows, r1)
    np.testing.assert_array_equal(uniq % num_rows, c1)
    np.testing.assert_array_equal(cnt.astype(np.float32), v1)


def test_crlike_sharded_matches_single(mesh):
    """Cell-boundary-sharded WTA over the mesh == single-device result."""
    from alevin_fry_tpu.ops.crlike_device import (
        PAD, resolve_crlike_wta_device, sharded_crlike_wta,
    )

    rng = np.random.RandomState(11)
    n_shards = len(jax.devices())
    n_cells, n_genes = 8 * n_shards, 30
    ubits, gbits = 10, 5
    c, u, g = _random_crlike_case(rng, n_cells, n_genes, n_pairs=2000)
    key = (
        (c.astype(np.uint64) << np.uint64(ubits + gbits))
        | (u << np.uint64(gbits))
        | g
    )
    r1, c1, v1 = resolve_crlike_wta_device(key, ubits, gbits, n_genes)

    # split at cell boundaries into n_shards blocks, pad to equal length
    bounds = np.searchsorted(c, np.arange(1, n_shards) * 8)
    blocks = np.split(key, bounds)
    L = 1 << int(max(len(b) for b in blocks) - 1).bit_length()
    padded = np.full((n_shards, L), PAD, np.uint64)
    for i, b in enumerate(blocks):
        padded[i, : len(b)] = b
    ok, oc = sharded_crlike_wta(mesh, padded, ubits, gbits, n_genes)
    keep = ok != PAD
    uniq = ok[keep].astype(np.int64)  # blocks are cell-ordered
    cnt = oc[keep]
    np.testing.assert_array_equal(uniq // n_genes, r1)
    np.testing.assert_array_equal(uniq % n_genes, c1)
    np.testing.assert_array_equal(cnt.astype(np.float32), v1)


def test_sharded_collate_shuffle_matches_host(mesh):
    """The all-to-all collation shuffle must regroup reads by owning
    shard in (rank, payload) order — the device analog of the
    reference's temp-bucket scatter/gather (collate.rs:584-905)."""
    from alevin_fry_tpu.parallel.mesh import sharded_collate_shuffle

    rng = np.random.RandomState(3)
    S = len(jax.devices())
    n_cells = 50
    n = 64 * S
    ranks = rng.randint(0, n_cells, size=n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32)

    cells_per_shard = -(-n_cells // S)
    # capacity = the largest (source device, owner) bin
    cap = 0
    for d in range(S):
        loc = ranks[d * (n // S):(d + 1) * (n // S)]
        owners = np.minimum(loc // cells_per_shard, S - 1)
        if len(owners):
            cap = max(cap, int(np.bincount(owners, minlength=S).max()))

    r_out, p_out, dropped = sharded_collate_shuffle(
        mesh, ranks, payload, n_cells, cap
    )
    assert dropped == 0
    owners_all = np.minimum(ranks // cells_per_shard, S - 1)
    for s in range(S):
        mine = np.flatnonzero(owners_all == s)
        exp = mine[np.lexsort((payload[mine], ranks[mine]))]
        got_valid = r_out[s] != n_cells
        np.testing.assert_array_equal(r_out[s][got_valid], ranks[exp])
        np.testing.assert_array_equal(p_out[s][got_valid], payload[exp])

    # a too-small capacity must be detected, not silently truncated
    if cap > 1:
        _, _, dropped2 = sharded_collate_shuffle(
            mesh, ranks, payload, n_cells, cap - 1
        )
        assert dropped2 > 0


def test_device_cc_matches_union_find(mesh):
    """Batched min-label propagation must equal the host union-find
    (pugutils.rs:278-301 semantics) on random per-cell graphs."""
    from alevin_fry_tpu.ops.pug import _DSU
    from alevin_fry_tpu.ops.pug_device import (
        connected_components_batched, pack_adjacency,
    )

    rng = np.random.RandomState(11)
    B = 2 * len(jax.devices())
    adjs = []
    for _ in range(B):
        n = rng.randint(1, 40)
        adj = [[] for _ in range(n)]
        for _ in range(rng.randint(0, 2 * n)):
            a, b = rng.randint(0, n, size=2)
            if a != b:
                adj[a].append(b)
        adjs.append(adj)

    nbrs, valid = pack_adjacency(adjs)
    labels = connected_components_batched(nbrs, valid, mesh=mesh)

    for b, adj in enumerate(adjs):
        n = len(adj)
        dsu = _DSU(n)
        for a in range(n):
            for w in adj[a]:
                dsu.union(a, w)
        roots = {}
        for v in range(n):
            roots.setdefault(dsu.find(v), []).append(v)
        for members in roots.values():
            expect = min(members)
            got = {int(labels[b, v]) for v in members}
            assert got == {expect}, (b, members, got)
        assert (labels[b, n:] == nbrs.shape[1]).all()


def test_prefetched_order_and_errors():
    from alevin_fry_tpu.parallel.prefetch import prefetched

    assert list(prefetched(iter(range(100)), depth=2)) == list(range(100))
    assert list(prefetched(iter([]), depth=2)) == []
    # depth<=0 is synchronous passthrough
    assert list(prefetched(iter(range(5)), depth=0)) == list(range(5))

    def boom():
        yield 1
        yield 2
        raise RuntimeError("producer failed")

    out = []
    import pytest

    with pytest.raises(RuntimeError, match="producer failed"):
        for x in prefetched(boom(), depth=1):
            out.append(x)
    assert out == [1, 2]

    # early consumer exit does not hang the producer thread
    import threading

    before = threading.active_count()
    for x in prefetched(iter(range(10_000)), depth=1):
        break
    import time

    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)


def test_pipeline_identical_with_and_without_prefetch(tmp_path, monkeypatch):
    """Artifacts are byte-identical whether or not the input pipeline
    overlaps decode with compute (AFT_PREFETCH=0 vs default)."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from synth import write_rna_rad
    from alevin_fry_tpu.ops.barcodes import pack_seq
    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify

    rng = np.random.RandomState(11)
    bcs = ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "TTTTTTTT"]
    reads = []
    for i in range(800):
        bc = bcs[rng.randint(4)]
        umi = int(rng.randint(1 << 20))
        tids = sorted(set(rng.randint(0, 8, rng.randint(1, 3)).tolist()))
        reads.append((pack_seq(bc), umi, [(t, True) for t in tids]))
    refs = [f"t{i}" for i in range(8)]

    outs = {}
    for tag, depth in (("sync", "0"), ("pre", "2")):
        root = tmp_path / tag
        rad_dir = root / "rad"
        rad_dir.mkdir(parents=True)
        write_rna_rad(rad_dir / "map.rad", refs, [reads], bc_len=8, umi_len=10)
        (root / "wl.txt").write_text("".join(b + "\n" for b in bcs))
        (root / "t2g.tsv").write_text(
            "".join(f"t{i}\tg{i//2}\n" for i in range(8))
        )
        monkeypatch.setenv("AFT_PREFETCH", depth)
        # small block bound so several blocks stream through the queue
        monkeypatch.setenv("AFT_QUANT_BLOCK_RECORDS", "100")
        gpl = root / "gpl"
        generate_permit_list(GenPermitListOpts(
            input_dir=rad_dir, output_dir=gpl,
            fmeth=CellFilterMethod("unfiltered", path=root / "wl.txt",
                                   min_reads=1),
            expected_ori="fw", cmdline="t",
        ))
        collate(gpl, rad_dir, max_records=150, cmdline="t")
        qdir = root / "q"
        quantify(QuantOpts(
            input_dir=gpl, tg_map=root / "t2g.tsv", output_dir=qdir,
            resolution="cr-like", cmdline="t",
        ))
        outs[tag] = {
            p.name: p.read_bytes()
            for p in [
                gpl / "map.collated.rad", gpl / "permit_freq.bin",
                qdir / "alevin" / "quants_mat.mtx",
                qdir / "alevin" / "quants_mat_rows.txt",
                qdir / "featureDump.txt",
            ]
        }
    assert outs["sync"] == outs["pre"]


def test_gpl_device_histogram_matches_host(tmp_path, monkeypatch):
    """generate-permit-list with the mesh histogram (AFT_GPL_MESH=auto
    on the virtual 8-device mesh) writes byte-identical permit
    artifacts to the host path."""
    import sys as _sys
    from pathlib import Path as _Path

    _sys.path.insert(0, str(_Path(__file__).parent))
    from synth import write_rna_rad
    from alevin_fry_tpu.ops.barcodes import pack_seq, snp_neighbors
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")

    rng = np.random.RandomState(9)
    wl = ["AACCGGTT", "CCAATTGG", "GGTTAACC", "TTGGCCAA"]
    wl_packed = np.asarray([pack_seq(b) for b in wl], np.uint64)
    reads = []
    for i in range(400):
        bc = wl_packed[rng.randint(4)]
        if rng.rand() < 0.1:  # 1-edit noise for the rescue path
            bc = snp_neighbors(np.asarray([bc], np.uint64), 8)[
                0, rng.randint(24)
            ]
        reads.append((int(bc), int(rng.randint(1 << 20)),
                      [(int(rng.randint(6)), True)]))
    refs = [f"t{i}" for i in range(6)]

    outs = {}
    for tag, meshspec in (("host", "0"), ("mesh", "auto")):
        root = tmp_path / tag
        rad_dir = root / "rad"
        rad_dir.mkdir(parents=True)
        write_rna_rad(rad_dir / "map.rad", refs, [reads], bc_len=8, umi_len=10)
        (root / "wl.txt").write_text("".join(b + "\n" for b in wl))
        monkeypatch.setenv("AFT_GPL_MESH", meshspec)
        gpl = root / "gpl"
        generate_permit_list(GenPermitListOpts(
            input_dir=rad_dir, output_dir=gpl,
            fmeth=CellFilterMethod("unfiltered", path=root / "wl.txt",
                                   min_reads=2),
            expected_ori="fw", cmdline="t",
        ))
        outs[tag] = {
            p.name: p.read_bytes()
            for p in (gpl / "permit_freq.bin", gpl / "permit_map.bin")
        }
    monkeypatch.delenv("AFT_GPL_MESH")
    assert outs["host"] == outs["mesh"]


def test_dense_cc_matches_gather_formulation():
    """The dense reachability-squaring CC (ops/pug_device._dense_cc_run)
    must produce exactly the min-label components of the gather
    formulation on random graphs, including invalid-node padding and
    sub-batched shapes."""
    from alevin_fry_tpu.ops.pug_device import (
        connected_components_batched, pack_adjacency,
    )

    rng = np.random.RandomState(17)
    for trial in range(3):
        B, N = 9, 30 + 40 * trial
        adjs = []
        for _ in range(B):
            n = rng.randint(1, N)
            adj = [[] for _ in range(n)]
            for _ in range(rng.randint(0, 3 * n)):
                a, b = rng.randint(0, n, size=2)
                if a != b:
                    adj[a].append(b)
            adjs.append(adj)
        nbrs, valid = pack_adjacency(adjs)
        d = connected_components_batched(nbrs, valid, dense=True)
        g = connected_components_batched(nbrs, valid, dense=False)
        assert np.array_equal(d, g)


def test_quant_device_async_pipeline_matches_sync(tmp_path, monkeypatch):
    """The async device WTA pipeline (blocks submitted ahead, fetched
    in order through the bounded queue) must write byte-identical quant
    artifacts to the synchronous device path and the host path, across
    several streamed blocks."""
    import sys as _sys
    from pathlib import Path as _Path

    _sys.path.insert(0, str(_Path(__file__).parent))
    from synth import write_rna_rad
    from alevin_fry_tpu.ops.barcodes import pack_seq
    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify

    rng = np.random.RandomState(23)
    bcs = ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "TTTTTTTT", "ACACACAC"]
    reads = []
    for _ in range(900):
        bc = bcs[rng.randint(len(bcs))]
        umi = int(rng.randint(1 << 18))
        tids = sorted(set(rng.randint(0, 10, rng.randint(1, 4)).tolist()))
        reads.append((pack_seq(bc), umi, [(t, True) for t in tids]))
    refs = [f"t{i}" for i in range(10)]

    root = tmp_path
    rad_dir = root / "rad"
    rad_dir.mkdir(parents=True)
    write_rna_rad(rad_dir / "map.rad", refs, [reads], bc_len=8, umi_len=10)
    (root / "wl.txt").write_text("".join(b + "\n" for b in bcs))
    (root / "t2g.tsv").write_text(
        "".join(f"t{i}\tg{i//2}\n" for i in range(10))
    )
    gpl = root / "gpl"
    generate_permit_list(GenPermitListOpts(
        input_dir=rad_dir, output_dir=gpl,
        fmeth=CellFilterMethod("unfiltered", path=root / "wl.txt",
                               min_reads=1),
        expected_ori="fw", cmdline="t",
    ))
    collate(gpl, rad_dir, cmdline="t")

    # several blocks stream through the pending queue
    monkeypatch.setenv("AFT_QUANT_BLOCK_RECORDS", "120")
    outs = {}
    for tag, env in (
        ("host", {"AFT_CRLIKE_BACKEND": "host"}),
        ("sync", {"AFT_CRLIKE_BACKEND": "jax", "AFT_WTA_ASYNC": "0"}),
        ("async", {"AFT_CRLIKE_BACKEND": "jax", "AFT_WTA_ASYNC": "1",
                   "AFT_WTA_QUEUE": "2"}),
        # non-compacted fetch variant (fast-link deployments)
        ("plain", {"AFT_CRLIKE_BACKEND": "jax", "AFT_WTA_COMPACT": "0"}),
    ):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        qdir = root / f"q_{tag}"
        quantify(QuantOpts(
            input_dir=gpl, tg_map=root / "t2g.tsv", output_dir=qdir,
            resolution="cr-like", cmdline="t",
        ))
        outs[tag] = {
            p.name: p.read_bytes()
            for p in [
                qdir / "alevin" / "quants_mat.mtx",
                qdir / "alevin" / "quants_mat_rows.txt",
                qdir / "featureDump.txt",
            ]
        }
        for k in env:
            monkeypatch.delenv(k)
    assert outs["host"] == outs["sync"] == outs["async"] == outs["plain"]


@pytest.mark.parametrize("usa", [False, True])
def test_crlike_device_fused_tail_matches_compact(usa, monkeypatch):
    """The two-sort fused tail (AFT_WTA_COMPACT=fuse, r5) must produce
    byte-identical COO triplets to the three-sort compacted kernel, in
    both the shift=32 and shift=24 packed-word layouts."""
    from alevin_fry_tpu.ops.crlike_device import resolve_crlike_wta_device

    rng = np.random.RandomState(17 + usa)
    n_cells = 40
    n_genes = 12 if usa else 50
    num_rows = (3 * (n_genes + 1)) // 3 * 3 if usa else n_genes
    n_pairs = 5000
    c = rng.randint(0, n_cells, n_pairs).astype(np.uint64)
    u = rng.randint(0, 1 << 9, n_pairs).astype(np.uint64)
    g = rng.randint(0, (2 * n_genes) if usa else n_genes, n_pairs).astype(
        np.uint64
    )
    ubits, gbits = 9, 6
    key = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g

    monkeypatch.setenv("AFT_WTA_COMPACT", "1")
    r0, c0, v0 = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=usa, n_cells=n_cells
    )
    monkeypatch.setenv("AFT_WTA_COMPACT", "fuse")
    r1, c1, v1 = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=usa, n_cells=n_cells
    )
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(v0, v1)
    # force the shift=24 layout: a cell space too large for 32-bit words
    big_cells = 1 << 27
    r2, c2, v2 = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=usa, n_cells=big_cells
    )
    np.testing.assert_array_equal(r0, r2)
    np.testing.assert_array_equal(c0, c2)
    np.testing.assert_array_equal(v0, v2)


@pytest.mark.parametrize("usa", [False, True])
def test_crlike_packed_upload_fused_matches(usa, monkeypatch):
    """Packed-upload front end + fused tail must equal the whole-key
    compacted path."""
    from alevin_fry_tpu.ops.crlike_device import (
        resolve_crlike_wta_device, resolve_crlike_wta_device_packed,
    )

    rng = np.random.RandomState(29 + usa)
    n_cells = 32
    n_genes = 10 if usa else 40
    num_rows = (3 * (n_genes + 1)) // 3 * 3 if usa else n_genes
    n_pairs = 4000
    cells = np.sort(rng.choice(n_cells, 12, replace=False)).astype(np.int64)
    c = cells[rng.randint(0, len(cells), n_pairs)].astype(np.uint64)
    u = rng.randint(0, 1 << 9, n_pairs).astype(np.uint64)
    g = rng.randint(0, (2 * n_genes) if usa else n_genes, n_pairs).astype(
        np.uint64
    )
    ubits, gbits = 9, 6
    order = np.argsort(c, kind="stable")
    c, u, g = c[order], u[order], g[order]
    key = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g

    monkeypatch.setenv("AFT_WTA_COMPACT", "1")
    r0, c0, v0 = resolve_crlike_wta_device(
        key, ubits, gbits, num_rows, usa=usa, n_cells=n_cells
    )
    monkeypatch.setenv("AFT_WTA_COMPACT", "fuse")
    cell_ids, counts = np.unique(c, return_counts=True)
    segs = np.zeros(len(cell_ids) + 1, np.int64)
    segs[1:] = np.cumsum(counts)
    lowkey = ((u << np.uint64(gbits)) | g).astype(np.uint32)
    r1, c1, v1 = resolve_crlike_wta_device_packed(
        cell_ids.astype(np.int64), segs, lowkey, ubits, gbits, num_rows,
        usa=usa,
    )
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(v0, v1)
