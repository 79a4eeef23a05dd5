#!/usr/bin/env python
"""Smoke test of the whole pipeline on one NVIDIA GPU.

Drives the main path once through the CLI entry points a user calls,
at the widths of a 10x Chromium 3' v3 run against the 36,601 genes of
10x's GRCh38-2020-A reference, and checks every artifact against the
host path:

1. device: the card, its power limit, and the native codec;
2. data: a seeded synthetic RNA dataset (and an ATAC one);
3. ``generate-permit-list -u`` -> ``collate`` -> ``quant`` (cr-like,
   cr-like USA, cr-like-em, parsimony) on the card, each stage timed and
   required to have run its device path;
4. the same commands in one CPU-only subprocess, compared byte for byte
   (cr-like-em: same nonzero set, rtol 2e-4 / atol 2e-4 per entry);
5. each device kernel at real widths against its plain reference, with
   warm median times;
6. the ATAC chain on the card, BED byte-identical to the CPU's;
7. the tests marked ``gpu``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  Without an NVIDIA GPU the script
exits non-zero and prints no result.

    python chip_smoke.py                 # one card, the run above
    python chip_smoke.py --four-cards    # phases 2-4 on four cards
    python chip_smoke.py --reads 2000000 # fewer reads, same widths

``--rehearse-on-cpu`` runs the same phases at a tiny size on the CPU
with every device path forced on; it never prints the JSON result and
exits with code 3 when it passes.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

# GRCh38-2020-A (10x Genomics) annotates 36,601 genes
N_GENES = 36_601
TXPS_PER_GENE = 4
N_CELLS = 5_000
EM_RTOL = EM_ATOL = 2e-4  # the bound tests/test_em.py holds the dense EM to

# device paths forced on for a CPU rehearsal (the auto policies pick
# the host there)
_FORCE_DEVICE_ENV = {
    "AFT_RESCUE_BACKEND": "jax",
    "AFT_COLLATE_BACKEND": "jax",
    "AFT_CRLIKE_BACKEND": "jax",
    "AFT_EM_BACKEND": "jax",
    "AFT_EM_DENSE": "1",
    "AFT_PUG_CC_BACKEND": "device",
    "AFT_ATAC_SORT_BACKEND": "jax",
}


class Failed(Exception):
    pass


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise Failed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def median_time(fn, n=5):
    fn()  # warm: compile and first transfer
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


# --- commands ---------------------------------------------------------------

QUANTS = (
    # name, tg map, resolution
    ("crlike", "t2g.tsv", "cr-like"),
    ("usa", "t2g_3col.tsv", "cr-like"),
    ("em", "t2g.tsv", "cr-like-em"),
    ("parsimony", "t2g.tsv", "parsimony"),
)


def rna_commands(data: Path, out: Path):
    gpl = out / "gpl"
    cmds = [
        ("generate-permit-list", ["generate-permit-list", "-i", str(data / "rad"),
                                  "-d", "fw", "-o", str(gpl),
                                  "-u", str(data / "permit.txt")]),
        ("collate", ["collate", "-i", str(gpl), "-r", str(data / "rad")]),
    ]
    for name, tg, res in QUANTS:
        cmds.append((f"quant {name}", ["quant", "-i", str(gpl), "-m",
                                       str(data / tg), "-o", str(out / f"q_{name}"),
                                       "-r", res]))
    return cmds


def atac_commands(data: Path, out: Path):
    gpl = out / "atac"
    rad = str(data / "rad")
    return [
        ("atac generate-permit-list", ["atac", "generate-permit-list", "-i", rad,
                                       "-o", str(gpl), "-u", str(data / "wl.txt"),
                                       "-m", "1", "-d", "rc"]),
        ("atac collate", ["atac", "collate", "-i", str(gpl), "-r", rad]),
        ("atac sort", ["atac", "sort", "-i", str(gpl), "-r", rad]),
        ("atac deduplicate", ["atac", "deduplicate", "-i", str(gpl)]),
    ]


def run_cli(argv):
    from alevin_fry_tpu.cli import main

    rc = main(argv)
    check(rc == 0, f"alevin-fry-tpu {' '.join(argv)} exited {rc}")


# --- which implementation ran -------------------------------------------------

class DeviceCalls:
    """Counts calls of the device entry points, so a stage that quietly
    ran its host path is caught."""

    def __init__(self):
        self.n = collections.Counter()

    def watch(self, module, name, label):
        orig = getattr(module, name)

        def counted(*a, **k):
            self.n[label] += 1
            return orig(*a, **k)

        setattr(module, name, counted)


def watch_device_paths() -> DeviceCalls:
    from alevin_fry_tpu.ops import atac_device, crlike_device, em, pug_device
    from alevin_fry_tpu.ops import rescue_device
    from alevin_fry_tpu.parallel import mesh
    from alevin_fry_tpu.pipeline import collate

    calls = DeviceCalls()
    calls.watch(rescue_device, "find_neighbors_searchsorted", "rescue")
    calls.watch(mesh, "sharded_histogram", "histogram")
    calls.watch(collate, "collation_order_device", "collate order")
    calls.watch(crlike_device, "resolve_crlike_wta_device_packed", "wta packed upload")
    calls.watch(crlike_device, "resolve_crlike_wta_device", "wta whole-key upload")
    calls.watch(em, "_run_jax_buckets", "em")
    calls.watch(pug_device, "connected_components_batched", "pug cc")
    calls.watch(atac_device, "sort_rle_device", "atac sort+rle")
    return calls


def print_selection() -> bool:
    """Print the implementation each stage's own selection function
    picks; returns whether the permit histogram runs on a mesh."""
    from alevin_fry_tpu.ops import atac_device, crlike, pug
    from alevin_fry_tpu.parallel.mesh import mesh_from_env
    from alevin_fry_tpu.pipeline.collate import collate_device_enabled
    from alevin_fry_tpu.pipeline.gpl import gpl_mesh_from_env

    gm = gpl_mesh_from_env()
    em_mesh = mesh_from_env()
    say("selection: rescue (>= 32k queries) =",
        "device" if crlike.accelerator_present() or
        os.environ.get("AFT_RESCUE_BACKEND") == "jax" else "host")
    say("selection: permit histogram =",
        f"device mesh of {gm.devices.size}" if gm is not None
        else "host (device path needs >= 2 devices)")
    say("selection: collate order =",
        "device all-to-all" if collate_device_enabled() else "host")
    say("selection: cr-like WTA =",
        "device" if crlike.device_backend_enabled(0) else "host")
    say("selection: EM =",
        f"device, mesh of {em_mesh.devices.size}" if em_mesh is not None
        else "device, one card")
    say("selection: PUG CC =", "device" if pug.pug_cc_device_enabled() else "host")
    say("selection: ATAC sort+RLE =",
        "device" if atac_device.device_backend_enabled() else "host")
    return gm is not None


def run_stages(cmds, calls: DeviceCalls | None, need: dict):
    """Run CLI stages; with ``calls``, require each stage's device entry
    points (``need[stage]``) to have been called."""
    for stage, argv in cmds:
        before = dict(calls.n) if calls else {}
        t = time.perf_counter()
        run_cli(argv)
        dt = time.perf_counter() - t
        ran = ""
        if calls is not None:
            ran = {k: v - before.get(k, 0) for k, v in calls.n.items()
                   if v - before.get(k, 0)}
            missing = [lab for lab in need.get(stage, ()) if not ran.get(lab)]
            check(not missing, f"{stage}: device path not taken: {missing}")
            ran = f"device calls {ran}"
        say(f"stage {stage}: {dt:.3f} s {ran}")


# --- comparisons --------------------------------------------------------------

def same_bytes(a: Path, b: Path, what: str):
    check(a.read_bytes() == b.read_bytes(), f"{what}: {a.name} differs from host")
    say(f"compare {what}: {a.name} byte-identical ({a.stat().st_size} B)")


def compare_rna(dev: Path, host: Path):
    for f in ("permit_freq.bin", "permit_map.bin", "map.collated.rad"):
        same_bytes(dev / "gpl" / f, host / "gpl" / f, "gpl/collate")
    for name, _tg, _res in QUANTS:
        d = dev / f"q_{name}" / "alevin"
        h = host / f"q_{name}" / "alevin"
        for f in ("quants_mat_rows.txt", "quants_mat_cols.txt"):
            same_bytes(d / f, h / f, f"quant {name}")
        if name != "em":
            same_bytes(d / "quants_mat.mtx", h / "quants_mat.mtx", f"quant {name}")
            continue
        compare_em(d / "quants_mat.mtx", h / "quants_mat.mtx")


def compare_em(dev_mtx: Path, host_mtx: Path):
    """cr-like-em: the same nonzero set and every entry within rtol/atol
    2e-4 of the host's; the cells that miss the bound are listed."""
    from alevin_fry_tpu.radz.mtx import read_matrix_market

    def entries(path):
        r, c, v, shape = read_matrix_market(path)
        key = np.asarray(r, np.int64) * shape[1] + np.asarray(c, np.int64)
        order = np.argsort(key)
        return key[order], np.asarray(v, np.float64)[order], shape

    dk, dv, dshape = entries(dev_mtx)
    hk, hv, hshape = entries(host_mtx)
    check(dshape == hshape, "quant em: matrix shapes differ")
    keys = np.union1d(dk, hk)
    d = np.zeros(len(keys))
    h = np.zeros(len(keys))
    d[np.searchsorted(keys, dk)] = dv
    h[np.searchsorted(keys, hk)] = hv
    set_diff = (d != 0) != (h != 0)
    bound = np.abs(d - h) > EM_ATOL + EM_RTOL * np.abs(h)
    bad = set_diff | bound
    cell = keys // dshape[1]
    bad_cells = np.unique(cell[bad])
    worst = float(np.max(np.abs(d - h) / (EM_ATOL + EM_RTOL * np.abs(h))))
    say(f"compare quant em: {len(hk)} host nonzeros, {len(dk)} device; "
        f"{int(set_diff.sum())} entries in one set only; {int(bound.sum())} "
        f"entries outside rtol/atol {EM_RTOL}; {len(bad_cells)} of "
        f"{dshape[0]} cells differ; worst share of the bound {worst:.3g}")
    for ci in bad_cells[:8]:
        m = cell == ci
        idx = np.flatnonzero(m & bad)[:6]
        say(f"  cell {ci}: host mass {h[m].sum():.4f} device {d[m].sum():.4f}; "
            f"{int(m.sum())} entries; differing (col host device) "
            + " ".join(f"({keys[i] % dshape[1]} {h[i]:.5g} {d[i]:.5g})" for i in idx))
    check(len(bad_cells) == 0, "quant em: nonzero set or values outside rtol/atol 2e-4")


# --- phases -------------------------------------------------------------------

def phase_device(rehearse: bool, want_count: int):
    import jax

    dev = jax.devices()[0]
    if not rehearse:
        check(dev.platform == "gpu", f"no GPU: JAX found {dev.platform}")
        check(len(jax.devices()) == want_count,
              f"{len(jax.devices())} devices visible, want {want_count}")
        say("nvidia-smi:", nvidia_smi_line())
    say(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    from alevin_fry_tpu.radz import _native

    check(_native.available(), "native codec did not load")
    say("native codec: loaded")


def phase_data(work: Path, reads: int, frags: int, rehearse: bool, atac: bool):
    from synth_hard import make_hard_atac_dataset, make_hard_dataset

    t = time.perf_counter()
    rna = work / "rna"
    rna.mkdir(parents=True)
    genes = 203 if rehearse else N_GENES
    cells = 60 if rehearse else N_CELLS
    stats = make_hard_dataset(
        rna, np.random.RandomState(20), n_cells=cells, n_reads=reads,
        n_genes=genes, txps_per_gene=TXPS_PER_GENE, bc_len=16, umi_len=12,
    )
    say(f"data rna: {stats['n_reads']} reads, {cells} cells (+"
        f"{stats['n_ambient_barcodes']} ambient), {genes} genes x "
        f"{TXPS_PER_GENE} transcripts, 16-bp CB, 12-bp UMI, permit list "
        f"{stats['permit_list_size']}; {time.perf_counter() - t:.1f} s")
    if reads < 20_000_000 and not rehearse:
        say(f"data rna: read count cut to {reads} (full size is 20M reads)")
    if atac:
        t = time.perf_counter()
        ad = work / "atac"
        ad.mkdir()
        st = make_hard_atac_dataset(
            ad, np.random.RandomState(21), n_cells=60 if rehearse else 2000,
            n_frags=frags, bc_len=16,
        )
        say(f"data atac: {st['n_fragments']} fragments; "
            f"{time.perf_counter() - t:.1f} s")


def host_reference(work: Path, with_atac: bool):
    """Start the CPU-only subprocess that runs the same commands."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("AFT_")}
    env["JAX_PLATFORMS"] = "cpu"
    argv = [sys.executable, str(REPO / "chip_smoke.py"), "--host-reference",
            str(work)] + (["--with-atac"] if with_atac else [])
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_host(proc):
    t = time.perf_counter()
    out, _ = proc.communicate()
    for line in out.splitlines():
        if line.startswith("stage "):
            say("host", line)
    check(proc.returncode == 0,
          f"host reference failed (exit {proc.returncode}):\n{out[-4000:]}")
    return time.perf_counter() - t


def phase_kernels(rehearse: bool):
    """Each device kernel at real widths against its plain reference."""
    import jax

    kind = jax.devices()[0].device_kind
    failed = []
    for kernel in (kernel_rescue, kernel_wta, kernel_em, kernel_pug, kernel_atac):
        try:
            kernel(kind, rehearse)
        except Failed as exc:  # the other kernels still report
            say(f"FAILED: {exc}")
            failed.append(str(exc))
    check(not failed, "; ".join(failed))


def kernel_rescue(kind, small):
    from alevin_fry_tpu.ops import barcodes as bcops
    from alevin_fry_tpu.ops.rescue_device import find_neighbors_searchsorted

    nq, nk = (20_000, 10_000) if small else (1_700_000, 1_100_000)
    rng = np.random.RandomState(1)
    kept = np.unique(rng.randint(0, 1 << 32, size=nk, dtype=np.uint64))
    muts = bcops.snp_neighbors(rng.choice(kept, nq // 2), 16)
    q = np.concatenate([
        muts[np.arange(nq // 2), rng.randint(0, 64, nq // 2)],
        rng.randint(0, 1 << 32, size=nq - nq // 2, dtype=np.uint64),
    ])
    rc, rr = bcops.find_neighbors_batch(q, kept, 16)
    c, r = find_neighbors_searchsorted(q, kept, 16)
    check(np.array_equal(c, rc), "rescue: counts differ from host")
    one = rc == 1
    check(np.array_equal(r[one], rr[one]), "rescue: representatives differ")
    t_dev = median_time(lambda: find_neighbors_searchsorted(q, kept, 16))
    t_host = median_time(lambda: bcops.find_neighbors_batch(q, kept, 16), n=3)
    say(f"kernel rescue Q={len(q)} K={len(kept)} L=16: counts equal, reps "
        f"equal where count==1; device {t_dev * 1e3:.1f} ms, host native "
        f"{t_host * 1e3:.1f} ms [{kind}]")


def _wta_case(n, n_genes, seed=3):
    rng = np.random.RandomState(seed)
    c = np.sort(rng.randint(0, N_CELLS, n)).astype(np.uint64)
    u = rng.randint(0, 1 << 24, n).astype(np.uint64)
    nal = np.where(rng.rand(n) < 0.8, 1, 2)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(nal, out=offs[1:])
    refs = rng.randint(0, n_genes * TXPS_PER_GENE, int(offs[-1])).astype(np.uint32)
    return c, u, refs, offs


def kernel_wta(kind, small):
    from alevin_fry_tpu.ops import crlike

    n_genes = 200 if small else N_GENES
    n = 20_000 if small else 3_600_000  # ~4M deduplicated (read, gene) keys
    c, u, refs, offs = _wta_case(n, n_genes)
    tx = np.arange(n_genes * TXPS_PER_GENE)
    t2g = (tx // TXPS_PER_GENE).astype(np.uint32)
    t2g_usa = (2 * (tx // TXPS_PER_GENE) + tx % 2).astype(np.uint32)
    nr_usa = 3 * n_genes
    for name, tg, nr, usa in (("plain", t2g, n_genes, None),
                              ("USA", t2g_usa, nr_usa, (nr_usa // 3, 2 * (nr_usa // 3)))):
        want = crlike.wta_counts_native(c, u, refs, offs, tg, nr, usa_offsets=usa)
        got = crlike.wta_counts_device(c, u, refs, offs, tg, nr, usa=usa is not None)
        check(got is not None and all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"wta {name}: differs from wta_counts_native")
        t_dev = median_time(lambda: crlike.wta_counts_device(
            c, u, refs, offs, tg, nr, usa=usa is not None))
        t_host = median_time(lambda: crlike.wta_counts_native(
            c, u, refs, offs, tg, nr, usa_offsets=usa), n=3)
        n_keys = int(offs[-1])
        say(f"kernel wta {name} ({n_keys} alignments, {len(c)} reads): equal to "
            f"native; device path (host prep, upload, program, fetch) "
            f"{t_dev * 1e3:.1f} ms, host native {t_host * 1e3:.1f} ms [{kind}]")
    if not small:
        sys.path.insert(0, str(REPO / "scripts"))
        import profile_kernels

        r = profile_kernels.profile_wta()
        say(f"kernel wta plain program alone, 4M keys: {r['per_round_ms']} "
            f"ms/round [{kind}]")


def _em_round_reference(lab, lens, counts, U):
    """One compact EM round in NumPy f32, thresholded and gathered like
    the kernel's fixed-round output."""
    from alevin_fry_tpu.constants import MIN_OUTPUT_ALPHA

    B, E, L = lab.shape
    bidx = np.broadcast_to(np.arange(B)[:, None, None], lab.shape)
    lmask = np.arange(L)[None, None, :] < lens[:, :, None]
    single = lens == 1
    valid = lens > 0
    multi = valid & ~single
    seeds = np.zeros((B, U + 1), np.float32)
    np.add.at(seeds, (np.arange(B)[:, None], np.where(single, lab[:, :, 0], U)),
              np.where(single & valid, counts, 0).astype(np.float32))
    alphas = ((seeds + np.float32(0.5)) * np.float32(1e-3)).astype(np.float32)
    alphas[:, U] = 0
    ab = np.where(lmask, alphas[bidx, lab], np.float32(0))
    denom = ab.sum(axis=2, dtype=np.float32)
    inv = np.where((denom > 0) & multi,
                   counts / np.maximum(denom, np.float32(1e-30)), 0).astype(np.float32)
    contrib = np.where(multi[:, :, None], ab * inv[:, :, None], 0).astype(np.float32)
    out = seeds.copy()
    np.add.at(out, (bidx, np.where(lmask, lab, U)), contrib)
    out[:, U] = 0
    out = np.where(out < MIN_OUTPUT_ALPHA, np.float32(0), out)
    return np.where(lmask, out[bidx, lab], np.float32(0))


def kernel_em(kind, small):
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.em import _get_em_kernel_compact, compact_local_ids

    B, E, L = (64, 16, 4) if small else (4096, 64, 8)
    R = 8192
    rng = np.random.RandomState(0)
    lab = rng.randint(0, R, (B, E, L)).astype(np.int64)
    lens = rng.randint(1, L + 1, (B, E)).astype(np.int32)
    counts = rng.randint(1, 50, (B, E)).astype(np.float32)
    lab_loc, p1, p2, U = compact_local_ids(lab, R, None)
    want = _em_round_reference(lab_loc, lens, counts, U)
    args = [jnp.asarray(x) for x in (lab_loc, lens, counts, p1, p2)]
    fn = _get_em_kernel_compact(False, False, fixed_rounds=1, dense=True)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(fn(*args, R, U, False))
    err = np.abs(got - want)
    worst = float(np.max(err / (EM_ATOL + EM_RTOL * np.abs(want))))
    check(worst <= 1.0, f"em dense round: outside rtol/atol 2e-4 (worst {worst:.3g})")
    say(f"kernel em dense round B={B} U={U}: within rtol/atol 2e-4 of the NumPy "
        f"f32 reference (worst share {worst:.3g})")
    if small:
        return
    sys.path.insert(0, str(REPO / "scripts"))
    import profile_kernels

    for label, prof in (("dense factored", profile_kernels.profile_em_dense),
                        ("compact gather/scatter", profile_kernels.profile_em_compact)):
        r = prof(False)
        say(f"kernel em round {label} B={B} E*L={E * L} U={U}: "
            f"{r['per_round_ms']} ms/round [{kind}]")


def _union_find_labels(n, deg, nbr):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    src = np.repeat(np.arange(n), deg)
    for a, b in zip(src.tolist(), nbr.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.asarray([find(x) for x in range(n)], np.int32)


def kernel_pug(kind, small):
    from alevin_fry_tpu.ops import pug

    n_cells = 300 if small else 20_000
    rng = np.random.RandomState(1)
    n_nodes = rng.randint(1, 200, n_cells).astype(np.int64)
    node_off = np.concatenate([[0], np.cumsum(n_nodes)])
    # random undirected edges, stored in both directions (the PUG graph
    # build hands the CC a symmetric adjacency)
    n_edges = n_nodes  # about one edge per node
    ecell = np.repeat(np.arange(n_cells), n_edges)
    a = rng.randint(0, 1 << 30, len(ecell)) % n_nodes[ecell]
    b = rng.randint(0, 1 << 30, len(ecell)) % n_nodes[ecell]
    src = np.concatenate([a, b]) + node_off[np.concatenate([ecell, ecell])]
    dst = np.concatenate([b, a])
    order = np.argsort(src, kind="stable")
    deg = np.bincount(src, minlength=int(node_off[-1])).astype(np.int64)
    nbr = dst[order].astype(np.int64)
    got = pug._cc_labels_batched(n_nodes, deg, nbr)
    adj_off = np.concatenate([[0], np.cumsum(deg)])
    for ci in range(n_cells):
        s, e = node_off[ci], node_off[ci + 1]
        want = _union_find_labels(int(e - s), deg[s:e], nbr[adj_off[s]:adj_off[e]])
        check(np.array_equal(got[s:e], want), f"pug cc: cell {ci} differs from union-find")
    t_dev = median_time(lambda: pug._cc_labels_batched(n_nodes, deg, nbr), n=3)
    say(f"kernel pug cc {n_cells} graphs ({int(n_nodes.sum())} nodes): equal to "
        f"union-find; device {t_dev * 1e3:.1f} ms [{kind}]")


def kernel_atac(kind, small):
    from alevin_fry_tpu.ops import atac_device

    n = 40_000 if small else 4_000_000
    rng = np.random.RandomState(5)
    cols = [rng.randint(0, 24, n), rng.randint(0, 200_000_000, n),
            rng.randint(30, 1000, n), rng.randint(0, 1 << 32, n)]
    cols = [np.concatenate([c, c[: n // 5]]).astype(np.int64) for c in cols]
    wc, wn = atac_device.sort_rle_host(cols)
    gc, gn = atac_device.sort_rle_device(cols)
    check(all(np.array_equal(a, b) for a, b in zip(gc, wc)) and np.array_equal(gn, wn),
          "atac sort+rle: differs from sort_rle_host")
    t_dev = median_time(lambda: atac_device.sort_rle_device(cols))
    t_host = median_time(lambda: atac_device.sort_rle_host(cols), n=3)
    say(f"kernel atac sort+rle {len(cols[0])} rows: equal to host; device "
        f"{t_dev * 1e3:.1f} ms, host {t_host * 1e3:.1f} ms [{kind}]")


def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    check(rc == 0, f"tests marked gpu: pytest exit {int(rc)}")
    say("tests marked gpu: passed")


# --- entry points ---------------------------------------------------------------

def host_reference_main(work: Path, with_atac: bool) -> int:
    """The CPU-only subprocess: the same commands into ``work/host``."""
    run_stages(rna_commands(work / "rna", work / "host"), None, {})
    if with_atac:
        run_stages(atac_commands(work / "atac", work / "host"), None, {})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="phases 2-4 only, on four visible cards")
    ap.add_argument("--reads", type=int, default=None,
                    help="RNA reads (default 20M; widths stay as they are)")
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--host-reference", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--with-atac", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.host_reference:
        return host_reference_main(args.host_reference, args.with_atac)

    rehearse = args.rehearse_on_cpu
    if rehearse:
        os.environ.update(_FORCE_DEVICE_ENV)
        if args.four_cards:  # the CPU's virtual devices stand in for cards
            os.environ.update(AFT_GPL_MESH="auto", AFT_EM_MESH="auto")
    from alevin_fry_tpu.utils import configure_compile_cache

    configure_compile_cache()
    want_count = 4 if args.four_cards else 1
    reads = args.reads or (30_000 if rehearse else 20_000_000)
    frags = 20_000 if rehearse else 5_000_000
    work = REPO / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    proc = None  # the CPU reference subprocess
    try:
        say("== phase 1: device")
        phase_device(rehearse, want_count)
        say("== phase 2: data")
        with_atac = not args.four_cards
        phase_data(work, reads, frags, rehearse, with_atac)
        say("== phase 3: pipeline on the card")
        calls = watch_device_paths()
        multi = print_selection()
        need = {
            "generate-permit-list": ("rescue",) + (("histogram",) if multi else ()),
            "collate": ("collate order",),
            "quant crlike": ("wta packed upload",),
            # 36,601 genes give 17-bit USA ids: with a 24-bit UMI that
            # is 41 bits, past the packed upload's 40
            "quant usa": ("wta packed upload",) if rehearse
            else ("wta whole-key upload",),
            "quant em": ("em",),
            "quant parsimony": ("pug cc",),
        }
        # on four cards the CPU reference runs beside the device stages
        proc = host_reference(work, with_atac) if args.four_cards else None
        run_stages(rna_commands(work / "rna", work / "dev"), calls, need)
        if with_atac:
            say("== phase 6: ATAC chain on the card")
            run_stages(atac_commands(work / "atac", work / "dev"), calls, {
                "atac generate-permit-list": ("rescue",),
                "atac sort": ("atac sort+rle",),
                "atac deduplicate": ("atac sort+rle",),
            })
        say("== phase 4: host reference (JAX_PLATFORMS=cpu subprocess)")
        proc = proc or host_reference(work, with_atac)
        say(f"host reference: {wait_host(proc):.1f} s")
        failed = []
        try:
            compare_rna(work / "dev", work / "host")
        except Failed as exc:  # keep going: later phases still report
            say(f"FAILED: {exc}")
            failed.append(str(exc))
        if with_atac:
            same_bytes(work / "dev" / "atac" / "map.bed",
                       work / "host" / "atac" / "map.bed", "atac")
        if not args.four_cards:
            say("== phase 5: kernels at real widths")
            phase_kernels(rehearse)
            if not rehearse:
                say("== phase 7: tests marked gpu")
                phase_tests()
        check(not failed, "; ".join(failed))
    except Failed as exc:
        say(f"FAILED: {exc}")
        return 1
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if rehearse:
        say("rehearsal on the CPU passed; no result is printed without a GPU")
        return 3
    import jax

    dev = jax.devices()
    say("nvidia-smi:", nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
