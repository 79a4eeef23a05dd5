#!/usr/bin/env python
"""Parsimony wall-clock breakdown: graph build vs connected components
vs greedy arborescence cover.

The PUG CC runs as a batched device kernel, but the greedy cover (pugutils.rs:308-391 semantics) stays in
host C++ (csrc/radc.cpp::radc_pug_cover).  This script measures what
fraction of parsimony resolution the cover actually is at bench scale
(2M reads / 4k cells, the bench.py distribution), phase by phase:

    build  — radc_pug_graph_build (dedup, Hamming-1 UMI edges, CSR)
    cc     — batched device CC over the per-cell graphs
             (ops/pug_device.py; host union-find when no accelerator)
    cover  — radc_pug_cover (greedy monochromatic arborescence)

plus the fused single-call native path (radc_pug_resolve) as the
baseline total.  Decision rule: if cover dominates,
prototype the masked batched-BFS device cover (SURVEY §7.2(6)); if it
doesn't, record that and stop.

Run: python scripts/pug_cover_profile.py [--reads 2000000 --cells 4000]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_reads(n_reads: int, n_cells: int, n_txps: int, seed=0):
    """The bench.py read distribution (Zipf cells, 20% 2-txp maps),
    already collated (cell-contiguous) as quant would see it."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, n_cells + 1) ** 0.7
    w /= w.sum()
    cell = np.sort(rng.choice(n_cells, size=n_reads, p=w)).astype(np.int64)
    umi = rng.randint(0, 1 << 24, size=n_reads).astype(np.uint64)
    nal = np.where(rng.rand(n_reads) < 0.8, 1, 2)
    offs = np.zeros(n_reads + 1, np.int64)
    np.cumsum(nal, out=offs[1:])
    refs = rng.randint(0, n_txps, size=int(offs[-1])).astype(np.uint32)
    tid_to_gid = (np.arange(n_txps, dtype=np.uint32) // 4)
    return cell, umi, refs, offs, tid_to_gid


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--cells", type=int, default=4000)
    ap.add_argument("--txps", type=int, default=20_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from alevin_fry_tpu.ops.pug import _cc_labels_batched
    from alevin_fry_tpu.radz import _native

    assert _native.available(), "native lib required (make -C csrc)"

    cell, umi, refs, offs, tid_to_gid = make_reads(
        args.reads, args.cells, args.txps
    )
    cells = np.unique(cell)
    boundaries = np.searchsorted(cell, cells, side="left")
    cro = np.append(boundaries, len(cell)).astype(np.int64)

    # fused single-call baseline (host union-find CC inside)
    t0 = time.perf_counter()
    _native.pug_resolve(
        cro, umi, refs, offs, tid_to_gid, False, False, 1000
    )
    t_fused = time.perf_counter() - t0

    # phase-split path
    t0 = time.perf_counter()
    handle, n_nodes, deg, nbrs_flat = _native.pug_graph_build(
        cro, umi, refs, offs, tid_to_gid, False, False
    )
    t_build = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        comp = _cc_labels_batched(n_nodes, deg, nbrs_flat)
        t_cc = time.perf_counter() - t0
        t0 = time.perf_counter()
        _native.pug_cover(
            handle, cro, offs, tid_to_gid, False, 1000, comp
        )
        t_cover = time.perf_counter() - t0
    finally:
        _native.pug_free(handle)

    total = t_build + t_cc + t_cover
    res = {
        "kernel": f"parsimony phase split ({args.reads >> 20}M reads, "
                  f"{args.cells} cells)",
        "fused_native_resolve_s": round(t_fused, 3),
        "build_s": round(t_build, 3),
        "cc_s": round(t_cc, 3),
        "cover_s": round(t_cover, 3),
        "cover_fraction_of_split_total": round(t_cover / total, 3),
        "note": (
            "cc phase uses the device CC when an accelerator is attached, "
            "host label-prop otherwise"
        ),
    }
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
