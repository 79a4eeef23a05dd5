#!/usr/bin/env python
"""Production-scale pipeline runs.

This script drives production-scale shapes through the REAL pipeline with the out-of-core machinery engaged at its default
thresholds, on the distribution-hardened generator
(tests/synth_hard.py):

* ``rna50m``    — 50M reads / 50k cells / 5k genes, USA mode,
  cr-like AND cr-like-em (the PBMC-at-scale shape).  50M reads >
  the 30M default ``max_records``, so collate runs its spill-bucket
  out-of-core path by default.
* ``nuclei100k`` — 25M reads / 100k cells / 8k genes, 25% spliced
  (single-nucleus profile), USA cr-like + knee-mode gpl.

Per stage: wall time, reads/s, and peak RSS (sampled from
/proc/self/status at 50 ms).  After the cr-like-em run the EM ladder
routing is reported (cells on the device ladder vs NumPy-outlier
cells, ops/em.py::LADDER_STATS): how many giant cells route to
NumPy.  ``--device`` additionally runs quant
cr-like USA through the device WTA path.

Writes BENCH_SCALE.json.  Match: collate.rs:595-628 (bounded
scatter/gather), quant.rs:1527-1743 (bounded streaming).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

DEVICE = "--device" in sys.argv
QUICK = "--quick" in sys.argv  # CI-sized smoke of the same code path

# host-path pinning (as in bench.py; --device opts the WTA/EM onto the
# device)
if not DEVICE:
    os.environ.setdefault("AFT_CRLIKE_BACKEND", "host")
    os.environ.setdefault("AFT_RESCUE_BACKEND", "host")
    os.environ.setdefault("AFT_EM_BACKEND", "host")
    os.environ.setdefault("AFT_EM_MESH", "0")
    os.environ.setdefault("AFT_GPL_MESH", "0")
    os.environ.setdefault("AFT_PUG_CC_BACKEND", "host")
else:
    os.environ.setdefault("AFT_CRLIKE_BACKEND", "jax")
    os.environ.setdefault("AFT_QUANT_BLOCK_RECORDS", "8000000")
    os.environ.setdefault("AFT_WTA_ASYNC", "1")
os.environ.setdefault("AFT_COLLATE_BACKEND", "host")


class RssSampler:
    """Peak-RSS sampler over a scoped stage (50 ms cadence)."""

    def __init__(self):
        self.peak_mb = 0.0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _read(self):
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    def _run(self):
        while not self._stop.is_set():
            self.peak_mb = max(self.peak_mb, self._read())
            self._stop.wait(0.05)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        self._t.join()
        self.peak_mb = max(self.peak_mb, self._read())


def run_config(name, n_reads, n_cells, n_genes, spliced_frac,
               resolutions, knee=False):
    from synth_hard import make_hard_dataset

    from alevin_fry_tpu.ops import em as em_mod
    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify

    tmp_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    d = Path(tempfile.mkdtemp(prefix=f"aft_scale_{name}_", dir=tmp_root))
    out = {"config": name, "n_cells": n_cells, "n_genes": n_genes}
    try:
        rng = np.random.RandomState(5)
        t0 = time.perf_counter()
        stats = make_hard_dataset(
            d, rng, n_cells=n_cells, n_reads=n_reads, n_genes=n_genes,
            spliced_frac=(0.75 if spliced_frac is None else spliced_frac),
        )
        out["generate_s"] = round(time.perf_counter() - t0, 1)
        out["n_reads"] = stats["n_reads"]
        rad_size = (d / "rad" / "map.rad").stat().st_size
        out["rad_bytes"] = rad_size

        stages = {}

        with RssSampler() as rss:
            t0 = time.perf_counter()
            generate_permit_list(GenPermitListOpts(
                input_dir=d / "rad", output_dir=d / "gpl",
                fmeth=CellFilterMethod(
                    "unfiltered", path=d / "permit.txt", min_reads=10
                ),
                expected_ori="fw", cmdline="scale-bench",
            ))
            dt = time.perf_counter() - t0
        stages["gpl"] = {
            "s": round(dt, 2),
            "reads_per_s": round(stats["n_reads"] / dt),
            "peak_rss_mb": round(rss.peak_mb),
        }

        with RssSampler() as rss:
            t0 = time.perf_counter()
            collate(d / "gpl", d / "rad", cmdline="scale-bench")
            dt = time.perf_counter() - t0
        spilled = stats["n_reads"] > 30_000_000
        stages["collate"] = {
            "s": round(dt, 2),
            "reads_per_s": round(stats["n_reads"] / dt),
            "peak_rss_mb": round(rss.peak_mb),
            "out_of_core_spill_engaged": spilled,
        }

        for res in resolutions:
            em_mod.LADDER_STATS["device_cells"] = 0
            em_mod.LADDER_STATS["numpy_outlier_cells"] = 0
            with RssSampler() as rss:
                t0 = time.perf_counter()
                quantify(QuantOpts(
                    input_dir=d / "gpl", output_dir=d / f"quant_{res}",
                    tg_map=d / "t2g_3col.tsv", resolution=res,
                    cmdline="scale-bench",
                ))
                dt = time.perf_counter() - t0
            entry = {
                "s": round(dt, 2),
                "reads_per_s": round(stats["n_reads"] / dt),
                "peak_rss_mb": round(rss.peak_mb),
            }
            if res.endswith("-em"):
                ls = dict(em_mod.LADDER_STATS)
                tot = ls["device_cells"] + ls["numpy_outlier_cells"]
                entry["em_ladder"] = {
                    **ls,
                    "outlier_fraction": round(
                        ls["numpy_outlier_cells"] / tot, 5
                    ) if tot else 0.0,
                }
            stages[f"quant_{res}"] = entry

        if knee:
            with RssSampler() as rss:
                t0 = time.perf_counter()
                generate_permit_list(GenPermitListOpts(
                    input_dir=d / "rad", output_dir=d / "gpl_knee",
                    fmeth=CellFilterMethod("knee"),
                    expected_ori="fw", cmdline="scale-bench",
                ))
                dt = time.perf_counter() - t0
            import struct

            raw = (d / "gpl_knee" / "permit_freq.bin").read_bytes()
            stages["gpl_knee"] = {
                "s": round(dt, 2),
                "peak_rss_mb": round(rss.peak_mb),
                "selected_cells": struct.unpack("<Q", raw[16:24])[0],
                "true_real_cells": n_cells,
            }

        total_s = sum(
            v["s"] for k, v in stages.items() if k != "gpl_knee"
        )
        out["stages"] = stages
        out["total_s"] = round(total_s, 2)
        out["end_to_end_reads_per_s_crlike"] = round(
            stats["n_reads"] / (
                stages["gpl"]["s"] + stages["collate"]["s"]
                + stages["quant_cr-like"]["s"]
            )
        )
        out["generator_stats"] = {
            k: v for k, v in stats.items()
            if k != "bc_error_rate_per_cycle"
        }
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main():
    scale = 0.02 if QUICK else 1.0
    results = {"mode": "device" if DEVICE else "host"}
    results["rna50m"] = run_config(
        "rna50m",
        n_reads=int(50_000_000 * scale),
        n_cells=int(50_000 * scale) or 100,
        n_genes=5000,
        spliced_frac=None,
        # parsimony drives the PUG graph build + greedy cover at 48M
        # pairs — at this scale the hard generator's Hamming-1 UMI
        # satellites give the edge rules real work (r5)
        resolutions=["cr-like", "cr-like-em", "parsimony"],
    )
    results["nuclei100k"] = run_config(
        "nuclei100k",
        n_reads=int(25_000_000 * scale),
        n_cells=int(100_000 * scale) or 200,
        n_genes=8000,
        spliced_frac=0.25,
        resolutions=["cr-like"],
        knee=True,
    )
    name = "BENCH_SCALE_DEVICE.json" if DEVICE else "BENCH_SCALE.json"
    out = Path(__file__).resolve().parent.parent / name
    out.write_text(json.dumps(results, indent=1) + "\n")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
