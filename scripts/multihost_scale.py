#!/usr/bin/env python
"""Mid-scale multi-host (DCN) measurement (r5).

The 2-process jax.distributed chains were byte-identity-tested only at
toy sizes (tests/test_multihost.py, ~1k reads).  This script runs the
full distributed gpl -> collate -> quant chain at 10M reads / 10k
cells on the hardened generator, in BOTH single-process and 2-process
forms, and reports wall times plus artifact identity.

On this 2-core box both forms share the same silicon, so the 2-process
wall time is NOT a scaling measurement — the quantity of interest is
the DCN-merge OVERHEAD (histogram merges, spill-bucket stream gather,
rank-0 artifact writes + barriers) at a six-orders-larger workload
than the tests, and that the byte-identity contract survives scale.

Writes MULTIHOST_SCALE_r05.json.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

_WORKER = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
coord = sys.argv[2]
os.environ["AFT_COORDINATOR"] = coord
os.environ["AFT_NUM_PROCESSES"] = "2"
os.environ["AFT_PROCESS_ID"] = str(pid)
os.environ["AFT_CRLIKE_BACKEND"] = "host"
os.environ["AFT_RESCUE_BACKEND"] = "host"
os.environ["AFT_EM_BACKEND"] = "host"
sys.path.insert(0, sys.argv[5])
from pathlib import Path
from alevin_fry_tpu.parallel import dist
from alevin_fry_tpu.pipeline.gpl import (
    CellFilterMethod, GenPermitListOpts, generate_permit_list,
)
from alevin_fry_tpu.pipeline.collate import collate
from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify
root = Path(sys.argv[3]); base = Path(sys.argv[4])
t0 = time.perf_counter()
generate_permit_list(GenPermitListOpts(
    input_dir=root / "rad", output_dir=base / "gpl",
    fmeth=CellFilterMethod("unfiltered", path=root / "permit.txt",
                           min_reads=10),
    expected_ori="fw", cmdline="mh-scale",
))
dist.barrier("gpl_done")
t1 = time.perf_counter()
collate(base / "gpl", root / "rad", cmdline="mh-scale")
t2 = time.perf_counter()
quantify(QuantOpts(
    input_dir=base / "gpl", tg_map=root / "t2g_3col.tsv",
    output_dir=base / "quant", resolution="cr-like", cmdline="mh-scale",
))
t3 = time.perf_counter()
print(f"MH_TIMES pid={pid} gpl={t1-t0:.2f} collate={t2-t1:.2f} "
      f"quant={t3-t2:.2f}", flush=True)
"""


def main():
    from synth_hard import make_hard_dataset

    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify

    os.environ.setdefault("AFT_CRLIKE_BACKEND", "host")
    os.environ.setdefault("AFT_RESCUE_BACKEND", "host")
    os.environ.setdefault("AFT_EM_BACKEND", "host")
    os.environ.setdefault("AFT_GPL_MESH", "0")
    os.environ.setdefault("AFT_EM_MESH", "0")
    os.environ.setdefault("AFT_COLLATE_BACKEND", "host")

    tmp_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    d = Path(tempfile.mkdtemp(prefix="aft_mh_scale_", dir=tmp_root))
    report = {"n_reads": None}
    try:
        rng = np.random.RandomState(5)
        stats = make_hard_dataset(
            d, rng, n_cells=10_000, n_reads=10_000_000, n_genes=5000,
        )
        report["n_reads"] = stats["n_reads"]

        # single-process reference
        t0 = time.perf_counter()
        generate_permit_list(GenPermitListOpts(
            input_dir=d / "rad", output_dir=d / "gpl1",
            fmeth=CellFilterMethod("unfiltered", path=d / "permit.txt",
                                   min_reads=10),
            expected_ori="fw", cmdline="mh-scale",
        ))
        t1 = time.perf_counter()
        collate(d / "gpl1", d / "rad", cmdline="mh-scale")
        t2 = time.perf_counter()
        quantify(QuantOpts(
            input_dir=d / "gpl1", tg_map=d / "t2g_3col.tsv",
            output_dir=d / "q1", resolution="cr-like", cmdline="mh-scale",
        ))
        t3 = time.perf_counter()
        report["single_process_s"] = {
            "gpl": round(t1 - t0, 2), "collate": round(t2 - t1, 2),
            "quant": round(t3 - t2, 2), "total": round(t3 - t0, 2),
        }

        # 2 real jax.distributed processes
        s = socket.socket()
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
        s.close()
        env = {
            k: v for k, v in os.environ.items()
            if not k.startswith(("AFT_", "XLA_", "JAX_"))
        }
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(pid), coord,
                 str(d), str(d / "mh"), str(REPO)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            )
            for pid in (0, 1)
        ]
        logs = [p.communicate(timeout=1200)[0].decode() for p in procs]
        wall = time.perf_counter() - t0
        for p, lg in zip(procs, logs):
            if p.returncode != 0:
                print(lg[-4000:])
                raise SystemExit("worker failed")
        times = [ln for lg in logs for ln in lg.splitlines()
                 if ln.startswith("MH_TIMES")]
        report["two_process_wall_s"] = round(wall, 2)
        report["two_process_stage_lines"] = times

        ident = {}
        for name in ("alevin/quants_mat.mtx", "alevin/quants_mat_rows.txt",
                     "featureDump.txt"):
            ident[name] = (
                (d / "mh" / "quant" / name).read_bytes()
                == (d / "q1" / name).read_bytes()
            )
        gident = (
            (d / "mh" / "gpl" / "permit_freq.bin").read_bytes()
            == (d / "gpl1" / "permit_freq.bin").read_bytes()
        )
        report["artifacts_identical"] = {**ident, "permit_freq.bin": gident}
        assert all(report["artifacts_identical"].values()), report
        report["note"] = (
            "both processes share this box's 2 cores, so 2-process wall "
            "time measures DCN/gloo coordination overhead (distributed "
            "init, barriers, histogram + bucket-stream merges) on top "
            "of undivided compute — NOT scaling; the byte-identity at "
            "10M reads is the contract being validated.  On real "
            "multi-host hardware the compute divides while this "
            "overhead stays (see COLLECTIVES_r05.json for the "
            "predicted balance)."
        )
        out = REPO / "MULTIHOST_SCALE_r05.json"
        out.write_text(json.dumps(report, indent=1) + "\n")
        print(json.dumps(report))
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
