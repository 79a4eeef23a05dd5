#!/usr/bin/env python3
"""Compare two alevin-fry quantification directories.

Standalone re-implementation of the reference's numerical comparison
harness (scripts/testing/compare_counts.py), which defines output
equivalence as: identical row-name sets and zero absolute-sum
difference of the USA layers (U/S/A) or of X, after aligning rows and
columns by name.  No pyroe dependency: the MTX + rows/cols + quant.json
artifact contract is parsed directly, so this tool can diff a quant
directory produced by the Rust reference against one produced by this
engine (or any pair).

Usage: compare_counts.py <ref_quant_dir> <test_quant_dir> <output.json>
"""

import json
import sys
from pathlib import Path

import numpy as np


def load_quant(qdir: Path):
    meta = json.loads((qdir / "quant.json").read_text())
    usa = bool(meta["usa_mode"])
    mat_dir = qdir / "alevin"
    rows = (mat_dir / "quants_mat_rows.txt").read_text().splitlines()
    cols = (mat_dir / "quants_mat_cols.txt").read_text().splitlines()
    with open(mat_dir / "quants_mat.mtx") as fh:
        hdr = fh.readline()
        assert hdr.startswith("%%MatrixMarket"), "not a MatrixMarket file"
        line = fh.readline()
        while line.startswith("%"):
            line = fh.readline()
        nr, nc, nnz = (int(t) for t in line.split())
        data = np.loadtxt(fh, ndmin=2) if nnz else np.zeros((0, 3))
    assert nr == len(rows) and nc == len(cols), "matrix shape != sidecars"
    m = np.zeros((nr, nc), np.float64)
    if data.size:
        m[data[:, 0].astype(int) - 1, data[:, 1].astype(int) - 1] = data[:, 2]
    return usa, rows, cols, m


def main(ref_dir: str, test_dir: str, out_path: str) -> int:
    usa_a, rows_a, cols_a, a = load_quant(Path(ref_dir))
    usa_b, rows_b, cols_b, b = load_quant(Path(test_dir))
    if usa_a != usa_b:
        print(
            f"Cannot compare a usa_mode={usa_a} result to usa_mode={usa_b}",
            file=sys.stderr,
        )
        return 1

    odict = {"nobs_ref": len(rows_a), "nobs_test": len(rows_b)}
    set_a, set_b = set(rows_a), set(rows_b)
    odict["obs_ref-obs_test"] = sorted(set_a - set_b)
    odict["obs_test-obs_ref"] = sorted(set_b - set_a)

    common = [r for r in rows_a if r in set_b]
    ra = {r: i for i, r in enumerate(rows_a)}
    rb = {r: i for i, r in enumerate(rows_b)}
    ai = np.asarray([ra[r] for r in common])
    bi = np.asarray([rb[r] for r in common])

    if usa_a:
        n = len(cols_a) // 3
        # columns: spliced block, -U block, -A block; align by base name
        base_a = cols_a[:n]
        base_b = cols_b[: len(cols_b) // 3]
        cb = {c: i for i, c in enumerate(base_b)}
        cj = np.asarray([cb[c] for c in base_a])
        nb = len(cols_b) // 3
        for name, off_a, off_b in (
            ("diff_S", 0, 0), ("diff_U", n, nb), ("diff_A", 2 * n, 2 * nb)
        ):
            la = a[np.ix_(ai, np.arange(off_a, off_a + n))]
            lb = b[np.ix_(bi, cj + off_b)]
            odict[name] = float(np.abs(la - lb).sum())
    else:
        cbm = {c: i for i, c in enumerate(cols_b)}
        cj = np.asarray([cbm[c] for c in cols_a])
        odict["diff_X"] = float(np.abs(a[ai][:, :] - b[np.ix_(bi, cj)]).sum())

    with open(out_path, "w") as fh:
        json.dump(odict, fh, sort_keys=True, indent=4)
    print(json.dumps(odict, sort_keys=True, indent=4))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3]))
