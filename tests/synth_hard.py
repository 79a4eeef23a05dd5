"""Distribution-hardened synthetic 10x dataset generator (VERDICT r4
Next #2).

The uniform generator in ``bench.py``/``synth.py`` draws Zipf cell
sizes, uniform multi-gene alignments, and uniform 1-sub barcode
errors — distributions its own docstring concedes are unrealistic
(tests/test_real_data.py:20-24).  This generator is molecule-centric
and models the four structures real 10x v3 data has that the uniform
one lacks:

* **Per-base-error barcode corruption** — sequencing error rates rise
  with cycle number (a Phred-like ramp from ~0.1% at cycle 1 to ~1%
  at the last cycle), so errors cluster in late positions, most
  erroneous reads carry ONE substitution (rescuable) and a real tail
  carries two (must be rejected by the Hamming<=1 rescue,
  cellfilter.rs:198-233).
* **Bimodal heavy-tailed cell sizes** — real cells draw log-normal
  read counts; a large ambient/empty-droplet population draws
  geometric counts 100-1000x smaller.  This is the distribution knee
  finding (knee_finding.rs:99) actually faces; Zipf has no knee.
* **Structured multi-gene ambiguity** — an overlapping gene-model
  graph: genes live in paralog families; each molecule's alignment
  label set is drawn as one of {unique txp, several txps of the SAME
  gene, a recurring cross-gene pair, a 3-gene family clique, a wide
  >10-label set that the reference's rules DISCARD
  (utils.rs:735)}.  Ambiguity therefore has gene-graph structure —
  the same gene pairs recur — instead of uniform random pairs.
* **PCR-shaped UMI collision statistics** — molecules amplify to
  1+NB-distributed read counts and a fraction of reads carry a
  1-substitution UMI error, creating Hamming-1 satellite UMIs whose
  frequency is dominated by their parent — exactly the freq(x) >
  2*freq(y)-1 directed-edge structure PUG consumes
  (pugutils.rs:76-99).  High-count cells also produce genuine
  same-UMI collisions across genes.

Reads are globally shuffled (RAD files are not cell-ordered), ~2% of
reads are flipped to the wrong orientation (exercising the strand
filter), and the permit list is a SUPERSET of the real cells so
unfiltered-pl min_reads filtering and knee finding both see ambient
mass.  Everything is vectorized NumPy; 50M reads generate in minutes
and ~3 GB.

``make_hard_dataset`` writes the same artifact layout bench.py's
uniform generator writes (rad/map.rad, permit.txt, t2g.tsv,
t2g_3col.tsv) plus ``truth.json`` with the generated distribution's
summary statistics, and returns that dict.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _phred_ramp(bc_len: int) -> np.ndarray:
    """Per-cycle substitution probability: ~0.001 at cycle 1 rising
    geometrically to ~0.01 at the last cycle (Illumina-like tail)."""
    return 0.001 * (10.0 ** (np.linspace(0.0, 1.0, bc_len)))


def _sub_errors(rng, codes: np.ndarray, which: np.ndarray,
                pos_prob: np.ndarray, length: int) -> None:
    """Apply one random substitution in-place to ``codes[which]``,
    position drawn from ``pos_prob``, new base != old base."""
    n = which.sum() if which.dtype == bool else len(which)
    if n == 0:
        return
    pos = rng.choice(length, size=n, p=pos_prob)
    shift = (2 * pos).astype(np.uint64)
    old = (codes[which] >> shift) & np.uint64(3)
    delta = rng.randint(1, 4, n).astype(np.uint64)  # non-identity
    new = (old + delta) & np.uint64(3)
    codes[which] ^= (old ^ new) << shift


def make_hard_dataset(
    d: Path,
    rng: np.random.RandomState,
    n_cells: int = 4000,
    n_reads: int = 2_000_000,
    n_genes: int = 5000,
    txps_per_gene: int = 4,
    bc_len: int = 16,
    umi_len: int = 12,
    ambient_factor: int = 8,
    mean_reads_per_mol: float = 2.5,
    umi_error_rate: float = 0.05,
    wrong_ori_rate: float = 0.02,
    spliced_frac: float = 0.75,
    chunk: int = 100_000,
):
    import sys as _sys

    _sys.path.insert(0, str(Path(__file__).parent))
    from synth import make_rna_prelude

    from alevin_fry_tpu.ops.barcodes import unpack_seqs_to_strings
    from alevin_fry_tpu.radz import RadWriter
    from alevin_fry_tpu.radz.chunkio import encode_records

    n_txps = n_genes * txps_per_gene
    fam = 4  # paralog family size (genes [4k, 4k+3] overlap)

    # ---------------- barcode universe ----------------
    # permit list: a superset — real cells + ambient + never-seen
    bc_mask = np.uint64((1 << (2 * bc_len)) - 1)
    n_ambient = ambient_factor * n_cells
    n_permit = 2 * (n_cells + n_ambient)
    permit = np.unique(
        rng.randint(0, 1 << 62, size=int(1.2 * n_permit)).astype(np.uint64)
        & bc_mask
    )
    assert len(permit) >= n_cells + n_ambient
    perm = rng.permutation(len(permit))
    real_bcs = permit[perm[:n_cells]]
    ambient_bcs = permit[perm[n_cells:n_cells + n_ambient]]

    # ---------------- cell size distribution ----------------
    # real cells: log-normal; ambient: geometric-ish tiny counts at
    # ~8% of total mass
    real_w = np.exp(rng.normal(0.0, 0.8, n_cells))
    real_w /= real_w.sum()
    amb_w = rng.exponential(1.0, n_ambient)
    amb_w /= amb_w.sum()
    amb_mass = 0.08
    cell_w = np.concatenate([(1 - amb_mass) * real_w, amb_mass * amb_w])
    all_bcs = np.concatenate([real_bcs, ambient_bcs])

    # ---------------- molecules ----------------
    n_mols = int(n_reads / mean_reads_per_mol)
    mol_cell = rng.choice(len(all_bcs), size=n_mols, p=cell_w)
    # gene expression: Zipf over genes, shared across cells (a global
    # profile is what drives recurring ambiguity hot spots)
    gw = 1.0 / np.arange(1, n_genes + 1) ** 0.9
    gw /= gw.sum()
    mol_gene = rng.choice(n_genes, size=n_mols, p=gw)
    mol_umi = rng.randint(0, 1 << (2 * umi_len), size=n_mols).astype(
        np.uint64
    )
    # spliced/unspliced status: txps of a gene alternate S (even local
    # id) / U (odd); default 75% spliced (whole-cell), ~25% models
    # single-nucleus profiles
    mol_spliced = rng.rand(n_mols) < spliced_frac

    # ambiguity class per molecule
    amb_class = rng.choice(
        5, size=n_mols, p=[0.57, 0.25, 0.12, 0.05, 0.01]
    )  # 0 unique, 1 intra-gene, 2 cross-pair, 3 family, 4 wide-discard

    # reads per molecule: 1 + NB(r=1, mean-1) (geometric-tailed PCR)
    extra = rng.geometric(
        1.0 / mean_reads_per_mol, size=n_mols
    ) - 1
    mol_rpm = 1 + extra
    # trim to the read target
    cum = np.cumsum(mol_rpm)
    n_mols = min(int(np.searchsorted(cum, n_reads) + 1), len(mol_rpm))
    mol_cell = mol_cell[:n_mols]
    mol_gene = mol_gene[:n_mols]
    mol_umi = mol_umi[:n_mols]
    mol_spliced = mol_spliced[:n_mols]
    amb_class = amb_class[:n_mols]
    mol_rpm = mol_rpm[:n_mols]
    total_reads = int(mol_rpm.sum())

    # ---------------- label sets per molecule ----------------
    # Build per-molecule txp label lists (vectorized by class).
    # local txp ids within a gene: spliced = even, unspliced = odd
    def txp_of(gene, spliced, k):
        """k-th transcript of the right splice status (local ids
        0,2,4.. spliced / 1,3,5.. unspliced)."""
        loc = (2 * k + np.where(spliced, 0, 1)) % txps_per_gene
        return gene * txps_per_gene + loc

    halves = txps_per_gene // 2
    k0 = rng.randint(0, halves, n_mols)
    lab_counts = np.ones(n_mols, np.int32)
    base_txp = txp_of(mol_gene, mol_spliced, k0)

    # class 1: intra-gene — 2 txps of the same gene, same status
    c1 = amb_class == 1
    # class 2: cross-gene pair — partner = gene ^ 1 within family
    c2 = amb_class == 2
    partner_gene = (mol_gene ^ 1) % n_genes
    # class 3: family — 3 genes of the molecule's family
    c3 = amb_class == 3
    fam_base = (mol_gene // fam) * fam
    # class 4: wide — 12 txps across 12 genes (rules discard > 10
    # labels, utils.rs:735)
    c4 = amb_class == 4

    lab_counts[c1] = 2
    lab_counts[c2] = 2
    lab_counts[c3] = 3
    lab_counts[c4] = 12

    offs = np.zeros(n_mols + 1, np.int64)
    np.cumsum(lab_counts, out=offs[1:])
    labels = np.empty(offs[-1], np.uint32)
    labels[offs[:-1]] = base_txp.astype(np.uint32)
    # second label
    sec = np.where(
        c1,
        txp_of(mol_gene, mol_spliced, (k0 + 1) % halves),
        txp_of(partner_gene, mol_spliced, k0),
    )
    has2 = lab_counts >= 2
    labels[offs[:-1][has2] + 1] = sec[has2].astype(np.uint32)
    # third label (family class): next family gene
    # (modulo n_genes: the last family is partial when fam does not
    # divide n_genes)
    g3 = (fam_base + (mol_gene - fam_base + 2) % fam) % n_genes
    has3 = lab_counts >= 3
    labels[offs[:-1][has3] + 2] = txp_of(g3, mol_spliced, k0)[
        has3
    ].astype(np.uint32)
    # wide class: fill labels 1.. with a run of neighboring genes
    if c4.any():
        wi = np.flatnonzero(c4)
        for j in range(1, 12):
            gj = (mol_gene[wi] + j) % n_genes
            labels[offs[wi] + j] = txp_of(
                gj, mol_spliced[wi], k0[wi]
            ).astype(np.uint32)

    # ---------------- expand molecules to reads ----------------
    read_mol = np.repeat(np.arange(n_mols), mol_rpm)
    read_cell = mol_cell[read_mol]
    read_umi = mol_umi[read_mol].copy()
    # UMI 1-sub errors on a fraction of reads, but never the FIRST
    # read of a molecule (the parent UMI stays dominant — the
    # freq(x) > 2 freq(y) - 1 structure PUG wants)
    first_of_mol = np.zeros(total_reads, bool)
    first_of_mol[np.cumsum(mol_rpm) - mol_rpm] = True
    umi_err = (rng.rand(total_reads) < umi_error_rate) & ~first_of_mol
    _sub_errors(
        rng, read_umi, umi_err,
        np.full(umi_len, 1.0 / umi_len), umi_len,
    )

    # barcodes with per-base error ramp
    read_bc = all_bcs[read_cell].copy()
    q = _phred_ramp(bc_len)
    lam = q.sum()
    nerr = rng.poisson(lam, total_reads)
    nerr = np.minimum(nerr, 2)
    pos_prob = q / q.sum()
    one_err = nerr >= 1
    _sub_errors(rng, read_bc, one_err, pos_prob, bc_len)
    two_err = nerr >= 2
    _sub_errors(rng, read_bc, two_err, pos_prob, bc_len)

    # orientation: ~2% of reads flip to rc (filtered by expected_ori=fw)
    read_fw = rng.rand(total_reads) >= wrong_ori_rate

    # ---------------- shuffle + write RAD ----------------
    order = rng.permutation(total_reads)
    read_mol = read_mol[order]
    read_bc = read_bc[order]
    read_umi = read_umi[order]
    read_fw = read_fw[order]

    refs = [f"tx_{i}" for i in range(n_txps)]
    prelude, ftv = make_rna_prelude(refs, bc_len, umi_len)
    (d / "rad").mkdir(exist_ok=True)
    with open(d / "rad" / "map.rad", "wb") as fh:
        w = RadWriter(fh, prelude, ftv)
        for s in range(0, total_reads, chunk):
            e = min(s + chunk, total_reads)
            mols = read_mol[s:e]
            nal = lab_counts[mols]
            aoffs = np.zeros(len(mols) + 1, np.int64)
            np.cumsum(nal, out=aoffs[1:])
            rcol = np.empty(aoffs[-1], np.uint32)
            # gather each molecule's label run
            src = np.repeat(offs[mols], nal) + (
                np.arange(aoffs[-1]) - np.repeat(aoffs[:-1], nal)
            )
            rcol[:] = labels[src]
            dirs = np.repeat(read_fw[s:e], nal)
            body = encode_records(
                w.schema,
                {"b": read_bc[s:e], "u": read_umi[s:e]},
                aoffs,
                rcol,
                dirs,
                {},
            )
            w.chunks.write_chunk_bytes(body, e - s)
        w.finalize()

    with open(d / "permit.txt", "w") as fh:
        for s_ in unpack_seqs_to_strings(np.sort(permit), bc_len):
            fh.write(s_ + "\n")
    with open(d / "t2g.tsv", "w") as fh:
        for i in range(n_txps):
            fh.write(f"tx_{i}\tg_{i // txps_per_gene}\n")
    with open(d / "t2g_3col.tsv", "w") as fh:
        for i in range(n_txps):
            status = "S" if (i % txps_per_gene) % 2 == 0 else "U"
            fh.write(f"tx_{i}\tg_{i // txps_per_gene}\t{status}\n")

    stats = {
        "n_reads": total_reads,
        "n_molecules": n_mols,
        "n_real_cells": n_cells,
        "n_ambient_barcodes": n_ambient,
        "permit_list_size": len(permit),
        "ambient_read_mass": amb_mass,
        "mean_reads_per_molecule": round(float(mol_rpm.mean()), 3),
        "reads_with_1_bc_error": int(one_err.sum() - two_err.sum()),
        "reads_with_2_bc_errors": int(two_err.sum()),
        "bc_error_rate_per_cycle": [round(float(x), 5) for x in q],
        "reads_with_umi_error": int(umi_err.sum()),
        "wrong_orientation_reads": int((~read_fw).sum()),
        "ambiguity_class_counts": {
            "unique": int((amb_class == 0).sum()),
            "intra_gene": int((amb_class == 1).sum()),
            "cross_gene_pair": int((amb_class == 2).sum()),
            "family_3gene": int((amb_class == 3).sum()),
            "wide_discard_12label": int((amb_class == 4).sum()),
        },
        "real_cell_reads_lognormal_sigma": 0.8,
        "spliced_frac": spliced_frac,
    }
    (d / "truth.json").write_text(json.dumps(stats, indent=1))
    return stats


def make_hard_atac_dataset(
    d: Path,
    rng: np.random.RandomState,
    n_cells: int = 2000,
    n_frags: int = 1_000_000,
    n_chrs: int = 8,
    chr_len: int = 50_000_000,
    bc_len: int = 16,
    ambient_factor: int = 8,
    dup_rate: float = 0.3,
    chunk: int = 100_000,
):
    """Distribution-hardened scATAC fragment generator (r5; the uniform
    bench drew uniform positions/lengths and no duplicates).  Models:

    * **nucleosome banding** — fragment lengths draw from the canonical
      mixture: nucleosome-free (~60-140 bp), mono- (~160-250) and
      di-nucleosome (~300-500) modes with an exponential tail, plus a
      >2000 bp tail that the MAX_ATAC_FRAG_LEN filter must drop
      (constants.rs:11);
    * **peak-clustered positions** — 60% of fragments land in ~3k
      accessibility peaks per chromosome (500 bp wide), the rest
      background-uniform: the genomic-bin histogram
      (atac/cellfilter.rs:67-102) sees real hot spots;
    * **PCR duplicates** — a fraction of fragments repeat the exact
      (cell, chr, pos, len) tuple so dedup has real work
      (atac/deduplicate.rs counters light up);
    * **non-proper pairs and multi-mapping** — a few % of records get
      map_type != 4 or 2 alignments (both filtered);
    * **log-normal cells over an ambient population** + per-cycle
      Phred-ramp barcode errors, as in the RNA generator.

    Writes rad/map.rad + wl.txt (REVERSE-COMPLEMENT whitelist, the 10x
    ATAC convention the pipeline consumes with -d rc) + truth.json.
    """
    import sys as _sys

    _sys.path.insert(0, str(Path(__file__).parent))
    from synth import make_atac_prelude

    from alevin_fry_tpu.ops.barcodes import (
        revcomp_packed, unpack_seqs_to_strings,
    )
    from alevin_fry_tpu.radz import RadWriter
    from alevin_fry_tpu.radz.chunkio import encode_records

    bc_mask = np.uint64((1 << (2 * bc_len)) - 1)
    n_ambient = ambient_factor * n_cells
    permit = np.unique(
        rng.randint(0, 1 << 62, size=int(2.4 * (n_cells + n_ambient)))
        .astype(np.uint64) & bc_mask
    )
    perm = rng.permutation(len(permit))
    real_bcs = permit[perm[:n_cells]]
    ambient_bcs = permit[perm[n_cells:n_cells + n_ambient]]
    real_w = np.exp(rng.normal(0.0, 0.8, n_cells))
    real_w /= real_w.sum()
    amb_w = rng.exponential(1.0, n_ambient)
    amb_w /= amb_w.sum()
    cell_w = np.concatenate([0.92 * real_w, 0.08 * amb_w])
    all_bcs = np.concatenate([real_bcs, ambient_bcs])

    # unique molecules, then PCR duplication expands them
    n_mols = int(n_frags / (1.0 + dup_rate))
    mol_cell = rng.choice(len(all_bcs), size=n_mols, p=cell_w)
    mol_chr = rng.randint(0, n_chrs, n_mols)
    # peak-clustered positions
    n_peaks = 3000
    peak_pos = rng.randint(0, chr_len - 3000, (n_chrs, n_peaks))
    in_peak = rng.rand(n_mols) < 0.6
    pk = rng.randint(0, n_peaks, n_mols)
    mol_pos = np.where(
        in_peak,
        peak_pos[mol_chr, pk] + rng.randint(0, 500, n_mols),
        rng.randint(0, chr_len - 3000, n_mols),
    )
    # nucleosome-banded fragment lengths
    band = rng.choice(4, size=n_mols, p=[0.45, 0.33, 0.17, 0.05])
    flen = np.where(
        band == 0, rng.randint(60, 141, n_mols),
        np.where(
            band == 1, rng.randint(160, 251, n_mols),
            np.where(
                band == 2, rng.randint(300, 501, n_mols),
                # heavy tail incl. > 2000 (filtered by the 2 kb cap)
                (600 + rng.exponential(700, n_mols)).astype(np.int64),
            ),
        ),
    ).astype(np.int64)

    # expand with PCR duplicates
    dups = 1 + rng.poisson(dup_rate, n_mols)
    frag_mol = np.repeat(np.arange(n_mols), dups)[:n_frags]
    total = len(frag_mol)
    f_cell = mol_cell[frag_mol]
    f_chr = mol_chr[frag_mol].astype(np.int64)
    f_pos = mol_pos[frag_mol].astype(np.int64)
    f_len = flen[frag_mol]

    # barcode errors (per-cycle ramp)
    f_bc = all_bcs[f_cell].copy()
    q = _phred_ramp(bc_len)
    nerr = np.minimum(rng.poisson(q.sum(), total), 2)
    pos_prob = q / q.sum()
    _sub_errors(rng, f_bc, nerr >= 1, pos_prob, bc_len)
    _sub_errors(rng, f_bc, nerr >= 2, pos_prob, bc_len)

    # map_type: 4 = unique proper pair; ~3% non-proper, ~2% multimapped
    mt = np.full(total, 4, np.int64)
    mt[rng.rand(total) < 0.03] = 2
    multi = rng.rand(total) < 0.02

    order = rng.permutation(total)
    f_bc, f_chr, f_pos, f_len, mt, multi = (
        f_bc[order], f_chr[order], f_pos[order], f_len[order],
        mt[order], multi[order],
    )

    refs = [f"chr{i+1}" for i in range(n_chrs)]
    prelude, ftv = make_atac_prelude(refs, [chr_len] * n_chrs, bc_len)
    (d / "rad").mkdir(exist_ok=True)
    with open(d / "rad" / "map.rad", "wb") as fh:
        w = RadWriter(fh, prelude, ftv)
        for s in range(0, total, chunk):
            e = min(s + chunk, total)
            nal = 1 + multi[s:e].astype(np.int64)
            aoffs = np.zeros(e - s + 1, np.int64)
            np.cumsum(nal, out=aoffs[1:])
            n_aln = int(aoffs[-1])
            rcol = np.empty(n_aln, np.uint64)
            mtc = np.empty(n_aln, np.uint64)
            poscol = np.empty(n_aln, np.uint64)
            flencol = np.empty(n_aln, np.uint64)
            first = aoffs[:-1]
            rcol[first] = f_chr[s:e]
            mtc[first] = mt[s:e]
            poscol[first] = f_pos[s:e]
            flencol[first] = np.minimum(f_len[s:e], 65535)
            sec = np.flatnonzero(multi[s:e])
            if len(sec):
                so = aoffs[:-1][sec] + 1
                rcol[so] = (f_chr[s:e][sec] + 1) % n_chrs
                mtc[so] = mt[s:e][sec]
                poscol[so] = f_pos[s:e][sec]
                flencol[so] = np.minimum(f_len[s:e][sec], 65535)
            body = encode_records(
                w.schema,
                {"barcode": f_bc[s:e]},
                aoffs,
                rcol.astype(np.uint32),
                np.zeros(n_aln, bool),
                {"type": mtc, "start_pos": poscol, "frag_len": flencol},
            )
            w.chunks.write_chunk_bytes(body, e - s)
        w.finalize()

    rc = revcomp_packed(np.sort(permit), bc_len)
    (d / "wl.txt").write_text(
        "".join(s_ + "\n" for s_ in unpack_seqs_to_strings(rc, bc_len))
    )
    stats = {
        "n_fragments": total,
        "n_molecules_unique": n_mols,
        "n_real_cells": n_cells,
        "pcr_duplicate_fragments": int(total - len(np.unique(frag_mol))),
        "frag_len_over_2000": int((f_len > 2000).sum()),
        "non_proper_pairs": int((mt != 4).sum()),
        "multimapped": int(multi.sum()),
        "peak_fraction": 0.6,
        "reads_with_bc_error": int((nerr >= 1).sum()),
    }
    (d / "truth_atac.json").write_text(json.dumps(stats, indent=1))
    return stats


def make_hard_flex_dataset(
    d: Path,
    rng: np.random.RandomState,
    n_samples: int = 4,
    n_cells_per_sample: int = 300,
    n_reads: int = 300_000,
    n_genes: int = 400,
    sample_bc_len: int = 8,
    cell_bc_len: int = 16,
    umi_len: int = 12,
    chunk: int = 50_000,
):
    """Distribution-hardened 10x Flex (multi-barcode) generator (r5).

    Stresses the two-level correction machinery the uniform multi-BC
    builder (synth.py::write_multi_bc_rad) never did:

    * **rotation barcodes** — each sample has 3 observed rotations
      mapping to one canonical (the 3-column list format,
      cellfilter.rs:1085); reads draw a random rotation;
    * **sample-BC errors** — per-cycle Phred-ramp substitutions on the
      8 bp sample barcode: 1-sub reads must correct through the 1-edit
      sample permit map (build_sample_permit_map, cellfilter.rs:1202),
      2-sub reads must drop;
    * **shared cell barcodes across samples** (the composite-key
      identity stress, collate.rs:1194-1198) with log-normal per-cell
      sizes over an ambient tail, plus cell-BC errors;
    * **sparse sample positions** — samples occupy non-contiguous
      wells so the manifest ordinal (simpleaf#195) does real work.

    Writes rad/map.rad, samples.tsv (3-column), t2g.tsv, and
    truth_flex.json; returns the stats dict."""
    import sys as _sys

    _sys.path.insert(0, str(Path(__file__).parent))
    from synth import make_multi_bc_prelude

    from alevin_fry_tpu.ops.barcodes import unpack_seq
    from alevin_fry_tpu.radz import RadWriter
    from alevin_fry_tpu.radz.chunkio import encode_records

    smask = np.uint64((1 << (2 * sample_bc_len)) - 1)
    cmask = np.uint64((1 << (2 * cell_bc_len)) - 1)

    # canonical sample barcodes at sparse well positions + rotations
    wells = rng.choice(16, n_samples, replace=False)
    canon = np.unique(
        rng.randint(0, 1 << 62, 4 * n_samples).astype(np.uint64) & smask
    )[:n_samples]
    rotations = {}
    all_rot = []
    for si, cb in enumerate(canon):
        rots = np.unique(np.concatenate([
            [cb],
            rng.randint(0, 1 << 62, 8).astype(np.uint64) & smask,
        ]))[:3]
        rotations[si] = rots
        for r in rots:
            all_rot.append((int(r), int(cb), f"well{wells[si]}"))

    # shared cell-barcode pool (same cells appear in every sample)
    pool = np.unique(
        rng.randint(0, 1 << 62, 3 * n_cells_per_sample).astype(np.uint64)
        & cmask
    )[:n_cells_per_sample]
    cell_w = np.exp(rng.normal(0.0, 0.8, n_cells_per_sample))
    cell_w /= cell_w.sum()
    sample_w = rng.dirichlet(np.full(n_samples, 4.0))

    r_sample = rng.choice(n_samples, n_reads, p=sample_w)
    r_cell = rng.choice(n_cells_per_sample, n_reads, p=cell_w)
    r_cellbc = pool[r_cell].copy()
    # observed sample BC: random rotation of the sample
    rot_pick = rng.randint(0, 3, n_reads)
    r_samplebc = np.array(
        [rotations[s][k] for s, k in zip(r_sample, rot_pick)], np.uint64
    )
    # per-cycle errors on both levels
    qs = _phred_ramp(sample_bc_len)
    ns = np.minimum(rng.poisson(qs.sum(), n_reads), 2)
    _sub_errors(rng, r_samplebc, ns >= 1, qs / qs.sum(), sample_bc_len)
    _sub_errors(rng, r_samplebc, ns >= 2, qs / qs.sum(), sample_bc_len)
    qc = _phred_ramp(cell_bc_len)
    nc = np.minimum(rng.poisson(qc.sum(), n_reads), 1)
    _sub_errors(rng, r_cellbc, nc >= 1, qc / qc.sum(), cell_bc_len)

    r_umi = rng.randint(0, 1 << (2 * umi_len), n_reads).astype(np.uint64)
    multi = rng.rand(n_reads) < 0.15
    refs = [f"gene_{i}" for i in range(n_genes)]

    prelude, ftv = make_multi_bc_prelude(
        refs, sample_bc_len, cell_bc_len, umi_len
    )
    (d / "rad").mkdir(exist_ok=True)
    with open(d / "rad" / "map.rad", "wb") as fh:
        w = RadWriter(fh, prelude, ftv)
        for s in range(0, n_reads, chunk):
            e = min(s + chunk, n_reads)
            nal = 1 + multi[s:e].astype(np.int64)
            aoffs = np.zeros(e - s + 1, np.int64)
            np.cumsum(nal, out=aoffs[1:])
            rcol = np.empty(int(aoffs[-1]), np.uint32)
            g1 = rng.randint(0, n_genes, e - s).astype(np.uint32)
            rcol[aoffs[:-1]] = g1
            sec = np.flatnonzero(multi[s:e])
            if len(sec):
                rcol[aoffs[:-1][sec] + 1] = (
                    (g1[sec] + 1 + rng.randint(0, n_genes - 1, len(sec)))
                    % n_genes
                ).astype(np.uint32)
            body = encode_records(
                w.schema,
                {
                    "b0": r_samplebc[s:e],
                    "b1": r_cellbc[s:e],
                    "u": r_umi[s:e],
                },
                aoffs,
                rcol,
                np.ones(int(aoffs[-1]), bool),
                {},
            )
            w.chunks.write_chunk_bytes(body, e - s)
        w.finalize()

    with open(d / "samples.tsv", "w") as fh:
        for obs, cb, name in all_rot:
            fh.write(
                f"{unpack_seq(obs, sample_bc_len)}\t"
                f"{unpack_seq(cb, sample_bc_len)}\t{name}\n"
            )
    with open(d / "t2g.tsv", "w") as fh:
        for i in range(n_genes):
            fh.write(f"gene_{i}\tgene_{i}\n")

    stats = {
        "n_reads": n_reads,
        "n_samples": n_samples,
        "wells": sorted(int(x) for x in wells),
        "rotations_per_sample": 3,
        "shared_cell_pool": n_cells_per_sample,
        "sample_bc_1sub": int((ns == 1).sum()),
        "sample_bc_2sub": int((ns >= 2).sum()),
        "cell_bc_1sub": int((nc >= 1).sum()),
        "multi_gene_reads": int(multi.sum()),
    }
    (d / "truth_flex.json").write_text(json.dumps(stats, indent=1))
    return stats
