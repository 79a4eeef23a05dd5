"""Shared pipeline utilities (reference: src/utils.rs).

Covers the transcript-to-gene map parsers (2-column and 3-column
spliced/unspliced, src/utils.rs:470-645), the USA-mode gene id scheme
(spliced ids even / unspliced odd and adjacent, src/utils.rs:378-411),
version compatibility (src/utils.rs:1096-1142), strand handling, and
filter-list reading.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .ops.barcodes import pack_seqs


# --- compile cache ----------------------------------------------------------

def configure_compile_cache() -> Path | None:
    """Point JAX's persistent compilation cache at a fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here (returns None).  Otherwise the cache lives at
    ``<checkout>/.jax_cache``: a fixed path, because the path is part
    of the cache key.  Returns the directory it configured."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    cache = Path(__file__).resolve().parent.parent / ".jax_cache"
    jax.config.update("jax_compilation_cache_dir", str(cache))
    return cache


# --- strands ----------------------------------------------------------------
# bio_types::strand::Strand symbols: Forward "+", Reverse "-", Unknown "."
STRAND_FW = "+"
STRAND_RC = "-"
STRAND_BOTH = "."


def strand_from_ori_arg(ori: str) -> str:
    u = ori.upper()
    if u == "FW":
        return STRAND_FW
    if u == "RC":
        return STRAND_RC
    if u in ("BOTH", "EITHER"):
        return STRAND_BOTH
    raise ValueError(f"{ori} is not a valid option for --expected-ori")


def read_strand_mask(dirs: np.ndarray, aln_offsets: np.ndarray, strand: str) -> np.ndarray:
    """Per-read mask: does the read have >=1 alignment on ``strand``?
    (reference: has_alignment_on_strand via update_barcode_hist,
    src/cellfilter.rs:1283-1418)."""
    n = len(aln_offsets) - 1
    if strand == STRAND_BOTH:
        return np.ones(n, bool)
    per_aln = dirs if strand == STRAND_FW else ~dirs
    # segment any() via maximum.reduceat; guard empty input
    if n == 0:
        return np.zeros(0, bool)
    out = np.maximum.reduceat(per_aln.astype(np.int8), aln_offsets[:-1])
    # reduceat on an empty trailing segment repeats values; num_aln >= 1 for
    # mapped records so segments are non-empty, but guard anyway
    empty = np.diff(aln_offsets) == 0
    out[empty] = 0
    return out.astype(bool)


def aln_strand_mask(dirs: np.ndarray, strand: str) -> np.ndarray:
    """Per-alignment mask for collation-time orientation filtering."""
    if strand == STRAND_BOTH:
        return np.ones(len(dirs), bool)
    return dirs if strand == STRAND_FW else ~dirs


# --- USA id helpers (src/utils.rs:378-411) ----------------------------------

def is_spliced(gid) -> np.ndarray:
    return (np.asarray(gid) & 1) == 0


def spliced_id(gid) -> np.ndarray:
    # clear the low bit (SPLICE_MASK_U32)
    return np.asarray(gid) & ~np.uint32(1)


def same_gene(g1, g2, with_unspliced: bool) -> np.ndarray:
    g1 = np.asarray(g1)
    g2 = np.asarray(g2)
    if with_unspliced:
        return (g1 == g2) | (spliced_id(g1) == spliced_id(g2))
    return g1 == g2


# --- version compat ---------------------------------------------------------

@dataclass(frozen=True)
class VersionInfo:
    major: int
    minor: int
    patch: int

    @classmethod
    def parse(cls, s: str) -> "VersionInfo":
        parts = s.split(".")
        if len(parts) != 3:
            raise ValueError(
                f"The version string should be of the format x.y.z; it was `{s}`"
            )
        return cls(int(parts[0]), int(parts[1]), int(parts[2]))

    def is_compatible_with(self, other: "VersionInfo") -> None:
        if (self.major, self.minor) != (other.major, other.minor):
            raise ValueError(
                f"running alevin-fry-tpu v{self.major}.{self.minor}.{self.patch} "
                f"on v{other.major}.{other.minor}.{other.patch} results; please "
                "regenerate the results with a compatible version"
            )


def check_version_compat(calling_version: str, json_path: Path) -> dict:
    """Read a stage JSON and enforce the version_str compatibility gate
    (src/collate.rs:74-95)."""
    with open(json_path) as fh:
        mdata = json.load(fh)
    vs = mdata.get("version_str")
    if vs is None:
        raise ValueError(
            f"{json_path} does not contain a version_str field; please re-run "
            "the earlier stage"
        )
    VersionInfo.parse(calling_version).is_compatible_with(VersionInfo.parse(vs))
    return mdata


# --- tg-map parsing (src/utils.rs:470-645) ----------------------------------

def parse_tg_map(
    tg_map: Path, ref_names: List[str]
) -> Tuple[np.ndarray, List[str], Dict[str, int], bool]:
    """Parse a 2- or 3-column transcript-to-gene TSV.

    Returns (tid_to_gid[uint32], gene_names, gene_name_to_id, usa_mode).
    3-column maps use the USA id scheme: each gene owns two adjacent ids,
    the even one for spliced, the odd one for unspliced.
    Asserts that every transcript in the RAD header is covered
    (src/utils.rs:531-535, 595-598).
    """
    rname_to_id = {n: i for i, n in enumerate(ref_names)}
    with open(tg_map) as fh:
        first = fh.readline()
        ncols = len(first.rstrip("\n").split("\t"))
        fh.seek(0)
        if ncols == 2:
            return _parse_tg_spliced(fh, rname_to_id, len(ref_names))
        if ncols == 3:
            return _parse_tg_spliced_unspliced(fh, rname_to_id, len(ref_names))
    raise ValueError("Transcript-gene mapping must have either 2 or 3 columns.")


def _parse_tg_spliced(fh, rname_to_id, ref_count):
    """2-column tg-map.  Gene ids are assigned in first-encounter order
    over the file (src/utils.rs:603-645).  A direct line loop: the
    pandas path this replaces cost ~1.1 s on a 20k-line map (module
    import + arrow string conversion) — 2x the whole resolve stage —
    while this parses the same file in tens of milliseconds."""
    tid_to_gid = np.full(ref_count, np.iinfo(np.uint32).max, np.uint32)
    gene_names: List[str] = []
    gene_name_to_id: Dict[str, int] = {}
    found = 0
    for lineno, line in enumerate(fh, 1):
        line = line.rstrip("\n")
        if not line.strip():
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            raise ValueError(
                f"tg-map line {lineno} does not have 2 tab-separated "
                f"columns: {line!r}"
            )
        tname, gname = parts[0], parts[1]
        gid = gene_name_to_id.get(gname)
        if gid is None:
            gid = len(gene_names)
            gene_name_to_id[gname] = gid
            gene_names.append(gname)
        tid = rname_to_id.get(tname)
        if tid is not None:
            found += 1
            tid_to_gid[tid] = gid
    assert found == ref_count, (
        "The tg-map must contain a gene mapping for all transcripts in the header"
    )
    return tid_to_gid, gene_names, gene_name_to_id, False


def _parse_tg_spliced_unspliced(fh, rname_to_id, ref_count):
    tid_to_gid = np.full(ref_count, np.iinfo(np.uint32).max, np.uint32)
    gene_names: List[str] = []
    gene_name_to_id: Dict[str, int] = {}
    found = 0
    next_gid = 0
    for line in fh:
        line = line.rstrip("\n")
        if not line:
            continue
        parts = line.split("\t")
        tname, gname, status = parts[0], parts[1], parts[2]
        gid = gene_name_to_id.get(gname)
        if gid is None:
            gid = next_gid
            next_gid += 2
            gene_name_to_id[gname] = gid
            gene_names.append(gname)
        tid = rname_to_id.get(tname)
        if tid is not None:
            found += 1
            su = status.upper()
            if su == "U":
                tid_to_gid[tid] = gid + 1
            elif su == "S":
                tid_to_gid[tid] = gid
            else:
                raise ValueError(
                    "Third column in 3 column txp-to-gene file must be S or U"
                )
    assert found == ref_count, (
        "The tg-map must contain a gene mapping for all transcripts in the header"
    )
    return tid_to_gid, gene_names, gene_name_to_id, True


# --- misc -------------------------------------------------------------------

def open_maybe_gz(path: Path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_barcode_file(path: Path, bclen: int | None = None) -> Tuple[np.ndarray, int]:
    """Read one barcode per line (optionally gzipped); returns (packed
    uint64 array, barcode length)."""
    with open_maybe_gz(path) as fh:
        lines = [l.strip() for l in fh if l.strip()]
    if not lines:
        return np.zeros(0, np.uint64), bclen or 0
    length = bclen or len(lines[0])
    for l in lines:
        assert len(l) == length, (
            f"found barcodes of different lengths {length} and {len(l)}"
        )
    return pack_seqs(lines, length), length


def is_velo_mode(input_dir: Path) -> bool:
    with open(Path(input_dir) / "generate_permit_list.json") as fh:
        mdata = json.load(fh)
    v = mdata.get("velo_mode")
    return bool(v) if v is not None else False


def write_json(path: Path, obj: dict) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)
