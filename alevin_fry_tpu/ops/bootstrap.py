"""Bootstrap replicates over per-cell equivalence-class counts.

Mirrors run_bootstrap / run_bootstrap_subset (em.rs:427-568): per cell,
resample the class counts from a multinomial with the observed counts
as weights (total draws = total observed fragments), re-run the EM with
Random init, and report the replicates' mean/variance (the reference
only ever writes the mean and variance matrices, quant.rs:115-208).

Where the reference loops replicates sequentially inside each worker's
per-cell loop, here **(cell, replicate) is one batch axis**: every
replicate of every cell becomes a row of the padded batched EM
(ops/em.py), so a whole block of bootstraps is a handful of batched
EM convergence loops instead of cells x replicates Python iterations.
The multinomial resampling itself is one vectorized
``rng.multinomial(total, p, size=n_bootstraps)`` draw per cell.

Resampling uses a seeded NumPy generator (the reference uses an
unseeded thread RNG; bootstrap draws are stochastic by nature, so we
choose determinism).  The generator is seeded PER CELL from the global
cell index so replicates are invariant to how quant blocks the cell
stream (AFT_QUANT_BLOCK_RECORDS) — mirroring the reference's per-cell
barcode-seeded hasher philosophy (quant.rs:921).  The Random EM init is
seeded per (cell, replicate); on the device path it is generated
on-chip from those seeds (O(B) transfer), so host and device paths are
each deterministic (with different draws — bootstrap values are
sampling noise either way).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from .crlike import CellEqClasses
from .em import _EP_LADDER, _get_em_kernel, _pad_pow2, em_batch_np


def _cell_rng(seed: int, global_cell: int) -> np.random.RandomState:
    # splitmix-style per-cell stream: independent of block layout
    return np.random.RandomState(
        (seed + 0x9E3779B9 * (global_cell + 1)) & 0xFFFFFFFF
    )


def _init_seed(seed: int, global_cell: int, rep: int) -> int:
    return (
        (seed ^ 0x51ED2700)
        + 0x9E3779B9 * (global_cell + 1)
        + 7919 * (rep + 1)
    ) & 0xFFFFFFFF


def _use_device(n_rows_batch: int) -> bool:
    mode = os.environ.get("AFT_BOOT_BACKEND", "auto")
    if mode == "host":
        return False
    if mode == "jax":
        return True
    if n_rows_batch < 64:
        return False
    try:
        import jax

        return jax.default_backend() not in ("cpu",)
    except Exception:
        return False


def run_bootstraps(
    eqc: CellEqClasses,
    label_offsets: np.ndarray,
    labels: np.ndarray,
    num_rows: int,
    num_bootstraps: int,
    init_uniform: bool,
    summary_stat: bool,
    seed: int = 271828,
    cell_offset: int = 0,
) -> Tuple[tuple, tuple]:
    """Returns ((rows, cols, mean_vals), (rows, cols, var_vals)) COO
    triplets over (cell_row=block-local cell index, gene).
    ``cell_offset`` globalizes the per-cell RNG seed under streaming."""
    rows_m, cols_m, vals_m = [], [], []
    rows_v, cols_v, vals_v = [], [], []
    C = len(eqc.cell_ids)
    Rp = int(num_bootstraps)
    R = int(num_rows)
    lens_all = np.diff(label_offsets)

    # --- per-cell resampling + padded row templates -------------------------
    # bucket cells by padded class count exactly like em_cells_batched;
    # giant cells (> max ladder) run the per-cell NumPy loop instead
    buckets: dict = {}
    for k in range(C):
        s, e = int(eqc.cell_eq_offsets[k]), int(eqc.cell_eq_offsets[k + 1])
        if s == e:
            continue
        ne = e - s
        for ep in _EP_LADDER:
            if ne <= ep:
                buckets.setdefault(ep, []).append(k)
                break
        else:
            _bootstrap_cell_outlier(
                eqc, label_offsets, labels, R, Rp, seed, cell_offset, k,
                rows_m, cols_m, vals_m, rows_v, cols_v, vals_v,
            )

    for Ep, cells in sorted(buckets.items()):
        # --- bucket-level CSR geometry, fully vectorized (no per-cell
        # packing loops; VERDICT r2 item 8) -------------------------------
        ks = np.asarray(cells, np.int64)
        starts = eqc.cell_eq_offsets[ks].astype(np.int64)
        ends = eqc.cell_eq_offsets[ks + 1].astype(np.int64)
        ne_arr = ends - starts
        cis_b = eqc.cell_ids[ks].astype(np.int64)
        gcis_b = cis_b + cell_offset
        cls_cum = np.concatenate([[0], np.cumsum(ne_arr)])
        n_cls = int(cls_cum[-1])
        cell_of_cls = np.repeat(np.arange(len(ks)), ne_arr)
        cls_pos = np.arange(n_cls) - np.repeat(cls_cum[:-1], ne_arr)
        j_all = np.repeat(starts, ne_arr) + cls_pos
        lens_cls = lens_all[j_all].astype(np.int64)
        lab_cum = np.concatenate([[0], np.cumsum(lens_cls)])
        n_lab = int(lab_cum[-1])
        w_all = np.arange(n_lab) - np.repeat(lab_cum[:-1], lens_cls)
        lab_src = np.repeat(label_offsets[j_all].astype(np.int64), lens_cls) + w_all
        lab_vals_all = labels[lab_src].astype(np.int32)
        Lp = _pad_pow2(int(lens_cls.max(initial=1)), 2)

        # memory-bounded row batches, whole cells per batch (host batches
        # are smaller: each EM round materializes dense (B, R+1) copies)
        use_dev = _use_device(len(cells) * Rp)
        per_row = (R + 1) * 3 + Ep * Lp * 2
        max_batch_elems = (1 << 27) if use_dev else (1 << 25)
        rows_cap = max(Rp, max_batch_elems // max(per_row, 1))
        cells_per_batch = max(1, rows_cap // Rp)

        for c0 in range(0, len(cells), cells_per_batch):
            c1 = min(c0 + cells_per_batch, len(cells))
            nb = c1 - c0
            nrows = nb * Rp

            # slice the bucket-level class/label geometry for this batch
            cls_lo, cls_hi = int(cls_cum[c0]), int(cls_cum[c1])
            lab_lo, lab_hi = int(lab_cum[cls_lo]), int(lab_cum[cls_hi])
            b_cell = cell_of_cls[cls_lo:cls_hi] - c0
            b_cls_pos = cls_pos[cls_lo:cls_hi]
            b_lens = lens_cls[cls_lo:cls_hi]
            cls_slot = b_cell * Ep + b_cls_pos

            # one scatter builds every cell template at once
            lab_t = np.full(nb * Ep * Lp, R, np.int32)
            lab_t[np.repeat(cls_slot * Lp, b_lens) + w_all[lab_lo:lab_hi]] = (
                lab_vals_all[lab_lo:lab_hi]
            )
            len_t = np.zeros(nb * Ep, np.int32)
            len_t[cls_slot] = b_lens
            lab_pad = np.repeat(lab_t.reshape(nb, Ep, Lp), Rp, axis=0)
            len_pad = np.repeat(len_t.reshape(nb, Ep), Rp, axis=0)
            ct_pad = np.zeros((nrows, Ep), np.float32)

            # seeds: one vectorized expression over (cell, replicate)
            seeds = (
                (
                    np.uint64(seed ^ 0x51ED2700)
                    + np.uint64(0x9E3779B9)
                    * (gcis_b[c0:c1, None].astype(np.uint64) + np.uint64(1))
                    + np.uint64(7919)
                    * (np.arange(Rp, dtype=np.uint64)[None, :] + np.uint64(1))
                )
                & np.uint64(0xFFFFFFFF)
            ).astype(np.uint32).ravel()

            # the only remaining per-cell work: the seeded multinomial
            # draw (per-cell RNG streams are the determinism contract)
            for gi in range(nb):
                s, e = int(starts[c0 + gi]), int(ends[c0 + gi])
                ne = e - s
                cts = eqc.counts[s:e].astype(np.int64)
                total = int(cts.sum())
                assert total > 0, "Cannot bootstrap from a sample with 0 counts."
                rng = _cell_rng(seed, int(gcis_b[c0 + gi]))
                resampled = rng.multinomial(total, cts / total, size=Rp)
                ct_pad[gi * Rp : (gi + 1) * Rp, :ne] = resampled.astype(np.float32)

            if use_dev:
                import jax.numpy as jnp

                from .crlike import accelerator_present
                from .em import (
                    _get_em_kernel_compact, compact_local_ids, dense_em_cap_bytes,
                )

                # compact dictionaries + the dense one-hot E/M steps (the
                # same formulation as the main EM; bootstraps run
                # R_p x the EM rounds, so this is the heaviest EM
                # consumer).  Falls back to the full-space kernel when
                # the dictionary does not shrink the state.  Replicate
                # rows within a cell are identical, so the dictionary
                # is built on the nb templates and repeated.
                t_loc, tp1, tp2, U = compact_local_ids(
                    lab_pad[::Rp], R, None
                )
                lab_loc = np.repeat(t_loc, Rp, axis=0)
                p1_loc = np.repeat(tp1, Rp, axis=0)
                p2_loc = np.repeat(tp2, Rp, axis=0)
                dense_mode = os.environ.get("AFT_EM_DENSE", "auto")
                use_dense = (
                    dense_mode == "1" if dense_mode != "auto"
                    else accelerator_present()
                )
                if U + 1 < R:
                    dense_here = use_dense and (
                        lab_pad.size * (U + 1) * 4 <= dense_em_cap_bytes()
                    )
                    kern_c = _get_em_kernel_compact(
                        False, True, dense=dense_here, init_random=True
                    )
                    out = np.asarray(kern_c(
                        jnp.asarray(lab_loc), jnp.asarray(len_pad),
                        jnp.asarray(ct_pad), jnp.asarray(p1_loc),
                        jnp.asarray(p2_loc), R, U, False,
                        rng_seeds=jnp.asarray(seeds),
                    ))
                else:
                    kern = _get_em_kernel(False, True, init_random=True)
                    out = np.asarray(kern(
                        jnp.asarray(lab_pad), jnp.asarray(len_pad),
                        jnp.asarray(ct_pad), jnp.asarray(seeds),
                        0, 0, R, False,
                    ))
            else:
                init = np.empty((nrows, R + 1), np.float32)
                for i in range(nrows):
                    init[i] = np.random.RandomState(
                        int(seeds[i])
                    ).random_sample(R + 1).astype(np.float32) + 1e-5
                out = em_batch_np(
                    lab_pad, len_pad, ct_pad, init, R, with_last_round=True
                )

            # reduce mean/var over the replicate axis, whole batch at
            # once; per-(cell, gene) dedup via one stable sort (a gene
            # repeated across a cell's classes carries the same gathered
            # alpha at every occurrence, so any occurrence's value works)
            vals3 = out.reshape(nb, Rp, Ep * Lp).astype(np.float64)
            sums = vals3.sum(axis=1)
            sqs = (vals3 ** 2).sum(axis=1)
            flat_lab = lab_pad[::Rp].reshape(nb, Ep * Lp)
            valid = flat_lab != R
            vpos = np.flatnonzero(valid.ravel())
            keys = (
                np.repeat(np.arange(nb, dtype=np.int64), valid.sum(axis=1))
                * (R + 1)
                + flat_lab.ravel()[vpos]
            )
            order = np.argsort(keys, kind="stable")
            ks_sorted = keys[order]
            first = np.concatenate(
                [[True], ks_sorted[1:] != ks_sorted[:-1]]
            ) if len(ks_sorted) else np.zeros(0, bool)
            upos = vpos[order][first]
            ukeys = ks_sorted[first]
            cell_u = (ukeys // (R + 1)).astype(np.int64)
            gene_u = (ukeys % (R + 1)).astype(np.int64)
            col_u = upos % (Ep * Lp)
            su = sums[cell_u, col_u]
            mean = (su / Rp).astype(np.float32)
            var = (sqs[cell_u, col_u] / Rp - (su / Rp) ** 2).astype(np.float32)
            ci_u = cis_b[c0 + cell_u]
            nzm = mean != 0
            rows_m.append(ci_u[nzm])
            cols_m.append(gene_u[nzm])
            vals_m.append(mean[nzm])
            nzv = var != 0
            rows_v.append(ci_u[nzv])
            cols_v.append(gene_u[nzv])
            vals_v.append(var[nzv])

    return _coo_sorted(rows_m, cols_m, vals_m), _coo_sorted(rows_v, cols_v, vals_v)


def _coo_sorted(rows: List[np.ndarray], cols: List[np.ndarray], vals):
    if not rows:
        return (
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float32),
        )
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals).astype(np.float32)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def _bootstrap_cell_outlier(
    eqc, label_offsets, labels, num_rows, Rp, seed, cell_offset, k,
    rows_m, cols_m, vals_m, rows_v, cols_v, vals_v,
):
    """Per-cell loop for cells beyond the padded ladder (rare, giant
    class counts): the replicate EMs still run through the batched host
    kernel with the cell's exact (unpadded-to-ladder) shape."""
    from .em import em_optimize_cell_np

    ci = int(eqc.cell_ids[k])
    gci = ci + cell_offset
    s, e = int(eqc.cell_eq_offsets[k]), int(eqc.cell_eq_offsets[k + 1])
    cts = eqc.counts[s:e].astype(np.int64)
    total = int(cts.sum())
    assert total > 0, "Cannot bootstrap from a sample with 0 counts."
    rng = _cell_rng(seed, gci)
    resampled = rng.multinomial(total, cts / total, size=Rp)
    offs = label_offsets[s : e + 1] - label_offsets[s]
    labs = labels[label_offsets[s] : label_offsets[e]]
    asum = np.zeros(num_rows, np.float64)
    asq = np.zeros(num_rows, np.float64)
    for r in range(Rp):
        init = np.random.RandomState(
            _init_seed(seed, gci, r)
        ).random_sample(num_rows).astype(np.float32) + 1e-5
        alphas = em_optimize_cell_np(
            offs, labs, resampled[r].astype(np.uint32), num_rows, None,
            False, with_last_round=True, init_alphas=init,
        )
        asum += alphas
        asq += alphas.astype(np.float64) ** 2
    mean = (asum / Rp).astype(np.float32)
    var = (asq / Rp - (asum / Rp) ** 2).astype(np.float32)
    nzm = np.flatnonzero(mean != 0)
    rows_m.append(np.full(len(nzm), ci, np.int64))
    cols_m.append(nzm.astype(np.int64))
    vals_m.append(mean[nzm])
    nzv = np.flatnonzero(var != 0)
    rows_v.append(np.full(len(nzv), ci, np.int64))
    cols_v.append(nzv.astype(np.int64))
    vals_v.append(var[nzv])
