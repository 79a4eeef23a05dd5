#!/usr/bin/env python
"""Honest on-chip utilization measurement of the core device kernels.

Methodology (the "amortized chain" protocol): for each kernel we build
a jitted program that iterates the kernel body K times in ONE
``lax.fori_loop`` on device — one dispatch, K rounds of on-chip work,
with a data dependence between rounds so XLA cannot hoist or elide any
round.  We time the program at two round counts K1 < K2 and report

    per_round = (t(K2) - t(K1)) / (K2 - K1)

which differences out dispatch cost, argument transfer and result
transfer entirely — only on-device steady-state work remains.

Bytes-moved and FLOP models are stated per kernel below; shares are
taken against the device's published peaks (``PEAKS``, keyed by
``device_kind``; a device missing from the table is an error).

The kernels timed are the PRODUCTION bodies, not re-implementations:
  * EM round            ops/em.py::_get_em_kernel(fixed_rounds=K)
                        (same one_update closure as the pipeline)
  * cr-like WTA         ops/crlike_device.py::_kernel (same function)
  * PUG CC label-prop   ops/pug_device.py::connected_components_batched
                        (fixed_rounds=K — same body closure)
  * ATAC sort+RLE       ops/atac_device.py::_sort_rle_fn

Run: python scripts/profile_kernels.py [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Published peaks by jax ``device_kind``: NVIDIA H100 SXM data sheet,
# dense rates without sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_GBs": 3350.0, "bf16_flops": 989e12},
}


def peaks() -> dict:
    """Peak rates of the device jax runs on; raises for a device that
    is not in ``PEAKS``."""
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}")
    return PEAKS[kind]


def _time_once(fn, *args):
    """Time one call.  The timed callable returns a SCALAR that
    data-depends on the full computation, and fetching it waits for
    the device (4-8 bytes, a constant cost that cancels in the
    two-point difference)."""
    t0 = time.perf_counter()
    out = fn(*args)
    out = np.asarray(out)
    return time.perf_counter() - t0, out


def _two_point(build, k1, k2, reps=3):
    """build(K) -> (callable, args).  Returns best-of-reps per-round
    seconds via the two-point difference, plus the raw timings."""
    fn1, args1 = build(k1)
    fn2, args2 = build(k2)
    # warm both programs (compile + first dispatch)
    _time_once(fn1, *args1)
    _time_once(fn2, *args2)
    t1 = min(_time_once(fn1, *args1)[0] for _ in range(reps))
    t2 = min(_time_once(fn2, *args2)[0] for _ in range(reps))
    per_round = (t2 - t1) / (k2 - k1)
    return per_round, t1, t2


def profile_em(usa: bool):
    """One EM round at production shape B=4096 cells x E=64 classes x
    L=8 labels, R=8192 rows (R*3 in USA mode).  Memory-bound model per
    round: out zero-init write + final content = 2*B*(R+1)*4; labels
    read + alpha gather read + scatter RMW = 4*B*E*L*4 (USA adds two
    more gathers: +2*B*E*L*4)."""
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.em import _get_em_kernel

    B, E, L = 4096, 64, 8
    R = 3 * 8192 if usa else 8192
    uoff, aoff = (8192, 16384) if usa else (R, R)
    rng = np.random.RandomState(0)
    labels = jnp.asarray(rng.randint(0, R, (B, E, L)), jnp.int32)
    lens = jnp.asarray(rng.randint(1, L + 1, (B, E)), jnp.int32)
    counts = jnp.asarray(rng.randint(1, 50, (B, E)), jnp.float32)
    seeds = jnp.zeros((B,), jnp.uint32)

    def build(k):
        import jax

        fn = _get_em_kernel(usa, False, fixed_rounds=k)
        summed = jax.jit(
            lambda l, n, c, s: fn(l, n, c, s, uoff, aoff, R, False).sum()
        )
        return (lambda: summed(labels, lens, counts, seeds)), ()

    per_round, t1, t2 = _two_point(build, 10, 110)
    gathers = 6 if usa else 4
    bytes_moved = 2 * B * (R + 1) * 4 + gathers * B * E * L * 4
    return {
        "kernel": f"EM round{' (USA)' if usa else ''} "
                  f"(B={B},E={E},L={L},R={R}), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 4),
        "cells_per_s_per_round": round(B / per_round),
        "model_bytes": bytes_moved,
        "achieved_GBs": round(bytes_moved / per_round / 1e9, 1),
        "hbm_utilization_pct": round(
            100 * bytes_moved / per_round / 1e9 / peaks()["hbm_GBs"], 1
        ),
        "raw": {"K": [10, 110], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_em_dense(usa: bool):
    """Dense EM round (one-hot matmul E/M steps) at the same
    production shape — ops/em.py::_get_em_kernel_compact(dense=True),
    the default on accelerators.  FLOP model per round: 2 batched
    contractions of (B, E*L, U+1)."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.em import _get_em_kernel_compact, compact_local_ids

    B, E, L = 4096, 64, 8
    R = 3 * 8192 if usa else 8192
    uoff, aoff = (8192, 16384) if usa else (R, R)
    rng = np.random.RandomState(0)
    lab = rng.randint(0, R, (B, E, L)).astype(np.int64)
    lens = jnp.asarray(rng.randint(1, L + 1, (B, E)), jnp.int32)
    counts = jnp.asarray(rng.randint(1, 50, (B, E)), jnp.float32)
    lab_loc, p1, p2, U = compact_local_ids(
        lab, R, (uoff, aoff) if usa else None
    )
    labels = jnp.asarray(lab_loc)
    p1 = jnp.asarray(p1)
    p2 = jnp.asarray(p2)

    def build(k):
        fn = _get_em_kernel_compact(usa, False, fixed_rounds=k, dense=True)
        summed = jax.jit(
            lambda l, n, c, a, b2: fn(l, n, c, a, b2, R, U, False).sum()
        )
        return (lambda: summed(labels, lens, counts, p1, p2)), ()

    per_round, t1, t2 = _two_point(build, 10, 110)
    flops = 2 * 2 * B * E * L * (U + 1)
    import os as _os

    dmode = _os.environ.get("AFT_EM_DENSE_MODE", "factored")
    return {
        "kernel": f"EM round dense/{dmode}{' (USA)' if usa else ''} "
                  f"(B={B},E={E},L={L},U={U}), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 4),
        "cells_per_s_per_round": round(B / per_round),
        "model_flops_per_round": flops,
        "achieved_TFLOPs": round(flops / per_round / 1e12, 2),
        "raw": {"K": [10, 110], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_em_compact(usa: bool):
    """Compact-gene-space EM round at the same production shape as
    profile_em, but on the (B, U+1) local-dictionary state the pipeline
    now uses by default (ops/em.py::_get_em_kernel_compact).  Byte
    model per round: out zero+write 2*B*(U+1)*4; label gather +
    scatter RMW (+2 partner gathers in USA) over B*E*L*4 each."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.em import _get_em_kernel_compact, compact_local_ids

    B, E, L = 4096, 64, 8
    R = 3 * 8192 if usa else 8192
    uoff, aoff = (8192, 16384) if usa else (R, R)
    rng = np.random.RandomState(0)
    lab = rng.randint(0, R, (B, E, L)).astype(np.int64)
    lens = jnp.asarray(rng.randint(1, L + 1, (B, E)), jnp.int32)
    counts = jnp.asarray(rng.randint(1, 50, (B, E)), jnp.float32)
    lab_loc, p1, p2, U = compact_local_ids(
        lab, R, (uoff, aoff) if usa else None
    )
    labels = jnp.asarray(lab_loc)
    p1 = jnp.asarray(p1)
    p2 = jnp.asarray(p2)

    def build(k):
        fn = _get_em_kernel_compact(usa, False, fixed_rounds=k)
        summed = jax.jit(
            lambda l, n, c, a, b2: fn(l, n, c, a, b2, R, U, False).sum()
        )
        return (lambda: summed(labels, lens, counts, p1, p2)), ()

    per_round, t1, t2 = _two_point(build, 10, 110)
    gathers = 6 if usa else 4
    bytes_moved = 2 * B * (U + 1) * 4 + gathers * B * E * L * 4
    return {
        "kernel": f"EM round compact{' (USA)' if usa else ''} "
                  f"(B={B},E={E},L={L},U={U}), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 4),
        "cells_per_s_per_round": round(B / per_round),
        "model_bytes": bytes_moved,
        "achieved_GBs": round(bytes_moved / per_round / 1e9, 1),
        "hbm_utilization_pct": round(
            100 * bytes_moved / per_round / 1e9 / peaks()["hbm_GBs"], 1
        ),
        "raw": {"K": [10, 110], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_wta():
    """Device cr-like WTA over 4M packed keys.  Each round runs the
    full production kernel (two u64 sorts + segmented scatters) on the
    previous round's keys (low bit perturbed by the output — a real
    data dependence).  Dominated by the two 4M-element u64 sorts; we
    report keys/s and the per-round time (no byte model: XLA's sort is
    multi-pass and its pass count is not public — we do not invent a
    roofline for it)."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import _kernel

    rng = np.random.RandomState(1)
    n = 1 << 22
    ubits, gbits, n_rows = 20, 14, 10000
    c = np.sort(rng.randint(0, 4096, n)).astype(np.uint64)
    u = rng.randint(0, 1 << ubits, n).astype(np.uint64)
    g = rng.randint(0, n_rows, n).astype(np.uint64)
    key_np = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g

    def build(k):
        @jax.jit
        def chain(key):
            def body(_i, key):
                ok, oc = _kernel(key, ubits, gbits, n_rows)
                # feed output back across the LOW gene bits AND read
                # them in the final sum: an earlier chain flipped only
                # bit 0 and summed only the high words, and XLA proved
                # the high words loop-invariant and dead-code-
                # eliminated every round (t(K=4002) == t(K=0)); this
                # variant makes every round's sort reachable from the
                # output
                return key ^ (ok & jnp.uint64(0x3FF)) ^ (
                    oc.astype(jnp.uint64) & jnp.uint64(0x3)
                )

            out = jax.lax.fori_loop(0, k, body, key)
            return (
                (out & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).sum()
                + (out >> jnp.uint64(32)).astype(jnp.uint32).sum()
            )

        def call():
            # enable_x64 must wrap the CALL: tracing happens lazily at
            # first invocation, and u64 demotes to u32 outside the scope
            with jax.enable_x64(True):
                return chain(jnp.asarray(key_np))

        return call, ()

    # wide K spread: the two-point difference must dwarf the run-to-run
    # noise of the fixed per-call cost, or the per-round number is noise
    per_round, t1, t2 = _two_point(build, 2, 162, reps=5)
    return {
        "kernel": f"cr-like WTA ({n>>20}M keys), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 3),
        "keys_per_s": round(n / per_round),
        "raw": {"K": [2, 162], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_wta_variant(usa: bool, variant: str):
    """Production WTA composition per output variant: ``compact`` =
    kernel + the third compaction sort (`_compact`), ``fused`` = the
    two-sort fused tail (`fuse_shift`, the default), ``plain`` = kernel
    alone (no compaction; full padded fetch, AFT_WTA_COMPACT=0).  Same chained protocol; identical inputs."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import (
        _compact, _kernel, _kernel_usa,
    )

    rng = np.random.RandomState(1)
    n = 1 << 22
    if usa:
        ubits, gbits, n_genes = 20, 14, 4000
        n_rows = 3 * (n_genes + 1)
        g = rng.randint(0, 2 * n_genes, n).astype(np.uint64)
    else:
        ubits, gbits, n_rows = 20, 14, 10000
        g = rng.randint(0, n_rows, n).astype(np.uint64)
    c = np.sort(rng.randint(0, 4096, n)).astype(np.uint64)
    u = rng.randint(0, 1 << ubits, n).astype(np.uint64)
    key_np = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g

    def body_of(key):
        if variant == "fused":
            args = (key, ubits, gbits, n_rows)
            out = (
                _kernel_usa(*args, False, fuse_shift=32) if usa
                else _kernel(*args, fuse_shift=32)
            )
            # shift=32 emits two u32 planes; fold both into the chain
            return (
                out[1].astype(jnp.uint64)
                ^ (out[2].astype(jnp.uint64) << jnp.uint64(32))
            )
        ok, oc = (
            _kernel_usa(key, ubits, gbits, n_rows, False) if usa
            else _kernel(key, ubits, gbits, n_rows)
        )
        if variant == "compact":
            _nnz, packed = _compact(ok, oc, True)
            return packed
        return ok ^ (oc.astype(jnp.uint64) & jnp.uint64(0x3))

    def build(k):
        @jax.jit
        def chain(key):
            def body(_i, key):
                out = body_of(key)
                return key ^ (out & jnp.uint64(0x3FF))

            out = jax.lax.fori_loop(0, k, body, key)
            return (
                (out & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).sum()
                + (out >> jnp.uint64(32)).astype(jnp.uint32).sum()
            )

        def call():
            with jax.enable_x64(True):
                return chain(jnp.asarray(key_np))

        return call, ()

    kspread = (2, 82) if usa else (2, 122)
    per_round, t1, t2 = _two_point(build, *kspread, reps=5)
    return {
        "kernel": (
            f"cr-like WTA{' USA' if usa else ''} {variant} "
            f"({n>>20}M keys), fori_loop chained"
        ),
        "per_round_ms": round(per_round * 1e3, 3),
        "keys_per_s": round(n / per_round),
        "raw": {"K": list(kspread), "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_wta_usa():
    """USA-mode WTA over 4M keys: the tie-set slotting variant adds
    ~8 more segmented scatter passes over the sorted keys
    (ops/crlike_device.py::_kernel_usa); same chained protocol."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import _kernel_usa

    rng = np.random.RandomState(1)
    n = 1 << 22
    ubits, gbits, n_genes = 20, 14, 4000
    n_rows = 3 * (n_genes + 1)
    c = np.sort(rng.randint(0, 4096, n)).astype(np.uint64)
    u = rng.randint(0, 1 << ubits, n).astype(np.uint64)
    g = rng.randint(0, 2 * n_genes, n).astype(np.uint64)
    key_np = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g

    def build(k):
        @jax.jit
        def chain(key):
            def body(_i, key):
                ok, oc = _kernel_usa(key, ubits, gbits, n_rows, False)
                return key ^ (ok & jnp.uint64(0x3FF)) ^ (
                    oc.astype(jnp.uint64) & jnp.uint64(0x3)
                )

            out = jax.lax.fori_loop(0, k, body, key)
            return (
                (out & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).sum()
                + (out >> jnp.uint64(32)).astype(jnp.uint32).sum()
            )

        def call():
            with jax.enable_x64(True):
                return chain(jnp.asarray(key_np))

        return call, ()

    per_round, t1, t2 = _two_point(build, 2, 82, reps=5)
    return {
        "kernel": f"cr-like WTA USA ({n>>20}M keys), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 3),
        "keys_per_s": round(n / per_round),
        "raw": {"K": [2, 82], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_pug_cc():
    """PUG connected components, batched label propagation.  Per-round
    byte model: neighbor-index read B*N*D*4 + label gather B*N*D*4
    (random) + pointer-jump gather 2*B*N*4 + label write B*N*4."""
    from alevin_fry_tpu.ops.pug_device import connected_components_batched

    B, N, D = 1024, 256, 16
    nbrs = np.full((B, N, D), N, np.int32)
    v = np.arange(N)
    nbrs[:, :, 0] = (v + 1) % N
    nbrs[:, :, 1] = (v - 1) % N
    # chords make the graph irregular (still symmetric)
    rng = np.random.RandomState(3)
    a = rng.randint(0, N, (B, N // 8))
    b = rng.randint(0, N, (B, N // 8))
    for bi in range(B):
        for x, y in zip(a[bi], b[bi]):
            nbrs[bi, x, 2] = y
            nbrs[bi, y, 3] = x
    valid = np.ones((B, N), bool)

    def build(k):
        return (
            lambda: connected_components_batched(
                nbrs, valid, fixed_rounds=k, dense=False
            )
        ), ()

    per_round, t1, t2 = _two_point(build, 4, 36)
    bytes_moved = 2 * B * N * D * 4 + 3 * B * N * 4
    return {
        "kernel": f"PUG CC label-prop (B={B},N={N},D={D}), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 4),
        "model_bytes": bytes_moved,
        "achieved_GBs": round(bytes_moved / per_round / 1e9, 1),
        "hbm_utilization_pct": round(
            100 * bytes_moved / per_round / 1e9 / peaks()["hbm_GBs"], 1
        ),
        "raw": {"K": [4, 36], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_cc_dense():
    """Dense CC: reachability by matrix squaring, B x N^3 MACs per
    round on the tensor cores (the production formulation for
    N <= 2048; ops/pug_device.py::_dense_cc_run)."""
    from alevin_fry_tpu.ops.pug_device import connected_components_batched

    B, N, D = 1024, 256, 16
    nbrs = np.full((B, N, D), N, np.int32)
    v = np.arange(N)
    nbrs[:, :, 0] = (v + 1) % N
    nbrs[:, :, 1] = (v - 1) % N
    valid = np.ones((B, N), bool)

    def build(k):
        return (
            lambda: connected_components_batched(
                nbrs, valid, fixed_rounds=k, dense=True
            )
        ), ()

    # sub-ms rounds need a K spread in the thousands for the two-point
    # difference to dwarf the fixed per-call noise
    per_round, t1, t2 = _two_point(build, 2, 1002, reps=5)
    flops = 2 * B * N ** 3
    return {
        "kernel": f"PUG CC dense squaring (B={B},N={N}), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 3),
        "model_flops_per_round": flops,
        "achieved_TFLOPs": round(flops / per_round / 1e12, 1),
        "bf16_peak_share_pct": round(
            100 * flops / per_round / peaks()["bf16_flops"], 1
        ),
        "raw": {"K": [2, 1002], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_atac_sort():
    """ATAC segmented sort+RLE kernel (ops/atac_device.py::_sort_rle_fn)
    over 4M two-word rows — the production shape for (chr, start,
    frag_len, barcode) fragments with 16bp barcodes.  Chained by
    xoring low bits of both words with the previous round's counts."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.atac_device import _sort_rle_fn, PAD

    rng = np.random.RandomState(4)
    n = 1 << 22
    w0 = rng.randint(0, 1 << 40, n).astype(np.uint64)
    w1 = rng.randint(0, 1 << 33, n).astype(np.uint64)

    def build(k):
        fn = _sort_rle_fn(2)

        @jax.jit
        def chain(a, b):
            def body(_i, ab):
                a, b = ab
                nnz, sa, sb, cnt = fn(a, b)
                return (
                    a ^ (sa & jnp.uint64(0x3FF)),
                    b ^ (cnt.astype(jnp.uint64) & jnp.uint64(0x3F)),
                )

            a, b = jax.lax.fori_loop(0, k, body, (a, b))
            return (
                (a & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).sum()
                + (b & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).sum()
            )

        def call():
            with jax.enable_x64(True):
                return chain(jnp.asarray(w0), jnp.asarray(w1))

        return call, ()

    per_round, t1, t2 = _two_point(build, 2, 62, reps=5)
    return {
        "kernel": f"ATAC sort+RLE ({n>>20}M rows x 2 words), fori_loop chained",
        "per_round_ms": round(per_round * 1e3, 3),
        "rows_per_s": round(n / per_round),
        "raw": {"K": [2, 62], "t_s": [round(t1, 4), round(t2, 4)]},
    }


def profile_transfer():
    """Host<->device transfer bandwidth: device_put and fetch of a
    32 MiB buffer, best of 3."""
    import jax
    import jax.numpy as jnp

    nbytes = 32 << 20
    host = np.random.RandomState(0).randint(0, 255, nbytes, np.uint8)
    # warm
    d = jax.device_put(host)
    d.block_until_ready()
    np.asarray(d)
    up = []
    down = []
    for _ in range(3):
        t0 = time.perf_counter()
        d = jax.device_put(host)
        d.block_until_ready()
        up.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _ = np.asarray(d)
        down.append(time.perf_counter() - t0)
    return {
        "kernel": f"host<->device transfer ({nbytes >> 20} MiB)",
        "h2d_MBps": round(nbytes / min(up) / 1e6, 1),
        "d2h_MBps": round(nbytes / min(down) / 1e6, 1),
        "raw": {"up_s": [round(t, 3) for t in up],
                "down_s": [round(t, 3) for t in down]},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument(
        "--only", default=None,
        help=(
            "comma list from: em, em_usa, em_compact, em_compact_usa, "
            "em_dense, em_dense_usa, wta, wta_usa, cc, cc_dense, "
            "atac_sort, transfer"
        ),
    )
    args = ap.parse_args()
    import jax

    print(
        f"backend: {jax.default_backend()} devices: {jax.devices()}",
        file=sys.stderr,
    )
    table = {
        "em": lambda: profile_em(False),
        "em_usa": lambda: profile_em(True),
        "em_compact": lambda: profile_em_compact(False),
        "em_compact_usa": lambda: profile_em_compact(True),
        "em_dense": lambda: profile_em_dense(False),
        "em_dense_usa": lambda: profile_em_dense(True),
        "wta": profile_wta,
        "wta_usa": profile_wta_usa,
        "wta_compact": lambda: profile_wta_variant(False, "compact"),
        "wta_fused": lambda: profile_wta_variant(False, "fused"),
        "wta_plain": lambda: profile_wta_variant(False, "plain"),
        "wta_usa_compact": lambda: profile_wta_variant(True, "compact"),
        "wta_usa_fused": lambda: profile_wta_variant(True, "fused"),
        "wta_usa_plain": lambda: profile_wta_variant(True, "plain"),
        "cc": profile_pug_cc,
        "cc_dense": profile_cc_dense,
        "atac_sort": profile_atac_sort,
        "transfer": profile_transfer,
    }
    names = args.only.split(",") if args.only else list(table)
    results = []
    for name in names:
        try:
            r = table[name]()
            results.append(r)
            print(json.dumps(r), flush=True)
        except Exception as e:  # noqa: BLE001
            r = {"kernel": name, "error": repr(e)}
            results.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
