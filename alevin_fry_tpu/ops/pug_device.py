"""Device (JAX) connected components for the PUG graph, batched over
cells.

The reference finds weakly connected components of the per-cell UMI
graph with a union-find (pugutils.rs:278-301) — inherently sequential.
The device equivalent (SURVEY.md §7.1) is iterative **min-label
propagation with pointer jumping**: every node starts labeled with its
own index; each round takes the min over its neighbors' labels and then
hops to its current label's label (path halving), converging to the
minimum node index of its component in O(log N) rounds.  All cells run
in one jitted ``lax.while_loop`` over a padded (B, N, D) neighbor
tensor, so thousands of per-cell PUGs resolve in a single XLA program;
sharding the batch axis over a mesh needs no cross-cell collectives.

The production parsimony path uses the threaded native resolver (49x
the per-cell Python path on host; docs/architecture.md) — this kernel
is the device-resident building block for scaling PUG resolution onto
accelerators, validated against the host union-find in tests and exercised by
the multi-chip dryrun.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pack_adjacency(
    adjs: Sequence[Sequence[Sequence[int]]],
    n_nodes: Sequence[int] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-cell adjacency lists into the padded (B, N, D) neighbor
    tensor ``connected_components_batched`` consumes.

    ``adjs[b][v]`` lists the neighbors of node ``v`` in cell ``b``
    (directions as stored by the PUG builder are fine — the packer
    symmetrizes).  Invalid neighbor slots and nodes beyond a cell's
    count are padded with ``N`` (the per-batch node capacity).
    Returns (nbrs int32 (B, N, D), node_valid bool (B, N)).
    """
    B = len(adjs)
    counts = (
        [len(a) for a in adjs] if n_nodes is None else [int(n) for n in n_nodes]
    )
    N = max(counts, default=0)
    sym: List[List[set]] = []
    D = 1
    for a in adjs:
        s = [set() for _ in range(len(a))]
        for v, nb in enumerate(a):
            for w in nb:
                s[v].add(int(w))
                s[int(w)].add(v)
        sym.append(s)
        for v in range(len(a)):
            D = max(D, len(s[v]))
    nbrs = np.full((B, max(N, 1), D), max(N, 1), np.int32)
    node_valid = np.zeros((B, max(N, 1)), bool)
    for b, s in enumerate(sym):
        node_valid[b, : counts[b]] = True
        for v in range(counts[b]):
            row = sorted(s[v]) if v < len(s) else []
            nbrs[b, v, : len(row)] = row
    return nbrs, node_valid


from functools import lru_cache


@lru_cache(maxsize=32)
def _dense_cc_run(B: int, N: int, fixed_rounds: int = 0):
    """Build the dense formulation: reachability by repeated matrix
    squaring in a boolean semiring (R <- (R @ R > 0)), then per-node
    component label = min reachable node index.

    The label-propagation formulation is bound by random (B, N*D)
    gathers, while squaring runs B x N^3 MACs per round as matrix
    products with ceil(log2(N)) rounds total.  0/1 matrices in bf16
    with f32 accumulation are exact (sums <= N <= 2^15)."""
    import jax
    import jax.numpy as jnp

    rounds = fixed_rounds if fixed_rounds > 0 else max(1, (N - 1).bit_length())

    @jax.jit
    def run(nbrs, node_valid):
        b_idx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
        v_idx = jnp.arange(N, dtype=jnp.int32)[None, :, None]
        # one-hot adjacency; pad slots (= N) land in the dropped column
        A = (
            jnp.zeros((B, N, N + 1), jnp.bfloat16)
            .at[b_idx, v_idx, nbrs]
            .set(jnp.bfloat16(1))[:, :, :N]
        )
        eye = jnp.eye(N, dtype=jnp.bfloat16)[None]
        R0 = jnp.maximum(A, eye * node_valid[:, :, None].astype(jnp.bfloat16))

        def body(_i, R):
            prod = jnp.einsum(
                "bij,bjk->bik", R, R, preferred_element_type=jnp.float32
            )
            return (prod > 0).astype(jnp.bfloat16)

        R = jax.lax.fori_loop(0, rounds, body, R0)
        iota = jnp.arange(N, dtype=jnp.int32)[None, None, :]
        labels = jnp.min(
            jnp.where(R > 0, iota, jnp.int32(N)), axis=2
        )
        return jnp.where(node_valid, labels, jnp.int32(N))

    return run


def cc_dense_enabled() -> bool:
    import os

    return os.environ.get("AFT_PUG_CC_DENSE", "auto") != "0"


def connected_components_batched(
    nbrs: np.ndarray,
    node_valid: np.ndarray,
    mesh=None,
    fixed_rounds: int = 0,
    dense: bool | None = None,
):
    """Min-label-propagation connected components, batched over cells.

    ``nbrs`` is (B, N, D) int32 with neighbor indices in ``[0, N)`` and
    ``N`` marking empty slots (adjacency must be symmetric — use
    ``pack_adjacency``); ``node_valid`` is (B, N) bool.  Returns a
    (B, N) int32 array where each valid node holds the minimum node
    index of its weakly connected component (the canonical component
    id) and invalid nodes hold ``N``.

    With ``mesh`` given, the batch axis is sharded over the mesh — the
    loop is purely node-local per cell, so no collectives are inserted.
    """
    import jax
    import jax.numpy as jnp

    B, N, D = nbrs.shape
    INF = np.int32(N)

    # dense path (default): N^2 adjacency + log2(N) squarings as
    # matrix products, sub-batched so the f32 matmul intermediate
    # stays under ~512 MB; the gather formulation remains for huge N
    # and as the AFT_PUG_CC_DENSE=0 escape hatch
    if dense is None:
        dense = cc_dense_enabled() and N <= 2048
    if dense and mesh is None:
        b_sub = max(1, (256 << 20) // max(N * N * 4, 1))
        out = np.empty((B, N), np.int32)
        nbrs32 = np.asarray(nbrs, np.int32)
        for s in range(0, B, b_sub):
            e = min(s + b_sub, B)
            run_d = _dense_cc_run(e - s, N, fixed_rounds)
            out[s:e] = np.asarray(
                run_d(jnp.asarray(nbrs32[s:e]), jnp.asarray(node_valid[s:e]))
            )
        return out

    @jax.jit
    def run(nbrs, node_valid):
        init = jnp.where(
            node_valid,
            jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N)),
            INF,
        )
        flat_nbrs = nbrs.reshape(B, N * D)

        def gather(ext, idx):
            return jnp.take_along_axis(ext, idx, axis=1)

        def body(state):
            labels, _ = state
            ext = jnp.concatenate(
                [labels, jnp.full((B, 1), INF, jnp.int32)], axis=1
            )
            neigh = gather(ext, flat_nbrs).reshape(B, N, D)
            new = jnp.minimum(labels, jnp.min(neigh, axis=2))
            # pointer jumping (path halving): hop to the label's label
            ext2 = jnp.concatenate(
                [new, jnp.full((B, 1), INF, jnp.int32)], axis=1
            )
            new = jnp.minimum(new, gather(ext2, new))
            return new, jnp.any(new != labels)

        if fixed_rounds > 0:
            # profiling variant: exactly ``fixed_rounds`` propagation
            # rounds in one dispatch (see scripts/profile_kernels.py)
            labels, _ = jax.lax.fori_loop(
                0, fixed_rounds, lambda _i, s: body(s),
                (init, jnp.bool_(True)),
            )
        else:
            labels, _ = jax.lax.while_loop(
                lambda s: s[1], body, (init, jnp.bool_(True))
            )
        return labels

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        nbrs = jax.device_put(jnp.asarray(nbrs, jnp.int32), shard)
        node_valid = jax.device_put(jnp.asarray(node_valid), shard)
    else:
        nbrs = jnp.asarray(nbrs, jnp.int32)
        node_valid = jnp.asarray(node_valid)
    return np.asarray(run(nbrs, node_valid))
