"""Property tests for the scatter-free contiguous-segment reduction
toolkit (ops/crlike_device.py) against direct NumPy segment loops.

These primitives carry the WTA/ATAC kernels (BASELINE.md r4 §2); the
end-to-end kernels are differential-tested against the host resolvers,
and these pin the primitives themselves across segment shapes: single-
row segments, one whole-array segment, empty mark sets, and value
extremes at the packing boundary.
"""

import numpy as np
import pytest


def _random_segments(rng, n):
    start = np.zeros(n, bool)
    start[0] = True
    start[rng.rand(n) < 0.2] = True
    seg_id = np.cumsum(start) - 1
    return start, seg_id


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_seg_sum_matches_numpy(seed, n):
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import _seg_sum

    rng = np.random.RandomState(seed)
    start, seg_id = _random_segments(rng, n)
    x = rng.randint(0, 50, n).astype(np.int32)
    want_tot = np.zeros(seg_id[-1] + 1, np.int64)
    np.add.at(want_tot, seg_id, x)
    tot, rank = _seg_sum(jnp.asarray(x), jnp.asarray(start), with_rank=True)
    np.testing.assert_array_equal(np.asarray(tot), want_tot[seg_id])
    # inclusive within-segment running sum
    want_rank = np.concatenate([
        np.cumsum(x[seg_id == s]) for s in range(seg_id[-1] + 1)
    ])
    np.testing.assert_array_equal(np.asarray(rank), want_rank)


@pytest.mark.parametrize("seed", [3, 4])
def test_seg_reduce_max_matches_numpy(seed):
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import _seg_reduce

    rng = np.random.RandomState(seed)
    n = 800
    start, seg_id = _random_segments(rng, n)
    grp_ord = (seg_id + 1).astype(np.int32)
    mark = rng.rand(n) < 0.3
    val = rng.randint(0, 1 << 20, n).astype(np.int64)
    want = np.full(seg_id[-1] + 1, -1, np.int64)
    np.maximum.at(want, seg_id[mark], val[mark])
    with jax.enable_x64(True):
        got = _seg_reduce(
            jnp.asarray(val), jnp.asarray(mark), jnp.asarray(start),
            jnp.asarray(grp_ord), val_bits=21,
        )
    np.testing.assert_array_equal(np.asarray(got), want[seg_id])


@pytest.mark.parametrize("strict", [False, True])
def test_last_marked_matches_numpy(strict):
    """Contract: running MAX over marked rows of the segment (equal to
    the nearest earlier mark when values ascend, as in the kernels)."""
    import jax
    import jax.numpy as jnp

    from alevin_fry_tpu.ops.crlike_device import _last_marked

    rng = np.random.RandomState(7)
    n = 600
    start, seg_id = _random_segments(rng, n)
    grp_ord = (seg_id + 1).astype(np.int32)
    mark = rng.rand(n) < 0.25
    val = rng.randint(0, 1 << 15, n).astype(np.int64)
    want = np.full(n, -1, np.int64)
    for i in range(n):
        hi = i if strict else i + 1
        js = [
            j for j in range(hi)
            if mark[j] and seg_id[j] == seg_id[i]
        ]
        if js:
            want[i] = max(val[j] for j in js)
    with jax.enable_x64(True):
        got = _last_marked(
            jnp.asarray(val), jnp.asarray(mark), jnp.asarray(grp_ord),
            val_bits=16, strict=strict,
        )
    np.testing.assert_array_equal(np.asarray(got), want)
