"""sort_reduce against a NumPy reference at every lane count the device
carries (NL = ceil(k/16) for k <= 128), over the input regimes its contract
covers: random keys, heavy duplicates, empty slots, sentinel-valued (all-T)
keys with live counts, and per-key totals that wrap 2^32."""

import jax
import numpy as np
import pytest

from kmer_counter.ops.sortcount import sort_reduce

N = 512
MASK = np.uint64(0xFFFFFFFF)


def _pool(rng, m, NL):
    return rng.integers(0, 2**32, size=(m, NL), dtype=np.uint64).astype(np.uint32)


def make_case(case, NL, rng):
    """(lanes [NL, N] uint32, counts [N] uint32)."""
    if case == "random":
        keys = _pool(rng, N, NL)
        counts = np.ones(N, np.uint32)
    elif case == "heavy_dups":
        keys = _pool(rng, 7, NL)[rng.integers(0, 7, N)]
        counts = rng.integers(1, 4, N).astype(np.uint32)
    elif case == "empty_slots":
        keys = _pool(rng, 64, NL)[rng.integers(0, 64, N)]
        counts = np.where(rng.random(N) < 0.5, 0, 1).astype(np.uint32)
    elif case == "sentinel":
        keys = _pool(rng, 32, NL)[rng.integers(0, 32, N)]
        keys[rng.random(N) < 0.2] = 0xFFFFFFFF  # genuine all-T keys
        counts = rng.integers(0, 3, N).astype(np.uint32)
        counts[np.flatnonzero((keys == 0xFFFFFFFF).all(axis=1))[:3]] = 5
    elif case == "wrap":
        keys = _pool(rng, 5, NL)[rng.integers(0, 5, N)]
        counts = (0xFFFFFF00 + rng.integers(1, 200, N)).astype(np.uint32)
    else:
        raise ValueError(case)
    return np.ascontiguousarray(keys.T), counts


def numpy_sort_reduce(lanes, counts):
    """(sorted unique keys [U, NL], totals mod 2^32 [U])."""
    keys = lanes.T[counts > 0]
    c = counts[counts > 0].astype(np.uint64)
    if len(c) == 0:
        return keys, np.zeros(0, np.uint32)
    order = np.lexsort(keys.T[::-1])
    keys, c = keys[order], c[order]
    head = np.concatenate([[True], (keys[1:] != keys[:-1]).any(axis=1)])
    totals = np.add.reduceat(c, np.flatnonzero(head)) & MASK
    return keys[head], totals.astype(np.uint32)


_sort_reduce = jax.jit(sort_reduce)


@pytest.mark.parametrize("case", ["random", "heavy_dups", "empty_slots", "sentinel", "wrap"])
@pytest.mark.parametrize("NL", range(1, 9))
def test_sort_reduce_matches_numpy(NL, case):
    rng = np.random.default_rng([NL, len(case)])
    lanes, counts = make_case(case, NL, rng)
    want_keys, want_counts = numpy_sort_reduce(lanes, counts)
    assert np.all(want_counts > 0), "precondition: no total wraps to 0"
    u_lanes, u_counts, n = _sort_reduce(lanes, counts)
    n = int(n)
    u_lanes, u_counts = np.asarray(u_lanes), np.asarray(u_counts)
    assert n == len(want_counts)
    np.testing.assert_array_equal(u_lanes[:, :n].T, want_keys)
    np.testing.assert_array_equal(u_counts[:n], want_counts)
    assert np.all(u_counts[n:] == 0)
