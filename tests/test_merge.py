"""Bitonic merge (ops/merge.py): parity vs numpy mergesort on random
sorted streams, narrow and wide keys, payload carriage, sentinel tails."""

import numpy as np
import pytest

import jax.numpy as jnp

from kat_tpu.core.kmers import SENTINEL
from kat_tpu.ops.merge import merge_sorted

S = int(SENTINEL)


def _sorted_stream(rng, n, n_words, with_counts=True, kmax=1 << 20):
    keys = rng.integers(0, kmax, (n, n_words), dtype=np.uint64).astype(
        np.uint32)
    order = np.lexsort(tuple(keys[:, j] for j in reversed(range(n_words))))
    keys = keys[order]
    w = rng.integers(1, 100, n).astype(np.uint32)
    return [keys[:, j].copy() for j in range(n_words)], w


def _merge_oracle(a_cols, aw, b_cols, bw):
    n_words = len(a_cols)
    allc = [np.concatenate([a, b]) for a, b in zip(a_cols, b_cols)]
    w = np.concatenate([aw, bw])
    order = np.lexsort(tuple(reversed(allc)))  # lexsort is always stable
    return [c[order] for c in allc], w[order]


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (100, 300), (257, 255),
                                   (1024, 1024), (1, 4096)])
@pytest.mark.parametrize("n_words", [2, 4])
def test_merge_parity(na, nb, n_words):
    rng = np.random.default_rng(na * 7 + nb + n_words)
    a_cols, aw = _sorted_stream(rng, na, n_words)
    b_cols, bw = _sorted_stream(rng, nb, n_words)
    words, (w,) = merge_sorted(
        tuple(jnp.asarray(c) for c in a_cols), (jnp.asarray(aw),),
        tuple(jnp.asarray(c) for c in b_cols), (jnp.asarray(bw),))
    want_cols, want_w = _merge_oracle(a_cols, aw, b_cols, bw)
    n = na + nb
    got = [np.asarray(c)[:n] for c in words]
    for j in range(n_words):
        np.testing.assert_array_equal(got[j], want_cols[j])
    # weights must stay attached to their keys: compare multisets per key
    got_pairs = sorted(zip(*[c.tolist() for c in got],
                           np.asarray(w)[:n].tolist()))
    want_pairs = sorted(zip(*[c.tolist() for c in want_cols],
                            want_w.tolist()))
    assert got_pairs == want_pairs
    # padding tail is sentinel/zero
    tail = np.asarray(words[0])[n:]
    assert (tail == S).all()
    assert (np.asarray(w)[n:] == 0).all()


def test_merge_duplicate_keys_across_streams():
    a = np.array([1, 1, 5, 9], np.uint32)
    b = np.array([1, 5, 5, 7, 11], np.uint32)
    az = np.zeros_like(a)
    bz = np.zeros_like(b)
    aw = np.array([10, 20, 30, 40], np.uint32)
    bw = np.array([1, 2, 3, 4, 5], np.uint32)
    words, (w,) = merge_sorted(
        (jnp.asarray(az), jnp.asarray(a)), (jnp.asarray(aw),),
        (jnp.asarray(bz), jnp.asarray(b)), (jnp.asarray(bw),))
    lo = np.asarray(words[1])[:9]
    np.testing.assert_array_equal(lo, [1, 1, 1, 5, 5, 5, 7, 9, 11])
    # total weight preserved
    assert int(np.asarray(w).sum()) == int(aw.sum()) + int(bw.sum())


def test_merge_sentinel_tails_in_inputs():
    """Inputs that already carry sentinel padding merge cleanly."""
    a = np.array([3, 8, S, S], np.uint32)
    b = np.array([2, 9, S], np.uint32)
    aw = np.array([1, 2, 0, 0], np.uint32)
    bw = np.array([5, 6, 0], np.uint32)
    z = lambda x: np.zeros_like(x) | np.where(x == S, S, 0).astype(np.uint32)
    words, (w,) = merge_sorted(
        (jnp.asarray(z(a)), jnp.asarray(a)), (jnp.asarray(aw),),
        (jnp.asarray(z(b)), jnp.asarray(b)), (jnp.asarray(bw),))
    lo = np.asarray(words[1])
    np.testing.assert_array_equal(lo[:4], [2, 3, 8, 9])
    np.testing.assert_array_equal(np.asarray(w)[:4], [5, 1, 2, 6])
    assert (lo[4:] == S).all()


@pytest.mark.parametrize("na,nb,n_words,kmax", [
    (2048, 1500, 2, 1 << 20),
    (2048, 1500, 4, 1 << 20),
    (3000, 5192, 2, 1 << 20),
    (1100, 1900, 2, 1 << 20),
    (7000, 6000, 2, 1 << 20),
    (15 * 1024 - 10, 5, 2, 1 << 20),
    (13 * 1024, 8 * 1024 - 77, 2, 1 << 9),
    (1, 4096, 3, 1 << 20),
    (4096, 1, 3, 1 << 20),
    (333, 77, 6, 1 << 20),
    (100, 300, 8, 1 << 20),
    (0, 7, 8, 1 << 20),
    (640, 640, 12, 1 << 20),
    (500, 700, 2, 4),
    (1000, 1000, 4, 3),
])
def test_merge_parity_shapes(na, nb, n_words, kmax):
    """Non-power-of-two and lopsided stream lengths, 2..12-word keys, and
    duplicate-heavy streams (kmax of 3-4 values per word puts most keys
    in both streams)."""
    rng = np.random.default_rng(na * 31 + nb * 7 + n_words + kmax)
    a_cols, aw = _sorted_stream(rng, na, n_words, kmax=kmax)
    b_cols, bw = _sorted_stream(rng, nb, n_words, kmax=kmax)
    words, (w,) = merge_sorted(
        tuple(jnp.asarray(c) for c in a_cols), (jnp.asarray(aw),),
        tuple(jnp.asarray(c) for c in b_cols), (jnp.asarray(bw),))
    want_cols, want_w = _merge_oracle(a_cols, aw, b_cols, bw)
    n = na + nb
    assert words[0].shape[0] == 1 << int(np.ceil(np.log2(max(n, 2))))
    got = [np.asarray(c)[:n] for c in words]
    for j in range(n_words):
        np.testing.assert_array_equal(got[j], want_cols[j])
    got_pairs = sorted(zip(*[c.tolist() for c in got],
                           np.asarray(w)[:n].tolist()))
    want_pairs = sorted(zip(*[c.tolist() for c in want_cols],
                            want_w.tolist()))
    assert got_pairs == want_pairs
    assert all((np.asarray(c)[n:] == S).all() for c in words)
    assert (np.asarray(w)[n:] == 0).all()
