"""Count table construction / merge / lookup vs the oracle."""

import numpy as np
import pytest

import oracle
from kat_tpu.core import counting, kmers


def _encode(seqs, pad_to=None):
    L = pad_to or max(len(s) for s in seqs)
    arr = np.full((len(seqs), L), 255, np.uint8)
    for i, s in enumerate(seqs):
        arr[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
    return kmers.encode_ascii(arr)


def _table_dict(table):
    keys, counts = counting.table_to_numpy(table)
    return {int(k): int(c) for k, c in zip(keys, counts)}


@pytest.mark.parametrize("k", [5, 13, 27])
def test_count_batch_matches_oracle(k):
    rng = np.random.default_rng(11 + k)
    seqs = ["".join(rng.choice(list("ACGTN"), size=80,
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
            for _ in range(32)]
    hi, lo, valid = kmers.extract_kmers(_encode(seqs), k, True)
    table = counting.count_batch(hi, lo, valid)
    assert _table_dict(table) == dict(oracle.count_seqs(seqs, k, True))


def test_table_sorted_and_padded():
    seqs = ["ACGTACGTACGTACGT"]
    hi, lo, valid = kmers.extract_kmers(_encode(seqs), 5, True)
    table = counting.count_batch(hi, lo, valid)
    n = int(table.n_unique)
    keys = kmers.join_u64(np.asarray(table.keys_hi), np.asarray(table.keys_lo))
    assert (np.diff(keys[:n].astype(np.int64)) > 0).all()
    assert (np.asarray(table.counts)[n:] == 0).all()
    assert (np.asarray(table.keys_hi)[n:] == kmers.SENTINEL).all()


def test_streaming_counter_grows():
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(64)]
    sc = counting.StreamingCounter(initial_capacity=64)
    for i in range(0, len(seqs), 16):
        chunk = seqs[i:i + 16]
        hi, lo, valid = kmers.extract_kmers(_encode(chunk), 13, True)
        sc.add(hi, lo, valid)
    got = _table_dict(sc.finish())
    assert got == dict(oracle.count_seqs(seqs, 13, True))
    assert sc.capacity > 64


def test_lookup():
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(16)]
    k = 17
    hi, lo, valid = kmers.extract_kmers(_encode(seqs), k, True)
    table = counting.count_batch(hi, lo, valid)
    expect = oracle.count_seqs(seqs, k, True)

    # present keys
    present = list(expect.items())[:200]
    qh = np.array([v >> 32 for v, _ in present], np.uint32)
    ql = np.array([v & 0xFFFFFFFF for v, _ in present], np.uint32)
    got = np.asarray(counting.lookup(table, qh, ql))
    assert (got == np.array([c for _, c in present])).all()

    # absent keys
    absent = []
    while len(absent) < 50:
        v = int(rng.integers(0, 1 << (2 * k)))
        v = min(v, oracle.revcomp(v, k))
        if v not in expect:
            absent.append(v)
    qh = np.array([v >> 32 for v in absent], np.uint32)
    ql = np.array([v & 0xFFFFFFFF for v in absent], np.uint32)
    assert (np.asarray(counting.lookup(table, qh, ql)) == 0).all()


def test_merge_tables():
    rng = np.random.default_rng(13)
    seqs1 = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(8)]
    seqs2 = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(8)]
    k = 9
    t1 = counting.count_batch(*kmers.extract_kmers(_encode(seqs1), k, True))
    t2 = counting.count_batch(*kmers.extract_kmers(_encode(seqs2), k, True))
    merged = counting.merge_tables(t1, t2)
    assert _table_dict(merged) == dict(oracle.count_seqs(seqs1 + seqs2, k, True))


def test_table_from_numpy_roundtrip():
    keys = np.array([5, 1, 99, 5, 2 ** 50], np.uint64)
    counts = np.array([2, 1, 7, 3, 9], np.uint32)
    table = counting.table_from_numpy(keys, counts, capacity=8)
    assert _table_dict(table) == {1: 1, 5: 5, 99: 7, 2 ** 50: 9}


def test_mask_bincount_matches_u64_scatter():
    """stats.mask_bincount (u32-accumulating scatter) is exact for 0/1
    masks — 1D, 2D, and mode='drop'."""
    import jax.numpy as jnp
    import numpy as np

    from kat_tpu.core.stats import mask_bincount

    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, 50, size=10_000).astype(np.int32))
    mask = jnp.asarray(rng.random(10_000) < 0.7)
    got = np.asarray(mask_bincount((50,), idx, mask))
    want = np.zeros(50, np.uint64)
    np.add.at(want, np.asarray(idx), np.asarray(mask).astype(np.uint64))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint64

    j = jnp.asarray(rng.integers(0, 7, size=10_000).astype(np.int32))
    got2 = np.asarray(mask_bincount((50, 7), (idx, j), mask))
    want2 = np.zeros((50, 7), np.uint64)
    np.add.at(want2, (np.asarray(idx), np.asarray(j)),
              np.asarray(mask).astype(np.uint64))
    np.testing.assert_array_equal(got2, want2)

    # out-of-range drops with mode="drop"
    idx3 = jnp.asarray(np.array([0, 99, 3], np.int32))
    got3 = np.asarray(mask_bincount(
        (5,), idx3, jnp.asarray([True, True, True]), mode="drop"))
    np.testing.assert_array_equal(got3, [1, 0, 0, 1, 0])


def test_window_hit_counts_matches_window_counts():
    import jax.numpy as jnp
    import numpy as np

    from kat_tpu.core import coverage, counting, kmers

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(8, 64), dtype=np.uint8)
    codes[2, 10] = 4  # invalid base
    k = 9
    hi, lo, valid = kmers.extract_kmers(jnp.asarray(codes), k, True)
    table = counting.count_batch(hi, lo, valid, out_size=1 << 10)

    c, _g, v = coverage.window_counts(table, jnp.asarray(codes), k, True)
    hits, nwin = coverage.window_hit_counts(table, jnp.asarray(codes), k,
                                            True)
    np.testing.assert_array_equal(
        np.asarray(hits),
        np.asarray(((c > 0) & v).sum(axis=-1)).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(nwin),
                                  np.asarray(v.sum(axis=-1), np.int32))


def test_flush_budget_recomputed_on_slab_growth():
    """A short FIRST batch (common with parallel range readers) is flushed
    on its own when full-size slabs arrive; the counter then adopts the
    larger slab shape, stacks at most flush_batches of those per flush,
    and counts stay exact."""
    import numpy as np

    from kat_tpu.core import counting

    rng = np.random.default_rng(0)
    k = 9
    L = 64
    sc = counting.CodeStreamingCounter(
        k, canonical=True, initial_capacity=1 << 14,
        max_capacity=1 << 18, flush_batches=8)

    max_stacked = 0
    small = rng.integers(0, 4, size=(2, L), dtype=np.uint8)
    sc.add_codes(small)  # tiny first slab
    big_batches = [rng.integers(0, 4, size=(32, L), dtype=np.uint8)
                   for _ in range(40)]
    for b in big_batches:
        sc.add_codes(b)
        if sc._codes:  # _shape is None right after a flush
            assert sc._shape == (32, L)
            max_stacked = max(max_stacked,
                              len(sc._codes) * sc._shape[0])
    assert max_stacked == 7 * 32, max_stacked

    table = sc.finish()
    import oracle

    def dec(batch):
        return ["".join("ACGT"[c] for c in row) for row in batch]

    seqs = dec(small) + [s for b in big_batches for s in dec(b)]
    want = oracle.count_seqs(seqs, k)
    keys, counts = counting.table_to_numpy(table)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == dict(want)


@pytest.mark.parametrize("n,nb", [((1 << 20) + 4099, 37),
                                  ((1 << 20) + 17, 10002)])
def test_binned_sums_large_parity(n, nb):
    """binned_sums over more than 2^20 elements (several masks sharing
    one bin index) equals numpy's bincount exactly, including bins that
    never occur and the full 0..nb-1 range."""
    import jax.numpy as jnp

    from kat_tpu.core import stats

    rng = np.random.default_rng(n)
    bins = rng.integers(0, nb, size=n).astype(np.int32)
    masks = [rng.random(n) < 0.6, rng.random(n) < 0.01]
    got = stats.binned_sums(nb, jnp.asarray(bins),
                            tuple(jnp.asarray(m) for m in masks))
    for g, m in zip(got, masks):
        g = np.asarray(g)
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(
            g, np.bincount(bins, weights=m, minlength=nb).astype(np.uint64))


def test_monotone_packed_sums_parity():
    """monotone_packed_sums over more than 2^20 packed keys equals numpy
    per request — including derived bins that repeat across packed runs
    (the packed key is finer than each derived key)."""
    import jax.numpy as jnp

    from kat_tpu.core import stats

    rng = np.random.default_rng(7)
    n = (1 << 20) + 4111
    # mimic comp pass 2: two monotone step binnings of one value
    v = rng.integers(0, 500, size=n)
    spec = np.minimum(v, 36).astype(np.int32)       # dm = 37
    col = np.minimum((v + 2) // 3, 28).astype(np.int32)  # d2 = 29
    packed = spec * 29 + col
    m0 = rng.random(n) < 0.6
    m1 = rng.random(n) < 0.3
    reqs = ((29, 37, 0), (1, 29, 1), (29, 37, 1))
    got = stats.monotone_packed_sums(
        jnp.asarray(packed), reqs, (jnp.asarray(m0), jnp.asarray(m1)))
    for g, (div, mod, mi) in zip(got, reqs):
        want = np.bincount((packed // div) % mod, weights=(m0, m1)[mi],
                           minlength=mod).astype(np.uint64)
        np.testing.assert_array_equal(np.asarray(g), want)
        assert np.asarray(g).dtype == np.uint64
