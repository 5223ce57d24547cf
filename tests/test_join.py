"""Sort-merge-join lookup engine (ops/join.py): parity with the binary
search on narrow and wide tables across the cases that stress its
bookkeeping — sentinel queries, absent keys, heavy duplication, merge /
sort padding boundaries, key widths from 2 to 8 words, and tables with
unfilled capacity."""

import numpy as np
import pytest

import jax.numpy as jnp

from kat_tpu.core import counting, tables
from kat_tpu.core.kmers import SENTINEL
from kat_tpu.core.wide import WideTable, _unique_reduce_wide
from kat_tpu.ops.join import counts_join


def _narrow_table(rng, n_keys, capacity):
    keys = rng.choice(np.arange(1, 10 * n_keys, dtype=np.uint64),
                      size=n_keys, replace=False)
    cnts = rng.integers(1, 1000, size=n_keys).astype(np.uint32)
    return counting.table_from_numpy(keys, cnts, capacity=capacity), keys


def _queries(rng, keys, m, sentinel_frac=0.1):
    """Mix of present keys (with heavy duplication), absent keys, and
    full-sentinel queries."""
    pick = rng.integers(0, 3, size=m)
    q = np.empty(m, np.uint64)
    q[pick == 0] = rng.choice(keys, size=(pick == 0).sum())  # present
    q[pick == 1] = rng.integers(1, 1 << 40,
                                size=(pick == 1).sum()).astype(np.uint64)
    q[pick == 2] = rng.choice(keys[:3], size=(pick == 2).sum())  # dup-heavy
    sent = rng.random(m) < sentinel_frac
    q[sent] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return q


def _expect(keys, cnts, q):
    lut = dict(zip(keys.tolist(), cnts.tolist()))
    return np.array([lut.get(x, 0) for x in q.tolist()], np.uint32)


@pytest.mark.parametrize("m", [5, 700, 2048, 9000, 30_000])
def test_join_narrow_parity(m):
    rng = np.random.default_rng(7 + m)
    table, keys = _narrow_table(rng, n_keys=300, capacity=1024)
    cnts = np.asarray(table.counts[:300])
    tk = np.asarray(table.keys_hi[:300], np.uint64) << np.uint64(32)
    tk |= np.asarray(table.keys_lo[:300], np.uint64)
    q = _queries(rng, tk, m)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    got = counts_join((table.keys_hi, table.keys_lo), table.counts,
                      (qhi, qlo))
    ref = counting.lookup(table, qhi, qlo)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(got), _expect(tk, cnts, q))


def test_join_preserves_query_shape():
    rng = np.random.default_rng(11)
    table, _ = _narrow_table(rng, n_keys=50, capacity=64)
    q = rng.integers(0, 500, size=(6, 37)).astype(np.uint64)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = counts_join((table.keys_hi, table.keys_lo), table.counts,
                      (qhi, qlo))
    assert got.shape == (6, 37)
    ref = counting.lookup(table, qhi, qlo)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("n_words", [3, 4, 6, 8])
def test_join_wide_parity(n_words):
    rng = np.random.default_rng(13 + n_words)
    n_keys, cap, m = 120, 256, 400
    kw = rng.integers(0, 1 << 16, size=(n_keys, n_words)).astype(np.uint32)
    kw = np.unique(kw, axis=0)
    cnts = rng.integers(1, 99, size=len(kw)).astype(np.uint32)
    words = tuple(jnp.asarray(kw[:, i]) for i in range(n_words))
    out = _unique_reduce_wide(words, jnp.asarray(cnts), cap)
    table = WideTable(tuple(out[:n_words]), out[n_words], out[n_words + 1])

    pick = rng.integers(0, len(kw), size=m)
    qw = kw[pick].copy()
    absent = rng.random(m) < 0.4
    qw[absent, -1] ^= 0x10000  # outside the generated range => absent
    sent = rng.random(m) < 0.1
    qw[sent] = SENTINEL
    qwords = tuple(jnp.asarray(qw[:, i]) for i in range(n_words))

    got = counts_join(table.words, table.counts, qwords)
    from kat_tpu.core.wide import lookup_wide

    ref = lookup_wide(table, qwords)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("m", [5, 700, 2048, 12_000])
def test_join_sorted_queries_narrow(m):
    """queries_sorted=True (the comp pass1/2 fast path: another table's
    own keys) matches the general path exactly — duplicates, absent keys
    and sentinel tails included."""
    rng = np.random.default_rng(17 + m)
    table, keys = _narrow_table(rng, n_keys=300, capacity=1024)
    cnts = np.asarray(table.counts[:300])
    tk = np.asarray(table.keys_hi[:300], np.uint64) << np.uint64(32)
    tk |= np.asarray(table.keys_lo[:300], np.uint64)
    q = np.sort(_queries(rng, tk, m))  # ascending, sentinels at the tail
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    got = counts_join((table.keys_hi, table.keys_lo), table.counts,
                      (qhi, qlo), queries_sorted=True)
    ref = counting.lookup(table, qhi, qlo)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(got), _expect(tk, cnts, q))


def test_join_sorted_queries_are_table_keys():
    """The exact comp shape: probe one table with ANOTHER sorted table's
    key planes (sentinel capacity tail included) and assume_sorted
    through tables.lookup."""
    rng = np.random.default_rng(23)
    t_a, _ = _narrow_table(rng, n_keys=200, capacity=512)
    t_b, _ = _narrow_table(rng, n_keys=150, capacity=256)
    qw = (t_b.keys_hi, t_b.keys_lo)  # sorted, sentinels at tail
    got = counts_join((t_a.keys_hi, t_a.keys_lo), t_a.counts, qw,
                      queries_sorted=True)
    ref = counting.lookup(t_a, qw[0], qw[1])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("n_words", [3, 4, 8])
def test_join_sorted_queries_wide(n_words):
    rng = np.random.default_rng(29 + n_words)
    m = 400
    kw = rng.integers(0, 1 << 16, size=(150, n_words)).astype(np.uint32)
    kw = np.unique(kw, axis=0)
    cnts = rng.integers(1, 99, size=len(kw)).astype(np.uint32)
    words = tuple(jnp.asarray(kw[:, i]) for i in range(n_words))
    out = _unique_reduce_wide(words, jnp.asarray(cnts), 256)
    table = WideTable(tuple(out[:n_words]), out[n_words], out[n_words + 1])

    pick = rng.integers(0, len(kw), size=m)
    qw = kw[pick].copy()
    absent = rng.random(m) < 0.4
    qw[absent, -1] ^= 0x10000
    sent = rng.random(m) < 0.1
    qw[sent] = SENTINEL
    qw = qw[np.lexsort(tuple(qw[:, i] for i in reversed(range(n_words))))]
    qwords = tuple(jnp.asarray(qw[:, i]) for i in range(n_words))

    got = counts_join(table.words, table.counts, qwords,
                      queries_sorted=True)
    from kat_tpu.core.wide import lookup_wide

    ref = lookup_wide(table, qwords)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_join_empty_queries():
    rng = np.random.default_rng(3)
    table, _ = _narrow_table(rng, n_keys=10, capacity=16)
    got = counts_join((table.keys_hi, table.keys_lo), table.counts,
                      (jnp.zeros((0,), jnp.uint32),
                       jnp.zeros((0,), jnp.uint32)))
    assert got.shape == (0,)


def test_tables_lookup_env_dispatch(monkeypatch):
    """KAT_TPU_JOIN=1 forces the join through tables.lookup; results match
    the binary search exactly."""
    rng = np.random.default_rng(5)
    table, _ = _narrow_table(rng, n_keys=200, capacity=256)
    q = rng.integers(0, 2000, size=333).astype(np.uint64)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    ref = np.asarray(counting.lookup(table, qhi, qlo))

    monkeypatch.setenv("KAT_TPU_JOIN", "1")
    got = np.asarray(tables.lookup(table, (qhi, qlo)))
    np.testing.assert_array_equal(got, ref)

    monkeypatch.setenv("KAT_TPU_JOIN", "0")
    got0 = np.asarray(tables.lookup(table, (qhi, qlo)))
    np.testing.assert_array_equal(got0, ref)


def test_compact_table_preserves_lookups():
    rng = np.random.default_rng(9)
    table, _ = _narrow_table(rng, n_keys=100, capacity=4096)
    small = tables.compact(table, min_capacity=128)
    assert small.counts.shape[0] == 128
    assert int(small.n_unique) == int(table.n_unique)
    q = rng.integers(0, 1200, size=256).astype(np.uint64)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(counting.lookup(small, qhi, qlo)),
        np.asarray(counting.lookup(table, qhi, qlo)))
    # no-op when already tight
    assert tables.compact(small, min_capacity=128) is small


@pytest.mark.parametrize("na,cap_a,nb,cap_b", [(220, 512, 90, 128),
                                               (3000, 4096, 5000, 8192)])
def test_join_dual_matches_two_lookups(na, cap_a, nb, cap_b):
    """counts_join_dual answers BOTH cross-probe directions from one
    merge, exactly matching two independent binary searches — including
    unequal capacities and sentinel capacity tails."""
    rng = np.random.default_rng(31 + na)
    t_a, _ = _narrow_table(rng, n_keys=na, capacity=cap_a)
    t_b, _ = _narrow_table(rng, n_keys=nb, capacity=cap_b)
    from kat_tpu.ops.join import counts_join_dual

    got_a, got_b = counts_join_dual(
        (t_a.keys_hi, t_a.keys_lo), t_a.counts,
        (t_b.keys_hi, t_b.keys_lo), t_b.counts)
    ref_a = counting.lookup(t_b, t_a.keys_hi, t_a.keys_lo)
    ref_b = counting.lookup(t_a, t_b.keys_hi, t_b.keys_lo)
    np.testing.assert_array_equal(np.asarray(got_a), np.asarray(ref_a))
    np.testing.assert_array_equal(np.asarray(got_b), np.asarray(ref_b))
    # shared keys exist in this construction (same key universe)
    assert int(np.asarray(got_a).sum()) > 0


@pytest.mark.parametrize("n_words", [4, 8])
def test_join_dual_wide(n_words):
    rng = np.random.default_rng(37 + n_words)

    shared = rng.integers(0, 1 << 8,
                          size=(25, n_words)).astype(np.uint32)

    def wide_table(n_keys, cap, seed):
        r = np.random.default_rng(seed)
        kw = r.integers(0, 1 << 8, size=(n_keys, n_words)).astype(np.uint32)
        kw = np.unique(np.concatenate([kw, shared]), axis=0)
        cnts = r.integers(1, 99, size=len(kw)).astype(np.uint32)
        words = tuple(jnp.asarray(kw[:, i]) for i in range(n_words))
        out = _unique_reduce_wide(words, jnp.asarray(cnts), cap)
        return WideTable(tuple(out[:n_words]), out[n_words],
                         out[n_words + 1])

    t_a = wide_table(150, 256, 1)
    t_b = wide_table(60, 128, 2)
    from kat_tpu.core.wide import lookup_wide
    from kat_tpu.ops.join import counts_join_dual

    got_a, got_b = counts_join_dual(t_a.words, t_a.counts,
                                    t_b.words, t_b.counts)
    np.testing.assert_array_equal(
        np.asarray(got_a), np.asarray(lookup_wide(t_b, t_a.words)))
    np.testing.assert_array_equal(
        np.asarray(got_b), np.asarray(lookup_wide(t_a, t_b.words)))
    assert int(np.asarray(got_a).sum()) > 0  # overlap by construction


@pytest.mark.parametrize("m,n_hot", [(4000, 1), (20_000, 5)])
def test_join_duplicate_heavy_queries(m, n_hot):
    """Nearly every query is one of a few hot keys (poly-A-like skew):
    long equal-key runs in the merged stream must all get the count."""
    rng = np.random.default_rng(41 + m)
    table, keys = _narrow_table(rng, n_keys=500, capacity=1024)
    cnts = np.asarray(table.counts[:500])
    tk = np.asarray(table.keys_hi[:500], np.uint64) << np.uint64(32)
    tk |= np.asarray(table.keys_lo[:500], np.uint64)
    q = rng.choice(tk[:n_hot], size=m)
    cold = rng.random(m) < 0.02
    q[cold] = rng.integers(1, 1 << 40, size=int(cold.sum())).astype(
        np.uint64)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = counts_join((table.keys_hi, table.keys_lo), table.counts,
                      (qhi, qlo))
    np.testing.assert_array_equal(np.asarray(got), _expect(tk, cnts, q))
