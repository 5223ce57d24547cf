"""Device parity on the GPU: the counting core and the lookups, compiled
for the card, against NumPy.  Each test takes the `gpu` fixture, which
skips it where JAX sees no GPU; `chip_smoke.py` runs them on the card
with `pytest -m gpu`."""

import numpy as np
import pytest

import jax.numpy as jnp

import oracle
from kat_tpu.core import counting, tables, wide
from kat_tpu.ops.join import counts_join
from kat_tpu.parallel.sharded import ShardedCounter, make_mesh

pytestmark = pytest.mark.gpu

K = 27


def _reads(seed, rows, length, err=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 1 << 18, dtype=np.uint8)
    offs = rng.integers(0, genome.size - length, rows)
    codes = genome[offs[:, None] + np.arange(length)]
    hit = rng.random(codes.shape) < err
    codes[hit] = (codes[hit] + 1) % 4
    codes[rng.random(codes.shape) < 0.001] = 255  # invalid bases
    return codes


def _np_counts(codes, k):
    """Canonical k-mer keys and counts of a [rows, L] code matrix."""
    c64 = codes.astype(np.uint64) & np.uint64(3)
    valid = codes < 4
    w = codes.shape[1] - k + 1
    fwd = np.zeros((codes.shape[0], w), np.uint64)
    rc = np.zeros_like(fwd)
    ok = np.ones(fwd.shape, bool)
    for j in range(k):
        c = c64[:, j:j + w]
        fwd = (fwd << np.uint64(2)) | c
        rc |= (np.uint64(3) - c) << np.uint64(2 * j)
        ok &= valid[:, j:j + w]
    return np.unique(np.minimum(fwd, rc)[ok], return_counts=True)


def test_device_counting_parity(gpu):
    """~16M windows through the fused flush, with table growth."""
    batches = [_reads(s, 2048, 1024) for s in range(8)]
    sc = counting.CodeStreamingCounter(K, initial_capacity=1 << 22,
                                       flush_batches=4)
    for b in batches:
        sc.add_codes(b)
    keys, counts = counting.table_to_numpy(sc.finish())
    want_k, want_c = _np_counts(np.concatenate(batches), K)
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(counts, want_c)


def test_sharded_counting_parity(gpu):
    """The k-mer-space sharded flush over every visible GPU."""
    batches = [_reads(10 + s, 1024, 1024) for s in range(4)]
    sc = ShardedCounter(make_mesh(len(gpu)), K, shard_capacity=1 << 21,
                        flush_batches=2)
    for b in batches:
        sc.add_codes(b)
    keys, counts = counting.table_to_numpy(sc.finish())
    want_k, want_c = _np_counts(np.concatenate(batches), K)
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(counts, want_c)


def test_wide_counting_parity(gpu):
    codes = _reads(20, 256, 300)
    sc = wide.WideCodeStreamingCounter(41, initial_capacity=1 << 15,
                                       flush_batches=2)
    for i in range(0, 256, 64):
        sc.add_codes(codes[i:i + 64])
    keys, counts = wide.table_to_numpy(sc.finish())
    seqs = ["".join("ACGT"[c] if c < 4 else "N" for c in row)
            for row in codes]
    assert dict(zip(keys, counts.tolist())) == dict(
        oracle.count_seqs(seqs, 41))


def _lookup_case():
    codes = _reads(30, 1024, 1024)
    want_k, want_c = _np_counts(codes, K)
    table = counting.table_from_numpy(want_k, want_c.astype(np.uint32))
    rng = np.random.default_rng(31)
    q = np.concatenate([rng.choice(want_k, 1 << 20),
                        rng.integers(0, 1 << 54, 1 << 18,
                                     dtype=np.uint64)])
    pos = np.minimum(np.searchsorted(want_k, q), want_k.size - 1)
    want = np.where(want_k[pos] == q, want_c[pos], 0)
    qw = (jnp.asarray((q >> np.uint64(32)).astype(np.uint32)),
          jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    return table, qw, want


def test_lookup_parity(gpu):
    """The default lookup (binary search) on the card agrees with NumPy."""
    table, qw, want = _lookup_case()
    np.testing.assert_array_equal(np.asarray(tables.lookup(table, qw)),
                                  want)


def test_join_parity(gpu):
    """The sort-merge join (KAT_TPU_JOIN=1) on the card agrees with
    NumPy."""
    table, qw, want = _lookup_case()
    np.testing.assert_array_equal(
        np.asarray(counts_join((table.keys_hi, table.keys_lo),
                               table.counts, qw)), want)
