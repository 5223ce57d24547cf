"""Sharded counting determinism: the mesh-sharded all_to_all counter must
produce byte-identical tables/histograms to the single-device engine for any
mesh shape (SURVEY §4: 'same input -> identical tables across shardings')."""

import random

import numpy as np
import pytest

import oracle
from kat_tpu.core import counting, kmers
from kat_tpu.io import fastx
from kat_tpu.parallel.sharded import (ShardedCounter, _fold_shift, make_mesh,
                                     shard_hash)


@pytest.fixture(scope="module")
def batches():
    rng = random.Random(11)
    seqs = []
    for _ in range(64):
        n = rng.randint(30, 120)
        seqs.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.05 else "ACGT")
            for _ in range(n)))
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    return seqs, list(fastx.encode_batches(iter(recs), 13,
                                           target_codes=1 << 12))


def _oracle_counts(seqs, k):
    return oracle.count_seqs(seqs, k)


@pytest.mark.parametrize("mesh_spec", [
    ((8,), ("shards",)),
    ((2, 4), ("dp", "kp")),
])
def test_sharded_counts_match_oracle(batches, mesh_spec):
    seqs, code_batches = batches
    shape, names = mesh_spec
    mesh = make_mesh(8, shape=shape, axis_names=names)
    sc = ShardedCounter(mesh, k=13, canonical=True, shard_capacity=1 << 12,
                        route_slack=8.0)
    for b in code_batches:
        sc.add_codes(b)
    table = sc.finish()
    keys, counts = counting.table_to_numpy(table)
    want = _oracle_counts(seqs, 13)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == dict(want)


def test_sharded_histogram_matches_single_device(batches):
    seqs, code_batches = batches
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=13, shard_capacity=1 << 12, route_slack=8.0)
    for b in code_batches:
        sc.add_codes(b)
    hist = sc.histogram(base=1, ceil=101, inc=1, nb_buckets=102)

    single = counting.StreamingCounter(initial_capacity=1 << 12)
    for b in code_batches:
        single.add(*kmers.extract_kmers(np.asarray(b), 13, True))
    from kat_tpu.core import stats
    want = np.asarray(stats.hist_from_counts(
        single.finish().counts, 1, 101, 1, 102), np.uint64)
    np.testing.assert_array_equal(hist, want)


def test_shard_hash_spreads():
    """Counts per shard should be roughly balanced for structured keys."""
    import jax.numpy as jnp
    n = 1 << 14
    # Structured keys: consecutive k-mer-like integers (low entropy).
    lo = jnp.arange(n, dtype=jnp.uint32)
    hi = jnp.zeros(n, jnp.uint32)
    dest = np.asarray(shard_hash(hi, lo) % np.uint32(8))
    freq = np.bincount(dest, minlength=8) / n
    assert freq.max() < 0.25, freq  # perfect would be 0.125


def test_sharded_wide_counts_match_oracle(batches):
    """Wide keys (k > 31) through the sharded all_to_all path."""
    seqs, _ = batches
    k = 33
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    code_batches = list(fastx.encode_batches(iter(recs), k,
                                             target_codes=1 << 12))
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=k, canonical=True, shard_capacity=1 << 12,
                        route_slack=8.0)
    for b in code_batches:
        sc.add_codes(b)
    table = sc.finish()
    from kat_tpu.core import wide as wide_mod

    keys, counts = wide_mod.table_to_numpy(table)
    got = dict(zip(keys, counts.tolist()))
    want = oracle.count_seqs(seqs, k)
    assert got == dict(want)


def test_route_overflow_recovers_in_place(batches):
    """A hopeless route_slack drops k-mers on the first attempt; the
    deferred-flush replay doubles the slack IN PLACE (no recount) until
    nothing drops — final counts exact."""
    seqs, code_batches = batches
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=13, shard_capacity=1 << 12,
                        route_slack=0.01)
    for b in code_batches:
        sc.add_codes(b)
    sc.check()
    assert sc.route_slack > 0.01  # grew
    keys, counts = counting.table_to_numpy(sc.finish())
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == dict(_oracle_counts(seqs, 13))


def test_capacity_overflow_recovers_in_place(batches):
    seqs, code_batches = batches
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=13, shard_capacity=1 << 4,
                        route_slack=8.0)
    for b in code_batches:
        sc.add_codes(b)
    sc.check()
    assert sc.shard_capacity > 1 << 4  # grew in place
    keys, counts = counting.table_to_numpy(sc.finish())
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == dict(_oracle_counts(seqs, 13))


def test_disable_grow_raises(batches):
    seqs, code_batches = batches
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=13, shard_capacity=1 << 4,
                        route_slack=8.0, disable_grow=True)
    with pytest.raises(RuntimeError, match="overflow"):
        for b in code_batches:
            sc.add_codes(b)
        sc.check()


@pytest.fixture(scope="module")
def seqs48():
    rng = random.Random(23)
    out = []
    for _ in range(48):
        n = rng.randint(40, 140)
        out.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.04 else "ACGT")
            for _ in range(n)))
    return out


def _count(seqs, k, n_dev=8, shape=None, names=("shards",), canonical=True,
           flush_batches=16, cap=1 << 12, slack=8.0):
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    mesh = make_mesh(n_dev, shape=shape or (n_dev,), axis_names=names)
    sc = ShardedCounter(mesh, k=k, canonical=canonical, shard_capacity=cap,
                        route_slack=slack, flush_batches=flush_batches)
    for b in fastx.encode_batches(iter(recs), k, target_codes=1 << 12):
        sc.add_codes(b)
    return sc


def _table_dict(table, k):
    if k > kmers.MAX_K:
        from kat_tpu.core import wide as wide_mod

        keys, counts = wide_mod.table_to_numpy(table)
        return dict(zip(keys, counts.tolist()))
    keys, counts = counting.table_to_numpy(table)
    return dict(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("k,n_dev,shape,names,canonical,flush_batches", [
    (27, 8, (8,), ("shards",), True, 16),    # dest folded into key bits
    (27, 8, (2, 4), ("dp", "kp"), True, 16),  # 2-D mesh, folded dest
    (27, 8, (8,), ("shards",), False, 16),   # non-canonical keys
    (27, 8, (8,), ("shards",), True, 1),     # one flush per batch
    (31, 2, (2,), ("shards",), True, 16),    # fold into the 2 spare bits
    (16, 8, (8,), ("shards",), True, 4),     # fold_shift 0: 2k == 32
    (21, 8, (4, 2), ("x", "y"), True, 2),    # 4x2 mesh
    (19, 4, (4,), ("shards",), True, 2),     # 4-device sub-mesh
    (27, 1, (1,), ("shards",), True, 16),    # one device
    (33, 8, (8,), ("shards",), False, 16),   # wide, non-canonical
    (45, 8, (2, 4), ("dp", "kp"), True, 3),  # 3-word wide keys, 2-D mesh
])
def test_sharded_flush_matches_oracle(seqs48, k, n_dev, shape, names,
                                      canonical, flush_batches):
    sc = _count(seqs48, k, n_dev, shape, names, canonical, flush_batches)
    assert _table_dict(sc.finish(), k) == dict(
        oracle.count_seqs(seqs48, k, canonical=canonical))


def test_fold_shift_rules():
    assert _fold_shift(27, 8) == 22       # 10 spare bits, 8 shards fit
    assert _fold_shift(27, 512) == 22     # boundary: dest top bit stays 0
    assert _fold_shift(27, 513) is None   # would risk sentinel collision
    assert _fold_shift(31, 2) == 30      # 2 spare bits: 2 shards still fit
    assert _fold_shift(31, 3) is None    # ...but 3 would set the top bit
    assert _fold_shift(13, 8) is None     # key under 32 bits: extra plane
    assert _fold_shift(16, 8) == 0        # 2k == 32 exactly
    assert _fold_shift(33, 8) is None     # wide path


def test_sharded_histogram_k27_matches_single_device(seqs48):
    """Folded-dest histogram (k=27) == the single-device table's."""
    from kat_tpu.core import stats

    hist = _count(seqs48, 27).histogram(1, 101, 1, 102)
    want = oracle.count_seqs(seqs48, 27)
    keys = np.array(sorted(want), np.uint64)
    single = counting.table_from_numpy(
        keys, np.array([want[int(x)] for x in keys], np.uint32))
    np.testing.assert_array_equal(hist, np.asarray(stats.hist_from_counts(
        single.counts, 1, 101, 1, 102), np.uint64))


def test_overflow_across_flushes_recovers_in_place():
    """A mid-stream flush overflow replays IN PLACE at doubled capacity
    (deferred one flush, like the single-device optimistic commit); with
    growth disabled it raises instead of silently truncating."""
    rng = np.random.default_rng(5)
    mesh = make_mesh(8)
    cap = 1 << 7
    codes = rng.integers(0, 4, size=(64, 80), dtype=np.uint8)

    sc = ShardedCounter(mesh, k=19, shard_capacity=cap, route_slack=8.0,
                        flush_batches=1)
    sc.add_codes(codes)
    sc.flush()
    sc.add_codes(codes)  # settles + replays flush 1 before flush 2
    sc.check()
    assert sc.shard_capacity > cap
    # counts exact: every window of the doubled data counted twice
    keys, counts = counting.table_to_numpy(sc.finish())
    want = oracle.count_seqs(
        ["".join("ACGT"[c] for c in row) for row in codes], 19)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == {k: 2 * v for k, v in want.items()}

    sc2 = ShardedCounter(mesh, k=19, shard_capacity=cap, route_slack=8.0,
                         flush_batches=1, disable_grow=True)
    with pytest.raises(RuntimeError, match="overflow"):
        sc2.add_codes(codes)
        sc2.flush()
        sc2.add_codes(codes)
        sc2.check()
