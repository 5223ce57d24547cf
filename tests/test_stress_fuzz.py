"""Randomized stress tests for the stateful counting paths.

The streaming counter and the sharded flush are state machines (pending
batches, deferred overflow replays); this fuzz drives them with
irregular batch shapes, shape changes mid-stream, tiny capacities
(forcing growth replays) and random mesh shapes, always against the
pure-Python oracle.  Seeds are fixed — failures reproduce.
"""

import random

import numpy as np
import pytest

import oracle
from kat_tpu.core import counting, kmers, wide
from kat_tpu.io import fastx
from kat_tpu.parallel.sharded import ShardedCounter, make_mesh


def _random_batches(seed, n_seqs, k):
    rng = random.Random(seed)
    seqs = []
    for _ in range(n_seqs):
        m = rng.randint(k + 3, k + 120)
        seqs.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.04 else "ACGT")
            for _ in range(m)))
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    return seqs, list(fastx.encode_batches(
        iter(recs), k, target_codes=1 << rng.randint(10, 13)))


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_counter_torture(seed):
    """Irregular shapes + tiny capacity (growth replays) + random flush
    cadence + checked mid-stream reads through the streaming counter, vs
    the oracle."""
    rng = random.Random(seed)
    k = rng.choice([9, 13, 21])
    seqs, batches = _random_batches(seed, rng.randint(10, 30), k)

    sc = counting.CodeStreamingCounter(
        k, canonical=True,
        initial_capacity=1 << rng.randint(4, 8),
        max_capacity=1 << 16,
        flush_batches=rng.randint(1, 3))
    for b in batches:
        sc.add_codes(np.asarray(b))
        if rng.random() < 0.2:
            # mid-stream checked reader (settles pending state)
            _ = sc.current_table()
    t = sc.finish()
    keys, counts = counting.table_to_numpy(t)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == dict(oracle.count_seqs(seqs, k))


@pytest.mark.parametrize("seed", [7, 17])
def test_sharded_mesh_fuzz(seed):
    """Random mesh shape x k x slack against the oracle."""
    rng = random.Random(seed)
    k = rng.choice([11, 13, 19, 27, 33])
    seqs, batches = _random_batches(seed + 1000, rng.randint(16, 40), k)
    shape = rng.choice([((8,), ("shards",)), ((2, 4), ("a", "b")),
                        ((4, 2), ("x", "y"))])
    mesh = make_mesh(8, shape=shape[0], axis_names=shape[1])
    sc = ShardedCounter(mesh, k=k, canonical=True,
                        shard_capacity=1 << 12,
                        route_slack=rng.choice([2.0, 8.0]),
                        flush_batches=rng.randint(1, 4))
    for b in batches:
        sc.add_codes(b)
    t = sc.finish()
    if k <= kmers.MAX_K:
        keys, counts = counting.table_to_numpy(t)
        got = dict(zip(keys.tolist(), counts.tolist()))
    else:
        keys, counts = wide.table_to_numpy(t)
        got = dict(zip(keys, counts.tolist()))
    assert got == dict(oracle.count_seqs(seqs, k))
