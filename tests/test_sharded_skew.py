"""Adversarial key-skew through the sharded counter and routed lookups
(SURVEY §7 hard part (c)): low-complexity poly-A reads and a single
hot key must (a) recover exactly via the slack/capacity replay
protocol starting from deliberately tight settings, and (b) report the
measured shard imbalance so worst-case route_slack behavior is pinned."""

import random

import numpy as np
import pytest

import oracle
from kat_tpu.core import counting
from kat_tpu.io import fastx
from kat_tpu.parallel.sharded import ShardedCounter, make_mesh, shard_hash

K = 13


def _encode(seqs, target=1 << 12):
    recs = [fastx.Record(f"s{i}", s.encode())
            for i, s in enumerate(seqs)]
    return list(fastx.encode_batches(iter(recs), K, target_codes=target))


def _run_counts(seqs, **kw):
    mesh = make_mesh(8)
    sc = ShardedCounter(mesh, k=K, canonical=True, **kw)
    for b in _encode(seqs):
        sc.add_codes(b)
    table = sc.finish()
    keys, counts = counting.table_to_numpy(table)
    return sc, dict(zip(keys.tolist(), counts.tolist()))


def test_poly_a_floods_one_shard_exactly():
    """Poly-A reads: every window is the same canonical k-mer, so ONE
    shard receives the entire stream — the router's worst case.  Tight
    initial slack forces the drop->double-slack replay path."""
    seqs = ["A" * 500] * 40 + ["C" * 300] * 10
    rng = random.Random(3)
    seqs += ["".join(rng.choice("ACGT") for _ in range(200))
             for _ in range(20)]
    sc, got = _run_counts(seqs, shard_capacity=1 << 12, route_slack=1.05)
    want = oracle.count_seqs(seqs, K)
    assert got == dict(want)
    # replay protocol must have widened the slack to absorb the flood
    assert sc.route_slack > 1.05


def test_hot_key_imbalance_factor_reported():
    """Measure and pin the imbalance: a single-hot-key stream (poly-G,
    canonical poly-C) lands ~90% of all windows on the one shard that
    owns it; the recovered counts stay exact."""
    seqs = ["G" * 500] * 45  # one canonical key, ~90% of the stream
    rng = random.Random(7)
    seqs += ["".join(rng.choice("ACGT") for _ in range(494))
             for _ in range(5)]
    sc, got = _run_counts(seqs, shard_capacity=1 << 12, route_slack=1.1)
    want = oracle.count_seqs(seqs, K)
    assert got == dict(want)

    # actual per-shard window load from the ownership hash
    import jax.numpy as jnp

    keys = np.array(sorted(want), np.uint64)
    w = np.array([want[int(v)] for v in keys], np.int64)
    dest = np.asarray(shard_hash(
        jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
        % np.uint32(8))
    loads = np.bincount(dest, weights=w, minlength=8)
    imbalance = loads.max() / loads.mean()
    assert imbalance > 4.0  # genuinely adversarial (~7x here)
    # the counter absorbed it by slack widening, not by dropping keys
    assert sc.route_slack >= 1.1


def test_mixed_skew_capacity_and_slack_recovery():
    """Low-complexity + unique-heavy mix with tiny initial capacity:
    both the capacity-doubling and slack-doubling replays fire in one
    run and the result is still exact."""
    rng = random.Random(11)
    seqs = ["AT" * 250] * 30
    seqs += ["".join(rng.choice("ACGT") for _ in range(300))
             for _ in range(40)]
    sc, got = _run_counts(seqs, shard_capacity=1 << 8, route_slack=1.05)
    want = oracle.count_seqs(seqs, K)
    assert got == dict(want)


def test_shard_hash_on_degenerate_keys():
    """poly-A/poly-AT canonical keys of MANY k values still spread under
    the ownership hash (no systematic collapse for degenerate inputs)."""
    import jax.numpy as jnp

    keys = []
    for kk in range(5, 30):
        for pat in ("A", "AT", "AC", "AG", "C", "CG"):
            s = (pat * kk)[:kk]
            v = oracle.pack(s)
            keys.append(min(v, oracle.revcomp(v, kk)))
    keys = sorted(set(keys))
    hi = jnp.asarray([v >> 32 for v in keys], jnp.uint32)
    lo = jnp.asarray([v & 0xFFFFFFFF for v in keys], jnp.uint32)
    dest = np.asarray(shard_hash(hi, lo) % np.uint32(8))
    freq = np.bincount(dest, minlength=8)
    # no shard owns more than half of these pathological keys
    assert freq.max() <= len(keys) / 2
