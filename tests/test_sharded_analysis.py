"""Distributed analysis phase (parallel/analysis.py): comp/gcp run on
co-partitioned shards with psum merges and shard-routed lookups (P6) must
be byte-identical to the single-table engines — the tables never leave the
mesh."""

import os
import random

import numpy as np
import pytest

import jax.numpy as jnp

from kat_tpu.core import comp_engine, counting, stats, tables
from kat_tpu.core.kmers import extract_kmers
from kat_tpu.io import fastx
from kat_tpu.parallel.analysis import (ShardedLookup, comp_sharded,
                                       gcp_sharded, window_counts_routed)
from kat_tpu.parallel.longseq import sharded_window_profile_routed
from kat_tpu.parallel.sharded import ShardedCounter, make_mesh

K = 13


def _random_seqs(seed, n, lo=40, hi=150):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        m = rng.randint(lo, hi)
        out.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.03 else "ACGT")
            for _ in range(m)))
    return out


def _count_sharded(seqs, mesh, canonical=True):
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    sc = ShardedCounter(mesh, k=K, canonical=canonical,
                        shard_capacity=1 << 12, route_slack=8.0)
    for b in fastx.encode_batches(iter(recs), K, target_codes=1 << 12):
        sc.add_codes(b)
    sc.check()
    return sc


def _count_single(seqs, canonical=True):
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    sc = counting.StreamingCounter(initial_capacity=1 << 13)
    for b in fastx.encode_batches(iter(recs), K, target_codes=1 << 12):
        sc.add(*extract_kmers(b, K, canonical))
    return sc.finish()


@pytest.fixture(scope="module")
def inputs():
    s1 = _random_seqs(1, 48)
    s2 = _random_seqs(2, 40)
    return s1, s2


@pytest.mark.parametrize("mesh_spec", [
    ((8,), ("shards",)),
    ((2, 4), ("dp", "kp")),
])
def test_comp_sharded_parity(inputs, mesh_spec):
    s1, s2 = inputs
    shape, names = mesh_spec
    mesh = make_mesh(8, shape=shape, axis_names=names)
    c1 = _count_sharded(s1, mesh)
    c2 = _count_sharded(s2, mesh)
    t1 = _count_single(s1)
    t2 = _count_single(s2)

    kw = dict(k=K, d1_bins=101, d2_bins=101, dm_size=101,
              d1_scale=1.0, d2_scale=1.0, canon2=True)
    (sc1, ssp1, sss1, sss2, smx, _e, _m, _mi), (sc2, ssp2, srow0, _s2b), _ = \
        comp_sharded(c1, c2, None, canon3=True, **kw)
    w1 = comp_engine.pass1(t1, t2, None, three=False, canon3=True, **kw)
    w2 = comp_engine.pass2(t2, t1, k=K, d2_bins=101, dm_size=101,
                           d2_scale=1.0)

    for key in w1[0]:
        assert int(sc1[key]) == int(w1[0][key]), key
    for key in w2[0]:
        assert int(sc2[key]) == int(w2[0][key]), key
    np.testing.assert_array_equal(np.asarray(ssp1), np.asarray(w1[1]))
    np.testing.assert_array_equal(np.asarray(sss1), np.asarray(w1[2]))
    np.testing.assert_array_equal(np.asarray(sss2), np.asarray(w1[3]))
    np.testing.assert_array_equal(np.asarray(smx), np.asarray(w1[4]))
    np.testing.assert_array_equal(np.asarray(ssp2), np.asarray(w2[1]))
    np.testing.assert_array_equal(np.asarray(srow0), np.asarray(w2[2]))


def test_comp_sharded_noncanonical_inputs(inputs):
    """Canonical-hash ownership must co-locate raw keys with their
    canonicalized probes even when hashes are counted non-canonically
    (the §5.1.2 pass-2 always-canonical quirk)."""
    s1, s2 = inputs
    mesh = make_mesh(8)
    c1 = _count_sharded(s1, mesh, canonical=False)
    c2 = _count_sharded(s2, mesh, canonical=True)
    t1 = _count_single(s1, canonical=False)
    t2 = _count_single(s2, canonical=True)

    kw = dict(k=K, d1_bins=101, d2_bins=101, dm_size=101,
              d1_scale=1.0, d2_scale=1.0, canon2=True)
    (sc1, *_rest1), (sc2, ssp2, srow0, _s2b), _ = comp_sharded(
        c1, c2, None, canon3=True, **kw)
    w1 = comp_engine.pass1(t1, t2, None, three=False, canon3=True, **kw)
    w2 = comp_engine.pass2(t2, t1, k=K, d2_bins=101, dm_size=101,
                           d2_scale=1.0)
    for key in w1[0]:
        assert int(sc1[key]) == int(w1[0][key]), key
    for key in w2[0]:
        assert int(sc2[key]) == int(w2[0][key]), key
    np.testing.assert_array_equal(np.asarray(srow0), np.asarray(w2[2]))


def test_comp_sharded_three_inputs(inputs):
    s1, s2 = inputs
    s3 = _random_seqs(3, 24)
    mesh = make_mesh(8)
    cs = [_count_sharded(s, mesh) for s in (s1, s2, s3)]
    ts = [_count_single(s) for s in (s1, s2, s3)]

    kw = dict(k=K, d1_bins=101, d2_bins=101, dm_size=101,
              d1_scale=1.0, d2_scale=1.0, canon2=True, canon3=True)
    outs1, outs2, outs3 = comp_sharded(cs[0], cs[1], cs[2], **kw)
    w1 = comp_engine.pass1(ts[0], ts[1], ts[2], three=True, **kw)
    w3 = comp_engine.pass3(ts[2])
    for key in w1[0]:
        assert int(outs1[0][key]) == int(w1[0][key]), key
    for got, want in zip(outs1[4:], w1[4:]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for key in w3:
        assert int(outs3[key]) == int(w3[key]), key


def test_gcp_sharded_parity(inputs):
    s1, _ = inputs
    mesh = make_mesh(8)
    c = _count_sharded(s1, mesh)
    t = _count_single(s1)
    got = gcp_sharded(c, K, 1000, 1.0)
    want = np.asarray(stats.gcp_matrix(t, K, 1000, 1.0), np.uint64)
    np.testing.assert_array_equal(got, want)


def test_sharded_lookup_parity(inputs):
    s1, s2 = inputs
    mesh = make_mesh(8)
    c = _count_sharded(s1, mesh)
    t = _count_single(s1)
    # query with s2's windows (mixture of hits and misses)
    recs = [fastx.Record(f"q{i}", s.encode()) for i, s in enumerate(s2)]
    batch = next(fastx.encode_batches(iter(recs), K, target_codes=1 << 12))
    words, valid = tables.extract(jnp.asarray(batch), K, canonical=False)
    q = tables.canonicalize(words, K)
    svc = ShardedLookup(c)
    got = svc.lookup([np.asarray(w) for w in q])
    want = np.asarray(tables.lookup(t, q))
    np.testing.assert_array_equal(np.where(np.asarray(valid), got, 0),
                                  np.where(np.asarray(valid), want, 0))


def test_window_counts_routed_parity(inputs):
    s1, s2 = inputs
    from kat_tpu.core import coverage

    mesh = make_mesh(8)
    c = _count_sharded(s1, mesh)
    t = _count_single(s1)
    recs = [fastx.Record(f"q{i}", s.encode()) for i, s in enumerate(s2)]
    batch = next(fastx.encode_batches(iter(recs), K, target_codes=1 << 12))
    gc_, gg, gv = window_counts_routed(ShardedLookup(c), batch, K, True)
    wc, wg, wv = coverage.window_counts(t, jnp.asarray(batch), K, True)
    np.testing.assert_array_equal(gc_, np.asarray(wc))
    np.testing.assert_array_equal(gg, np.asarray(wg))
    np.testing.assert_array_equal(gv, np.asarray(wv))


@pytest.mark.parametrize("mesh_spec", [
    ((8,), ("shards",)),
    ((2, 4), ("dp", "kp")),
])
def test_routed_halo_profile_parity(inputs, mesh_spec):
    """Long-sequence halo extraction + routed lookups (table sharded, NOT
    replicated) must equal the single-device window profile."""
    s1, _ = inputs
    from kat_tpu.core import coverage

    shape, names = mesh_spec
    mesh = make_mesh(8, shape=shape, axis_names=names)
    c = _count_sharded(s1, mesh)
    t = _count_single(s1)

    rng = random.Random(9)
    contig = "".join(rng.choice("ACGTN" if rng.random() < 0.01 else "ACGT")
                     for _ in range(5000))
    codes = fastx.encode_ascii(np.frombuffer(contig.encode(), np.uint8))
    gc_, gg = sharded_window_profile_routed(c, codes, K, True)
    wc, wg, _ = coverage.window_counts(t, jnp.asarray(codes)[None], K, True)
    np.testing.assert_array_equal(gc_, np.asarray(wc)[0])
    np.testing.assert_array_equal(gg, np.asarray(wg)[0])


def test_routed_halo_profile_wide_keys():
    """Halo + routed lookups for k > 31 (wide 4-word keys)."""
    from kat_tpu.core import coverage, wide

    k = 41
    seqs = _random_seqs(7, 24, lo=60, hi=200)
    mesh = make_mesh(8)
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    sc = ShardedCounter(mesh, k=k, canonical=True, shard_capacity=1 << 12,
                        route_slack=8.0)
    for b in fastx.encode_batches(iter(recs), k, target_codes=1 << 12):
        sc.add_codes(b)
    sc.check()

    wsc = wide.WideCodeStreamingCounter(k, True, initial_capacity=1 << 13)
    for b in fastx.encode_batches(iter(recs), k, target_codes=1 << 12):
        wsc.add_codes(np.asarray(b))
    t = wsc.finish()

    rng = random.Random(10)
    contig = "".join(rng.choice("ACGT") for _ in range(3000))
    codes = fastx.encode_ascii(np.frombuffer(contig.encode(), np.uint8))
    gc_, gg = sharded_window_profile_routed(sc, codes, k, True)
    wc, wg, _ = coverage.window_counts(t, jnp.asarray(codes)[None], k, True)
    np.testing.assert_array_equal(gc_, np.asarray(wc)[0])
    np.testing.assert_array_equal(gg, np.asarray(wg)[0])


def test_lookup_skew_single_compile():
    """Pathological query skew (every query owned by ONE shard) must cost
    exactly one compiled routed-lookup program — the qcap is planned
    exactly host-side, never discovered by recompile-and-retry."""
    from kat_tpu.core import kmers as km

    seqs = _random_seqs(77, 24)
    mesh = make_mesh(8)
    c = _count_sharded(seqs, mesh)
    svc = ShardedLookup(c)

    # one real k-mer from the data, repeated: all queries -> one shard
    key = int(km.pack_string(seqs[0].replace("N", "A")[:K]))
    hi = np.full(331, key >> 32, np.uint32)
    lo = np.full(331, key & 0xFFFFFFFF, np.uint32)
    out = svc.lookup([hi, lo])
    assert len(svc._fns) == 1, f"recompiled: {list(svc._fns)}"
    # all equal, and equal to the true count of that canonical k-mer
    want = int(counting.lookup(
        _count_single(seqs),
        jnp.asarray(hi[:1]), jnp.asarray(lo[:1]))[0])
    ck = km.canonical_int(key, K)
    want_c = int(counting.lookup(
        _count_single(seqs),
        jnp.asarray(np.uint32(ck >> 32)[None]),
        jnp.asarray(np.uint32(ck & 0xFFFFFFFF)[None]))[0])
    assert (out == out[0]).all()
    assert int(out[0]) in (want, want_c)
    assert int(out[0]) > 0


def test_lookup_mixed_queries_exact_plan():
    """Uniformly mixed queries also stay at one compile and return the
    same counts as the single-table binary search."""
    seqs = _random_seqs(78, 24)
    mesh = make_mesh(8)
    c = _count_sharded(seqs, mesh)
    svc = ShardedLookup(c)
    single = _count_single(seqs)

    rng = np.random.default_rng(5)
    qk = rng.integers(0, 1 << (2 * K), 500, dtype=np.uint64)
    hi = (qk >> np.uint64(32)).astype(np.uint32)
    lo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got = svc.lookup([hi, lo])
    assert len(svc._fns) == 1
    want = np.asarray(counting.lookup(single, jnp.asarray(hi),
                                      jnp.asarray(lo)))
    np.testing.assert_array_equal(got, want)


def test_sharded_lookup_join_in_shard_map():
    """The routed lookup's local probe through the sort-merge join
    (KAT_TPU_JOIN=1) inside shard_map on the CPU mesh.

    Runs in a SUBPROCESS: compiling this program late in a long test
    process has crashed inside XLA:CPU's backend_compile_and_load while
    the same compilation succeeds in a fresh process, so isolation keeps
    one compiler fault from taking the worker down."""
    import subprocess
    import sys

    env = dict(os.environ, KAT_TPU_JOINMAP_CHILD="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"{__file__}::test_joinmap_impl"],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-2000:])


def test_joinmap_impl(inputs, monkeypatch):
    """The actual join-in-shard_map check (see the wrapper above)."""
    if not os.environ.get("KAT_TPU_JOINMAP_CHILD"):
        pytest.skip("runs via the subprocess wrapper (XLA:CPU "
                    "compiler-state segfault; see the wrapper docstring)")
    monkeypatch.setenv("KAT_TPU_JOIN", "1")
    s1, s2 = inputs
    mesh = make_mesh(8)
    c = _count_sharded(s1, mesh)
    t = _count_single(s1)
    recs = [fastx.Record(f"q{i}", s.encode())
            for i, s in enumerate(s2)]
    batch = next(fastx.encode_batches(iter(recs), K,
                                      target_codes=1 << 11))
    words, valid = tables.extract(jnp.asarray(batch), K,
                                  canonical=False)
    q = tables.canonicalize(words, K)
    svc = ShardedLookup(c)
    got = svc.lookup([np.asarray(w) for w in q])
    want = np.asarray(tables.lookup(t, q))
    np.testing.assert_array_equal(
        np.where(np.asarray(valid), got, 0),
        np.where(np.asarray(valid), want, 0))
