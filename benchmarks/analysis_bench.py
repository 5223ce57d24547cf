"""Analysis-phase benchmark on the device: the second hot loop.

The reference's analysis tools are random point probes into a shared hash
(src/comp.cc:401-404,447 compareSlice, src/sect.cc:536 processSeq,
src/filter_sequence.cc:363 getProfile) served by an O(1) prefetched probe
(deps/jellyfish-2.2.0/include/jellyfish/large_hash_array.hpp:404-476).
Here they are served by a binary search or the sort-merge join
(ops/join.py).  This script measures, on the device:

  1. bulk lookup throughput: sort-merge join vs the binary search,
     same queries, same table — plus bit-identity attestation between the
     two,
  2. sect's device path end-to-end (extract + canonicalize + lookup),
     in bases/s,
  3. comp pass1+pass2 between two real counted tables, in table
     entries/s (the BASELINE.json secondary metric's numerator).

Prints ONE JSON line.  Sync discipline: scalar/8-element fetches only,
so that host copies do not enter the timings.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("KAT_TPU_JOIN", "1")  # sect path rides the join

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kat_tpu.core import counting, coverage, comp_engine, tables  # noqa: E402
from kat_tpu.ops.join import counts_join  # noqa: E402

SMALL = bool(os.environ.get("KAT_TPU_ANALYSIS_SMALL"))  # CPU smoke test
K = 27
ROWS, LEN = (64, 256) if SMALL else (4096, 1024)
WINDOWS = ROWS * (LEN - K + 1)


def _mark(s):
    print(f"STAGE {s}", file=sys.stderr, flush=True)


def _count_table(rng, genome_len=None, batches=16, cap=None):
    genome_len = genome_len or (1 << 14 if SMALL else 1 << 23)
    cap = cap or (1 << 16 if SMALL else 1 << 24)
    genome = rng.integers(0, 4, size=genome_len + LEN, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, LEN)
    devb = []
    for _ in range(4):
        offs = rng.integers(0, genome_len, size=ROWS)
        devb.append(jax.device_put(np.ascontiguousarray(view[offs])))
    sc = counting.CodeStreamingCounter(
        K, canonical=True, initial_capacity=cap, max_capacity=1 << 26,
        flush_batches=batches)
    for i in range(batches):
        sc.add_codes(devb[i % 4])
    t = sc.finish()
    _ = int(t.n_unique)
    return tables.compact(t), devb


def main() -> None:
    rng = np.random.default_rng(1234)
    res: dict = {}

    _mark("count tables")
    t0 = time.perf_counter()
    tab1, q_batches = _count_table(rng)
    count_s = time.perf_counter() - t0
    res["table1_entries"] = int(tab1.n_unique)
    res["table1_capacity"] = int(tab1.counts.shape[0])
    # counting cost per window for the join-vs-counting ratio (one flush
    # of 16 batches, warm table; coarse — bench.py owns the real number)
    # same capacity/batch geometry as _count_table so every program is
    # already compiled — this window must time execution, not compiles
    t0 = time.perf_counter()
    sc = counting.CodeStreamingCounter(
        K, canonical=True, initial_capacity=1 << 16 if SMALL else 1 << 24,
        max_capacity=1 << 26, flush_batches=16)
    for i in range(16):
        sc.add_codes(q_batches[i % 4])
    _ = int(sc.finish().n_unique)
    count_ns = (time.perf_counter() - t0) / (16 * WINDOWS) * 1e9
    res["counting_ns_per_window"] = round(count_ns, 2)

    # -- 1. bulk lookup: join vs binary search, m = 2^22 queries --------
    _mark("lookup join")
    words, _valid = coverage.tables.extract(q_batches[0], K,
                                             canonical=False)
    qc = coverage.tables.canonicalize(words, K)
    qfull = qc[0].reshape(-1)
    m = min(1 << 22, qfull.shape[0])
    qhi = qfull[:m]
    qlo = qc[1].reshape(-1)[:m]

    def timed(fn, reps=3):
        out = fn()
        _ = np.asarray(out.reshape(-1)[:8])  # sync (compile + warm)
        best = float("inf")
        for _i in range(reps):
            t0 = time.perf_counter()
            out = fn()
            _ = np.asarray(out.reshape(-1)[:8])
            best = min(best, time.perf_counter() - t0)
        return out, best

    tw = (tab1.keys_hi, tab1.keys_lo)
    join_out, join_dt = timed(lambda: counts_join(
        tw, tab1.counts, (qhi, qlo)))
    res["lookup_join_per_s"] = round(m / join_dt, 1)
    res["lookup_join_ns_per_query"] = round(join_dt / m * 1e9, 2)
    res["join_vs_counting_per_elt"] = round(join_dt / m * 1e9 / count_ns, 2)

    _mark("lookup binary")
    bin_out, bin_dt = timed(
        lambda: counting.lookup(tab1, qhi, qlo), reps=1)
    res["lookup_binary_per_s"] = round(m / bin_dt, 1)
    res["lookup_binary_ns_per_query"] = round(bin_dt / m * 1e9, 2)
    res["join_speedup_vs_binary"] = round(bin_dt / join_dt, 2)

    _mark("attest")
    same = bool(jnp.array_equal(join_out, bin_out))
    res["join_attest_vs_binary"] = "PASS" if same else "FAIL"

    # -- 2. sect device path end-to-end (bases/s) -----------------------
    _mark("sect path")

    def sect_call(i):
        c, g, v = coverage.window_counts(tab1, q_batches[i % 4], K, True)
        return c

    out = sect_call(0)
    _ = np.asarray(out.reshape(-1)[:8])
    best = float("inf")
    for i in range(3):
        t0 = time.perf_counter()
        out = sect_call(i)
        _ = np.asarray(out.reshape(-1)[:8])
        best = min(best, time.perf_counter() - t0)
    res["sect_bases_per_s"] = round(ROWS * LEN / best, 1)
    res["sect_windows_per_s"] = round(WINDOWS / best, 1)

    # -- 2b. gcp matrix + hist buckets over the full table ---------------
    _mark("gcp/hist")
    from kat_tpu.core import stats as _stats

    def gcp_call():
        return _stats.gcp_matrix(tab1, K, 1000, 1.0)

    g = gcp_call()
    _ = np.asarray(g[0, :8])
    best = float("inf")
    for _i in range(3):
        t0 = time.perf_counter()
        g = gcp_call()
        _ = np.asarray(g[0, :8])
        best = min(best, time.perf_counter() - t0)
    res["gcp_matrix_entries_per_s"] = round(tab1.counts.shape[0] / best, 1)

    def hist_call():
        return _stats.hist_from_counts(tab1.counts, 1, 10000, 1, 10001)

    h = hist_call()
    _ = np.asarray(h[:8])
    best = float("inf")
    for _i in range(3):
        t0 = time.perf_counter()
        h = hist_call()
        _ = np.asarray(h[:8])
        best = min(best, time.perf_counter() - t0)
    res["hist_entries_per_s"] = round(tab1.counts.shape[0] / best, 1)

    # -- 3. comp pass1+pass2 (entries/s) ---------------------------------
    _mark("comp passes")
    rng2 = np.random.default_rng(77)
    tab2, _ = _count_table(rng2)
    res["table2_entries"] = int(tab2.n_unique)

    def comp_call():
        # canonical tables probing canonical tables: the probe streams
        # are sorted keys and the two cross probes fuse into ONE merge
        # (tables.lookup_dual), exactly as tools/comp.py now does
        pre = tables.lookup_dual(tab1, tab2)
        h2_pre, h1_pre = pre if pre is not None else (None, None)
        o1 = comp_engine.pass1(
            tab1, tab2, None, k=K, d1_bins=1001, d2_bins=1001,
            dm_size=10000, d1_scale=1.0, d2_scale=1.0, canon2=True,
            canon3=True, three=False, sorted2=True, h2_pre=h2_pre)
        o2 = comp_engine.pass2(tab2, tab1, k=K, d2_bins=1001,
                               dm_size=10000, d2_scale=1.0, sorted1=True,
                               h1_pre=h1_pre)
        return o1[0]["shared_distinct"] + o2[0]["hash2_distinct"]

    x = comp_call()
    _ = int(x)
    best = float("inf")
    for _i in range(3):
        t0 = time.perf_counter()
        x = comp_call()
        _ = int(x)
        best = min(best, time.perf_counter() - t0)
    entries = tab1.counts.shape[0] + tab2.counts.shape[0]
    res["comp_entries_per_s"] = round(entries / best, 1)
    res["comp_pass12_seconds"] = round(best, 3)
    res["comp_shared_distinct_x2"] = int(x)

    res["counting_setup_seconds"] = round(count_s, 1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
