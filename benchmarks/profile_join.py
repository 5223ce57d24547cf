"""Stage decomposition of the sort-merge join + comp passes on the device.

Times, dispatch-subtracted where it matters:
  - join stages: query sort / merge / run-max scan / unpermute sort
  - comp pass1 ingredient ablation: full pass vs no-lookup vs
    lookups-only (suspects: f64 scaleCounter, uint64 scatter-add
    spectra/matrix).

Prints one JSON line.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kat_tpu.core import counting, comp_engine, tables  # noqa: E402
from kat_tpu.core.kmers import SENTINEL  # noqa: E402
from kat_tpu.ops.join import _run_max, counts_join  # noqa: E402
from kat_tpu.ops.merge import merge_sorted  # noqa: E402


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.tree_util.tree_map(
        lambda x: np.asarray(x.reshape(-1)[:8]) if hasattr(x, "reshape")
        else x, out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree_util.tree_map(
            lambda x: np.asarray(x.reshape(-1)[:8]) if hasattr(x, "reshape")
            else x, out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    res = {}
    rng = np.random.default_rng(0)
    n_t = 1 << 23
    m = 1 << 22

    tkeys = np.unique(rng.integers(
        1, 1 << 54, size=n_t + (n_t // 4), dtype=np.uint64))[:n_t]
    assert len(tkeys) == n_t
    tcnt = rng.integers(1, 100, size=n_t).astype(np.uint32)
    thi = jnp.asarray((tkeys >> np.uint64(32)).astype(np.uint32))
    tlo = jnp.asarray((tkeys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    tc = jnp.asarray(tcnt)
    tab = counting.CountTable(thi, tlo, tc, jnp.asarray(n_t, jnp.int32))

    q = rng.choice(tkeys, size=m)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    # dispatch floor
    noop = jax.jit(lambda x: x + 1)
    res["dispatch_ms"] = round(timed(noop, qhi) * 1e3, 1)

    # full join
    full = counts_join
    res["join_full_ms"] = round(
        timed(lambda: full((thi, tlo), tc, (qhi, qlo)), reps=3) * 1e3, 1)

    # stage 1: query sort (3 planes, 2 keys)
    idx = jnp.arange(1, m + 1, dtype=jnp.uint32)
    s1 = jax.jit(lambda a, b, i: jax.lax.sort((a, b, i), num_keys=2))
    res["join_qsort_ms"] = round(timed(s1, qhi, qlo, idx) * 1e3, 1)

    # stage 2: merge (4 planes)
    sq = s1(qhi, qlo, idx)
    tidx = jnp.full((n_t,), SENTINEL, jnp.uint32)
    zc = jnp.zeros((m,), jnp.uint32)
    s2 = jax.jit(lambda: merge_sorted(
        (thi, tlo), (tc, tidx), (sq[0], sq[1]), (zc, sq[2])))
    res["join_merge_ms"] = round(timed(s2) * 1e3, 1)

    # stage 3: run-max scan over merged length
    mw, mp = s2()
    s3 = jax.jit(lambda: _run_max(mw, mp[0]))
    res["join_scan_ms"] = round(timed(s3) * 1e3, 1)
    res["merged_len"] = int(mw[0].shape[0])

    # stage 4: unpermute sort (2 planes, 1 key)
    c = s3()
    s4 = jax.jit(lambda: jax.lax.sort((mp[1], c), num_keys=1))
    res["join_unpermute_ms"] = round(timed(s4) * 1e3, 1)

    # ---- comp pass ablation (tables at 2^23 like analysis_bench) ------
    kw = dict(k=27, d1_bins=1001, d2_bins=1001, dm_size=10000,
              d1_scale=1.0, d2_scale=1.0, canon2=True, canon3=True,
              three=False)
    tab2 = counting.CountTable(thi, tlo, tc, jnp.asarray(n_t, jnp.int32))

    os.environ["KAT_TPU_JOIN"] = "1"
    res["comp_pass1_full_s"] = round(timed(
        lambda: comp_engine.pass1(tab, tab2, None, **kw)[0]
        ["hash1_total"], reps=2), 3)

    # lookups only (join of t1 keys against t2)
    canon = jax.jit(functools.partial(tables.canonicalize, k=27))
    qk = canon((thi, tlo))
    res["comp_lookup_only_s"] = round(timed(
        lambda: full((thi, tlo), tc, qk), reps=2), 3)

    # pass without any lookup (scatter/spectra/f64 cost): monkeypatch the
    # probe out and re-jit under a fresh cache entry
    orig = tables.lookup
    tables.lookup = lambda t, q: jnp.zeros(q[0].shape, jnp.uint32)
    try:
        nolk = jax.jit(comp_engine.pass1.__wrapped__, static_argnames=(
            "k", "d1_bins", "d2_bins", "dm_size", "canon2", "canon3",
            "three", "d1_scale", "d2_scale"))
        res["comp_pass1_nolookup_s"] = round(timed(
            lambda: nolk(tab, tab2, None, **kw)[0]["hash1_total"],
            reps=2), 3)
    finally:
        tables.lookup = orig

    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
