"""Shard-routed lookup (P6) throughput on ONE device.

Builds a 1-device-mesh ShardedCounter, then measures ShardedLookup —
route queries to owner shards (all_to_all), answer with the local probe
(tables.lookup inside shard_map), route answers back.  This is the
program a multi-device mesh runs for sect/cold/filter-seq against
mesh-resident tables.  Also cross-checks the routed answers against the
single-table lookup bit-for-bit.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kat_tpu.core import tables  # noqa: E402
from kat_tpu.parallel.analysis import ShardedLookup  # noqa: E402
from kat_tpu.parallel.sharded import ShardedCounter, make_mesh  # noqa: E402

SMALL = bool(os.environ.get("KAT_TPU_ANALYSIS_SMALL"))  # CPU smoke
K = 27
ROWS, LEN = (64, 256) if SMALL else (4096, 1024)


def main() -> None:
    res: dict = {}
    rng = np.random.default_rng(7)
    glen = 1 << 14 if SMALL else 1 << 23
    genome = rng.integers(0, 4, size=glen + LEN, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, LEN)
    batches = [np.ascontiguousarray(
        view[rng.integers(0, glen, size=ROWS)]) for _ in range(4)]

    mesh = make_mesh(1)
    sc = ShardedCounter(mesh, K, canonical=True,
                        shard_capacity=1 << 16 if SMALL else 1 << 24,
                        route_slack=1.0, flush_batches=16)
    t0 = time.perf_counter()
    for i in range(16):
        sc.add_codes(jnp.asarray(batches[i % 4]))
    sc.check()
    res["build_seconds"] = round(time.perf_counter() - t0, 1)
    res["shard_entries"] = int(np.asarray(sc.n_unique).sum())

    words, _valid = tables.extract(jnp.asarray(batches[0]), K,
                                   canonical=False)
    q = tables.canonicalize(words, K)
    m = min(1 << 12 if SMALL else 1 << 22, q[0].size)
    qs = [np.asarray(w).reshape(-1)[:m] for w in q]

    svc = ShardedLookup(sc)
    out = svc.lookup(qs)  # compile + warm (host plumbing included)

    # device-side throughput: pre-placed queries, the jitted routed
    # program only (mirrors ShardedLookup.lookup internals — the per-call
    # 33MB query upload would otherwise enter the timing)
    from kat_tpu.core.kmers import SENTINEL
    from kat_tpu.parallel.analysis import _table_args

    c = svc.c
    per_dev = -(-m // c.n)
    total = per_dev * c.n
    qs_pad = [np.concatenate([x, np.full((total - m,), SENTINEL,
                                         np.uint32)]) for x in qs]
    qcap = svc._plan_qcap(qs_pad, per_dev)
    fn = svc._fn(per_dev, qcap)
    qdev = [jax.device_put(jnp.asarray(x.reshape(c.n, per_dev)),
                           c._tsharding) for x in qs_pad]
    targs = _table_args(c)
    dev_out, dropped = fn(*qdev, *targs)
    _ = np.asarray(dev_out[0, :8])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        dev_out, dropped = fn(*qdev, *targs)
        _ = np.asarray(dev_out[0, :8])
        best = min(best, time.perf_counter() - t0)
    res["routed_lookups"] = m
    res["routed_lookup_per_s"] = round(m / best, 1)
    res["routed_lookup_ns_per_query"] = round(best / m * 1e9, 2)
    res["routed_dropped"] = int(dropped)

    # bit-identity vs the single-table join on the materialized table
    host = tables.compact(sc.finish())
    want = np.asarray(tables.lookup(
        host, tuple(jnp.asarray(x) for x in qs)))
    res["routed_attest_vs_single"] = (
        "PASS" if np.array_equal(out, want) else "FAIL")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
