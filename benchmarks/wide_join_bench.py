"""Wide-key (k=33, 4-word) sort-merge-join lookup throughput on the device —
the analysis-phase engine for k>31 tools, measured the same way as the
narrow number in benchmarks/analysis_bench.py, with bit-identity
attestation against the wide binary search.  Prints one JSON line.
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

from kat_tpu.core import tables, wide  # noqa: E402
from kat_tpu.ops.join import counts_join  # noqa: E402

SMALL = bool(os.environ.get("KAT_TPU_ANALYSIS_SMALL"))
K = 33
ROWS, LEN = (64, 256) if SMALL else (4096, 1024)


def main() -> None:
    res: dict = {"k": K}
    rng = np.random.default_rng(3)
    glen = 1 << 14 if SMALL else 1 << 23
    genome = rng.integers(0, 4, size=glen + LEN, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, LEN)
    batches = [jax.device_put(np.ascontiguousarray(
        view[rng.integers(0, glen, size=ROWS)])) for _ in range(4)]

    t0 = time.perf_counter()
    sc = wide.WideCodeStreamingCounter(
        K, canonical=True,
        initial_capacity=1 << 16 if SMALL else 1 << 24,
        max_capacity=1 << 26, flush_batches=16)
    for i in range(16):
        sc.add_codes(batches[i % 4])
    tab = tables.compact(sc.finish())
    res["build_seconds"] = round(time.perf_counter() - t0, 1)
    res["table_entries"] = int(tab.n_unique)
    res["n_words"] = tab.n_words

    words, _valid = tables.extract(batches[0], K, canonical=False)
    q = tables.canonicalize(words, K)
    m = min(1 << 12 if SMALL else 1 << 22, q[0].size)
    qw = tuple(w.reshape(-1)[:m] for w in q)

    def timed(fn, reps=3):
        out = fn()
        _ = np.asarray(out.reshape(-1)[:8])
        best = float("inf")
        for _i in range(reps):
            t0 = time.perf_counter()
            out = fn()
            _ = np.asarray(out.reshape(-1)[:8])
            best = min(best, time.perf_counter() - t0)
        return out, best

    join_out, dt = timed(lambda: counts_join(tab.words, tab.counts, qw))
    res["wide_join_per_s"] = round(m / dt, 1)
    res["wide_join_ns_per_query"] = round(dt / m * 1e9, 2)

    bin_out, bdt = timed(lambda: wide.lookup_wide(tab, qw), reps=1)
    res["wide_binary_ns_per_query"] = round(bdt / m * 1e9, 2)
    res["wide_join_speedup"] = round(bdt / dt, 2)
    res["wide_join_attest"] = ("PASS" if bool(
        jnp.array_equal(join_out, bin_out)) else "FAIL")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
