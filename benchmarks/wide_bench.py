"""Steady-state wide-key counting throughput on the device (k=33: the 4-word
key path, the narrowest 'wide' configuration and the one BASELINE config
5's k=31 neighbors).  Mirrors bench.py's device-side methodology —
pre-uploaded batches, warm flushes before the measurement window, scalar
sync — so the number is execution, not compile.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from kat_tpu.core import wide  # noqa: E402


def main() -> None:
    k = 33
    rows, length = 4096, 1024
    windows = rows * (length - k + 1)
    genome_len = 1 << 23
    flush_batches = 16
    warm_batches = 2 * flush_batches
    bench_batches = 2 * flush_batches

    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, size=genome_len + length, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, length)
    batches = []
    for _ in range(4):
        offs = rng.integers(0, genome_len, size=rows)
        batches.append(jax.device_put(np.ascontiguousarray(view[offs])))

    sc = wide.WideCodeStreamingCounter(
        k, canonical=True, initial_capacity=1 << 24,
        max_capacity=1 << 26, flush_batches=flush_batches)

    t_compile = time.perf_counter()
    for i in range(warm_batches):
        sc.add_codes(batches[i % 4])
    _ = int(sc.current_table().n_unique)  # sync all pending flushes
    compile_s = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    for i in range(bench_batches):
        sc.add_codes(batches[i % 4])
    _ = int(sc.current_table().n_unique)
    dt = time.perf_counter() - t0

    print(json.dumps({
        "metric": "wide_canonical_kmers_per_s",
        "k": k,
        "n_words": sc.n_words,
        "value": round(bench_batches * windows / dt, 1),
        "unit": "kmers/s",
        "warm_seconds": round(compile_s, 1),
        "bench_seconds": round(dt, 2),
        "distinct": int(sc.current_table().n_unique),
    }), flush=True)


if __name__ == "__main__":
    main()
