"""Sharded-counter overhead on ONE device: the 1-device-mesh
ShardedCounter's throughput against the single-table path.

Runs the same workload as bench.py through (a) the single-table
CodeStreamingCounter and (b) a 1-device-mesh ShardedCounter (whose flush
adds dest hashing, bucket slicing and a trivial all_to_all), and prints one JSON line with both rates and the ratio.

Usage: python benchmarks/sharded_one_chip.py [n_batches]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    from kat_tpu.core import counting
    from kat_tpu.parallel.sharded import ShardedCounter, make_mesh

    k = 27
    rows, length = 4096, 1024
    windows = rows * (length - k + 1)
    genome_len = 1 << 23
    flush_batches = 16
    bench_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 48

    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, size=genome_len + length, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, length)
    batches = [jax.device_put(np.ascontiguousarray(
        view[rng.integers(0, genome_len, size=rows)])) for _ in range(4)]

    def run_single():
        sc = counting.CodeStreamingCounter(
            k, canonical=True, initial_capacity=1 << 24,
            max_capacity=1 << 26, flush_batches=flush_batches)
        for i in range(2 * flush_batches + 1):  # warm every flush shape
            sc.add_codes(batches[i % 4])
        sc._flush()
        _ = sc.device_sync()
        t0 = time.perf_counter()
        for i in range(bench_batches):
            sc.add_codes(batches[i % 4])
        sc._flush()
        _ = sc.device_sync()
        return bench_batches * windows / (time.perf_counter() - t0)

    def run_sharded():
        mesh = make_mesh(1)
        sc = ShardedCounter(mesh, k, canonical=True,
                            shard_capacity=1 << 24, route_slack=1.0,
                            flush_batches=flush_batches)
        for i in range(2 * flush_batches + 1):
            sc.add_codes(batches[i % 4])
        sc.flush()
        _ = np.asarray(sc.n_unique)  # sync
        t0 = time.perf_counter()
        for i in range(bench_batches):
            sc.add_codes(batches[i % 4])
        sc.flush()
        _ = np.asarray(sc.n_unique)
        return bench_batches * windows / (time.perf_counter() - t0)

    single = run_single()
    sharded = run_sharded()
    print(json.dumps({
        "single_kmers_per_s": round(single, 1),
        "sharded_1dev_kmers_per_s": round(sharded, 1),
        "sharded_over_single": round(sharded / single, 4),
    }), flush=True)


if __name__ == "__main__":
    main()
