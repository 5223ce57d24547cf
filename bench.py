"""Layer benchmark of the counting core on the GPU (k=27).

Measures the `kat hist` device flush — the replacement for jellyfish's
multithreaded CAS-hash counting loop (reference
lib/src/jellyfish_helper.cc:219-246 countSeqFile / countSlice): 2-bit
windows -> canonical pack -> buffered flush -> sort + segmented reduce
into the resident table, on batches already on the device.  Two
secondary layers ride along: bulk lookups against the finished table, and
the host reader's parse rate.

Workload: 1024-base reads sampled from a random 8.4 Mbp genome.

Needs a GPU: with none it prints an error and exits 1.  Prints the card's
name and power limit, then ONE JSON line naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    """`nvidia-smi` name and power limit of the card, as it reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    import jax

    from kat_tpu.core import counting

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)

    k = 27
    rows, length = 4096, 1024          # ~4.1M windows per batch
    windows = rows * (length - k + 1)
    genome_len = 1 << 23               # 8.4 Mbp random genome
    flush_batches = 16
    warm_batches = 33                  # two full flushes + a partial one,
    #                                    so every flush shape compiles here
    bench_batches = 48                 # three flushes

    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, size=genome_len + length, dtype=np.uint8)
    read_view = np.lib.stride_tricks.sliding_window_view(genome, length)

    def make_batch():
        offsets = rng.integers(0, genome_len, size=rows)
        return np.ascontiguousarray(read_view[offsets])

    # Batches cycle from device memory: this isolates the device flush
    # from the host reader (measured separately below).
    batches = [jax.device_put(make_batch()) for _ in range(4)]

    sc = counting.CodeStreamingCounter(
        k, canonical=True, initial_capacity=1 << 24,
        max_capacity=1 << 26, flush_batches=flush_batches)

    t0 = time.perf_counter()
    for i in range(warm_batches):
        sc.add_codes(batches[i % 4])
    sc._flush()
    _ = sc.device_sync()
    warm_s = time.perf_counter() - t0

    def window() -> float:
        t0 = time.perf_counter()
        for i in range(bench_batches):
            sc.add_codes(batches[i % 4])
        sc._flush()
        _ = sc.device_sync()
        return time.perf_counter() - t0

    times = [window() for _ in range(3)]
    out = {
        "metric": "device_flush_kmers_per_s",
        "value": bench_batches * windows / min(times),
        "unit": "kmers/s",
        "window_seconds": times,
        "warmup_seconds": warm_s,
        **_lookup_bench(sc, batches),
        **_ingest_bench(),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out), flush=True)
    return 0


def _lookup_bench(sc, batches) -> dict:
    """Analysis-phase secondary metric: bulk lookups/s through
    `tables.lookup` (the engine sect/comp/filter use) against the table
    the headline run just built (reference large_hash_array.hpp:404-476
    get_key_id)."""
    import time as _t

    from kat_tpu.core import coverage, tables

    tab = tables.compact(sc.current_table())
    words, _valid = coverage.tables.extract(batches[0], 27, canonical=False)
    qc = coverage.tables.canonicalize(words, 27)
    m = min(1 << 22, qc[0].size)
    q = tuple(w.reshape(-1)[:m] for w in qc)

    def run():
        out = tables.lookup(tab, q)
        return np.asarray(out[:8])

    run()  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = _t.perf_counter()
        run()
        best = min(best, _t.perf_counter() - t0)
    return {
        "lookup_per_s": m / best,
        "lookup_ns_per_query": best / m * 1e9,
        "lookup_table_entries": int(tab.n_unique),
    }


def _ingest_bench() -> dict:
    """Input-pipeline rate: FASTQ on disk -> native parallel reader,
    host side only (SURVEY §7 hard part (f): 'input pipeline keeps the
    device busy').  Compare it with the device flush rate to see whether
    the reader outruns the device."""
    import tempfile
    import time as _t

    from kat_tpu.io import native

    k = 27
    n_reads, read_len = 400_000, 150
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=(1 << 22) + read_len, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)[genome]
    view = np.lib.stride_tricks.sliding_window_view(bases, read_len)
    qual = b"I" * read_len
    fd, path = tempfile.mkstemp(suffix=".fastq")
    try:
        with os.fdopen(fd, "wb") as f:
            for start in range(0, n_reads, 50_000):
                m = min(50_000, n_reads - start)
                offs = rng.integers(0, 1 << 22, size=m)
                f.write(b"".join(
                    b"@r%d\n%s\n+\n%s\n" % (start + i,
                                            view[offs[i]].tobytes(), qual)
                    for i in range(m)))

        threads = native.reader_threads_default(1)
        t0 = _t.perf_counter()
        windows = 0
        for batch in native.stream_code_batches([path], k,
                                                threads=threads):
            windows += batch.shape[0] * (batch.shape[1] - k + 1)
        dt = _t.perf_counter() - t0
        return {
            "ingest_host_windows_per_s": n_reads * (read_len - k + 1) / dt,
            "ingest_reader_threads": threads,
            "ingest_seconds": dt,
        }
    finally:
        os.unlink(path)


if __name__ == "__main__":
    sys.exit(main())
