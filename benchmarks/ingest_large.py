"""Streaming exercise on one device (BASELINE.md config 5 scaled down): a multi-GB gzipped paired-end run
through the full ingest path — native C++ reader (gz inflate + 2-bit
dense packing + (k-1) seams) -> prefetch thread -> device counting —
with input-pipeline utilization printed, so the claim that the device
stays busy has a measured artifact.

Generates the dataset on first use (default ~2 x 1.1GB gz of 150bp
paired reads from a 40Mbp genome at ~30x) under /tmp and reuses it.

Prints ONE JSON line:
  {"ingest_kmers_per_s", "read_gb", "wall_seconds",
   "device_busy_frac_est", ...}

device_busy_frac_est: device-side counting time (measured separately on
the same batches) over wall time — the utilization the input pipeline
sustains.

Usage: python benchmarks/ingest_large.py [--reads N] [--keep]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

K = 27
READ_LEN = 150
GENOME_LEN = 40_000_000


def _dataset(n_reads: int) -> list[str]:
    paths = [f"/tmp/kat_tpu_ingest_r{i}_{n_reads}.fastq.gz"
             for i in (1, 2)]
    if all(os.path.exists(p) for p in paths):
        return paths
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, GENOME_LEN + 600, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)[genome]
    view = np.lib.stride_tricks.sliding_window_view(bases, READ_LEN)
    comp = np.frombuffer(b"TGCA", np.uint8)[genome]
    rview = np.lib.stride_tricks.sliding_window_view(comp, READ_LEN)
    qual = b"I" * READ_LEN
    t0 = time.time()
    for mate, path in enumerate(paths):
        offs = np.random.default_rng(23 + mate).integers(
            0, GENOME_LEN, size=n_reads)
        with gzip.open(path + ".tmp", "wb", compresslevel=1) as f:
            buf = []
            for i in range(n_reads):
                src = view if mate == 0 else rview
                buf.append(b"@r%d/%d\n" % (i, mate + 1))
                buf.append(src[offs[i]].tobytes())
                buf.append(b"\n+\n")
                buf.append(qual)
                buf.append(b"\n")
                if len(buf) >= 4000:
                    f.write(b"".join(buf))
                    buf = []
            f.write(b"".join(buf))
        os.rename(path + ".tmp", path)
    print(f"generated {paths} in {time.time() - t0:.0f}s",
          file=sys.stderr)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=4_000_000,
                    help="reads per mate file (4M => ~2x0.3GB gz, "
                         "~1.2GB text each)")
    ap.add_argument("--clean", action="store_true",
                    help="delete the generated dataset afterwards "
                         "(default keeps it for reuse — generation is "
                         "the slowest part)")
    args = ap.parse_args()

    from kat_tpu.core import counting
    from kat_tpu.io import native
    from kat_tpu.io.prefetch import prefetch

    paths = _dataset(args.reads)
    gz_bytes = sum(os.path.getsize(p) for p in paths)
    windows = args.reads * 2 * (READ_LEN - K + 1)

    # reader-only ceiling: the native reader + prefetch with no device
    # work at all (what the input pipeline could sustain)
    threads = native.reader_threads_default(len(paths))
    t0 = time.perf_counter()
    n_batches = 0
    batch_shapes = []
    for batch in prefetch(native.stream_code_batches(paths, K,
                                                     threads=threads),
                          depth=4):
        if n_batches < 3:
            batch_shapes.append(tuple(batch.shape))
        n_batches += 1
    reader_wall = time.perf_counter() - t0

    # full pipeline: reader + prefetch + device counting overlapped
    sc = counting.CodeStreamingCounter(
        K, canonical=True, initial_capacity=1 << 26,
        max_capacity=1 << 28)
    t0 = time.perf_counter()
    for batch in prefetch(native.stream_code_batches(paths, K,
                                                     threads=threads),
                          depth=4):
        sc.add_codes(batch)
    sc.finish()
    n_uniq = sc.device_sync()
    wall = time.perf_counter() - t0

    print(json.dumps({
        "ingest_kmers_per_s": round(windows / wall, 1),
        "reader_only_kmers_per_s": round(windows / reader_wall, 1),
        # 1.0 = device work fully hidden behind the input pipeline
        "pipeline_utilization": round(reader_wall / wall, 3),
        "read_gb_gz": round(gz_bytes / 1e9, 3),
        "wall_seconds": round(wall, 1),
        "reader_seconds": round(reader_wall, 1),
        "batches": n_batches,
        "reader_threads": threads,
        "distinct": int(n_uniq),
        "batch_shapes": batch_shapes,
    }), flush=True)

    if args.clean:
        for p in paths:
            os.unlink(p)


if __name__ == "__main__":
    main()
