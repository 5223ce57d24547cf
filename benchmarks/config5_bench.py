"""BASELINE config 5 end-to-end on one device: filter kmer + filter seq ->
comp at k=31 on a multi-GB paired-end set (BASELINE.md configs #5).

Generates a simulated paired-end library (plain FASTQ; gz ingest is
exercised by benchmarks/ingest_large.py), then drives the REAL CLI
in-process through the three stages, timing each:

  1. kat filter kmer -m31 on 'R1 R2'        (count + threshold + .jf dump)
  2. kat filter seq  -m31 --seq R1 vs the filtered hash
     (this is the analysis-phase lookup engine at ~1e9-query scale)
  3. kat comp -m31 'R1 R2' assembly.fa      (two hashes + crossing passes)

Prints ONE JSON line with per-stage wall-clock and derived throughputs.
KAT_TPU_SEQ_BATCH is raised so per-batch dispatch does not swamp
stage 2.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("KAT_TPU_SEQ_BATCH", "16384")

READ_LEN = 150
N_READS = int(os.environ.get("KAT_TPU_CFG5_READS", 4_000_000))  # per mate
GENOME = 1 << 23


def _write_reads(path, rng, view, n):
    qual = b"I" * READ_LEN
    offs = rng.integers(0, GENOME, size=n)
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"@r%d\n" % i)
            f.write(view[offs[i]].tobytes())
            f.write(b"\n+\n")
            f.write(qual)
            f.write(b"\n")


def main() -> None:
    res: dict = {"n_reads_per_mate": N_READS, "read_len": READ_LEN}
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=GENOME + READ_LEN, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)[genome]
    view = np.lib.stride_tricks.sliding_window_view(bases, READ_LEN)

    tmp = tempfile.mkdtemp(prefix="kat_cfg5_")
    r1 = os.path.join(tmp, "r1.fastq")
    r2 = os.path.join(tmp, "r2.fastq")
    asm = os.path.join(tmp, "asm.fa")
    t0 = time.perf_counter()
    _write_reads(r1, rng, view, N_READS)
    _write_reads(r2, rng, view, N_READS)
    # "assembly": 2048 contigs of 4kb tiling the genome
    with open(asm, "w") as f:
        step = GENOME // 2048
        for i in range(2048):
            f.write(f">ctg{i}\n")
            f.write(bases[i * step:i * step + 4096].tobytes().decode())
            f.write("\n")
    res["gen_seconds"] = round(time.perf_counter() - t0, 1)
    res["input_gb"] = round(
        (os.path.getsize(r1) + os.path.getsize(r2)) / 2**30, 2)

    from kat_tpu import cli

    windows_per_mate = N_READS * (READ_LEN - 31 + 1)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["filter", "kmer", "-m", "31", "--low_count", "2",
                       "--high_count", "10000",
                       "-o", os.path.join(tmp, "fk"), f"{r1} {r2}"])
        res["stage1_filter_kmer_s"] = round(time.perf_counter() - t0, 1)
        res["stage1_rc"] = rc
        res["stage1_kmers_per_s"] = round(
            2 * windows_per_mate / res["stage1_filter_kmer_s"], 1)
        jf = os.path.join(tmp, "fk-in.jf31")
        res["stage1_jf_mb"] = round(os.path.getsize(jf) / 2**20, 1)

        t0 = time.perf_counter()
        rc = cli.main(["filter", "seq", "-m", "31", "-T", "0.3",
                       "-o", os.path.join(tmp, "fs"), "--seq", r1, jf])
        res["stage2_filter_seq_s"] = round(time.perf_counter() - t0, 1)
        res["stage2_rc"] = rc
        res["stage2_lookups"] = windows_per_mate
        res["stage2_lookups_per_s"] = round(
            windows_per_mate / res["stage2_filter_seq_s"], 1)

        t0 = time.perf_counter()
        rc = cli.main(["comp", "-m", "31", "-o", os.path.join(tmp, "cmp"),
                       f"{r1} {r2}", asm])
        res["stage3_comp_s"] = round(time.perf_counter() - t0, 1)
        res["stage3_rc"] = rc
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
