"""`kat hist` end to end through the default counter: FASTQ on disk ->
native reader -> fused device flush -> histogram file + dumped hash,
against the pure-Python oracle on adversarial inputs — hot k-mers,
both strands, repeat storms, table growth, several k — and byte parity
of the hist/gcp/comp artifacts between the native and Python readers."""

import gzip
from collections import Counter

import numpy as np
import pytest

import oracle
from kat_tpu import cli
from kat_tpu.io import jellyfish

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _write_fastq(path, seqs, opener=open):
    with opener(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.encode(), b"I" * len(s)))
    return str(path)


def _genome_reads(seed, genome_len, n_reads, read_len):
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, genome_len))
    offs = rng.integers(0, genome_len - read_len, n_reads)
    return [genome[o:o + read_len] for o in offs]


def _hist_lines(path):
    return [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#")]


def _run_hist(tmp_path, paths, k, extra=()):
    out = tmp_path / f"h{k}"
    assert cli.main(["hist", "-m", str(k), "-o", str(out), "-p", "none",
                     "-d", *extra, *paths]) == 0
    return out


def _check_hist_and_hash(out, seqs, k):
    want = oracle.count_seqs(seqs, k)
    _hdr, keys, counts = jellyfish.read_jf(f"{out}-hash.jf{k}")
    assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)
    occ = Counter(min(c, 10001) for c in want.values())
    lines = _hist_lines(out)
    assert len(lines) == 10001
    assert lines == [f"{i} {occ.get(i, 0)}" for i in range(1, 10002)]


@pytest.mark.parametrize("k", [17, 27, 31])
def test_hist_overlapping_reads(tmp_path, k):
    seqs = _genome_reads(k, 800, 120, 100)
    seqs[3] = seqs[3][:40] + "N" + seqs[3][41:]  # invalid-base handling
    path = _write_fastq(tmp_path / "r.fastq", seqs)
    _check_hist_and_hash(_run_hist(tmp_path, [path], k), seqs, k)


def test_hist_hot_kmer_flood(tmp_path):
    """A poly-A flood: one k-mer with a count in the thousands next to
    ordinary reads."""
    rng = np.random.default_rng(9)
    seqs = ["A" * 300] * 30
    seqs += ["".join("ACGT"[c] for c in rng.integers(0, 4, size=120))
             for _ in range(20)]
    path = _write_fastq(tmp_path / "r.fastq", seqs)
    _check_hist_and_hash(_run_hist(tmp_path, [path], 27), seqs, 27)


def test_hist_reverse_strand_and_repeat_storms(tmp_path):
    """Reads plus their reverse complements exactly double every
    canonical count, including poly-A / poly-AT / AAT repeat storms."""
    rng = np.random.default_rng(31)
    base = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=90))
            for _ in range(15)]
    base += ["A" * 120, "AT" * 60, "AAT" * 40, ("A" * 30 + "C") * 3]
    rcs = ["".join(COMP[c] for c in reversed(s)) for s in base]
    path = _write_fastq(tmp_path / "r.fastq", base + rcs)
    out = _run_hist(tmp_path, [path], 27)
    _check_hist_and_hash(out, base + rcs, 27)
    _hdr, keys, counts = jellyfish.read_jf(f"{out}-hash.jf27")
    assert (counts % 2 == 0).all()


def test_hist_k29_long_reads(tmp_path):
    seqs = _genome_reads(8, 700, 70, 110)
    path = _write_fastq(tmp_path / "r.fastq", seqs)
    _check_hist_and_hash(_run_hist(tmp_path, [path], 29), seqs, 29)


def test_hist_table_growth(tmp_path):
    """-H 512 starts the table at 512 slots: the counter doubles it
    through several deferred overflow replays."""
    rng = np.random.default_rng(4)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=120))
            for _ in range(60)]
    path = _write_fastq(tmp_path / "r.fastq", seqs)
    out = _run_hist(tmp_path, [path], 27, extra=("-H", "512"))
    _check_hist_and_hash(out, seqs, 27)


def test_hist_paired_gz_inputs(tmp_path):
    """Two gzipped mates in one input group count as one read set."""
    seqs = _genome_reads(12, 900, 160, 100)
    r1 = _write_fastq(tmp_path / "r1.fastq.gz", seqs[:80], gzip.open)
    r2 = _write_fastq(tmp_path / "r2.fastq.gz", seqs[80:], gzip.open)
    _check_hist_and_hash(_run_hist(tmp_path, [r1, r2], 25), seqs, 25)


@pytest.mark.parametrize("tool", ["hist", "gcp", "comp"])
def test_artifacts_native_vs_python_reader(tmp_path, monkeypatch, tool):
    """The native reader's fused flush and the Python reader's
    per-batch counter produce byte-identical artifacts."""
    s1 = _genome_reads(23, 700, 60, 100)
    s2 = _genome_reads(23, 700, 50, 100)
    p1 = _write_fastq(tmp_path / "a.fastq", s1)
    p2 = _write_fastq(tmp_path / "b.fastq", s2)
    outs = {}
    for tag, no_native in (("native", None), ("python", "1")):
        if no_native:
            monkeypatch.setenv("KAT_TPU_NO_NATIVE", no_native)
        prefix = tmp_path / f"{tool}_{tag}"
        if tool == "comp":
            args = ["comp", "-m", "17", "-o", str(prefix), "-p", "none",
                    p1, p2]
            files = [f"{prefix}-main.mx", f"{prefix}.stats"]
        elif tool == "gcp":
            args = ["gcp", "-m", "27", "-o", str(prefix), "-p", "none", p1]
            files = [f"{prefix}.mx"]
        else:
            args = ["hist", "-m", "27", "-o", str(prefix), "-p", "none", p1]
            files = [str(prefix)]
        assert cli.main(args) == 0
        outs[tag] = [open(f, "rb").read().replace(
            str(prefix).encode(), b"PREFIX") for f in files]
    assert outs["native"] == outs["python"]
