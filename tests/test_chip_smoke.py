"""chip_smoke.py's own parts, on the CPU: its NumPy reference against the
pure-Python oracle and the package's distance module, its FASTQ/FASTA
writer against the package's reader, its artifact parsers, and its refusal
to report success without a GPU or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import chip_smoke as cs
import oracle
from kat_tpu.core import distance
from kat_tpu.io import fastx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(seed, rows, length):
    return np.random.default_rng(seed).integers(0, 4, (rows, length),
                                                dtype=np.uint8)


def _seqs(codes):
    return ["".join("ACGT"[c] for c in row) for row in codes]


@pytest.mark.parametrize("k", [5, 27, 31, 32])
def test_canonical_u64_matches_oracle(k):
    codes = _codes(k, 20, 90)
    got = Counter(cs.canonical_u64(codes, k).tolist())
    assert got == oracle.count_seqs(_seqs(codes), k)


@pytest.mark.parametrize("k", [33, 41, 64])
def test_canonical_u128_matches_oracle(k):
    codes = _codes(k, 12, 100)
    hi, lo = cs.canonical_u128(codes, k)
    got = Counter((int(h) << 64) | int(lo_) for h, lo_ in zip(hi, lo))
    assert got == oracle.count_seqs(_seqs(codes), k)


def test_occurrence_hist_bins():
    counts = np.array([1, 1, 2, 10000, 10001, 50000])
    h = cs.occurrence_hist(counts)
    assert h.shape == (10001,)
    assert (h[0], h[1], h[9999], h[10000]) == (2, 1, 1, 2)
    assert int(h.sum()) == counts.size


def test_ref_distances_match_package_metrics():
    rng = np.random.default_rng(3)
    s1 = rng.integers(0, 1000, 1001).astype(np.uint64)
    s2 = rng.integers(0, 1000, 1001).astype(np.uint64)
    s2[::7] = 0
    want = [fn(s1, s2) for _name, fn in distance.ALL_METRICS]
    np.testing.assert_allclose(cs.ref_distances(s1, s2), want, rtol=1e-12)


def test_written_fastq_and_fasta_read_back(tmp_path):
    data = cs.make_data(str(tmp_path), seed=5, genome_len=3000)
    recs = list(fastx.read_records(data["r1"]))
    assert len(recs) == data["half"]
    assert recs[0].name.startswith("r000000000")
    assert [r.seq.decode() for r in recs] == _seqs(
        data["reads"][:data["half"]])
    asm = list(fastx.read_records(data["asm"]))
    assert len(asm) == 1 and asm[0].name == "contig1"
    assert asm[0].seq.decode() == _seqs(data["genome"][None, :])[0]
    # 50x coverage of 150 bp reads, half of them reverse-complemented
    assert data["reads"].shape == (1000, 150)


def test_artifact_parsers(tmp_path):
    h = tmp_path / "h"
    h.write_text("# Title:x\n# ### End Metadata\n1 5\n2 0\n3 7\n")
    np.testing.assert_array_equal(cs.read_hist(str(h)), [5, 0, 7])
    m = tmp_path / "m"
    m.write_text("# Rows:2\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(cs.read_matrix(str(m)),
                                  [[1, 2, 3], [4, 5, 6]])
    c = tmp_path / "c"
    c.write_text(">contig1\n0 3 12\n")
    np.testing.assert_array_equal(cs.read_cvg(str(c)), [0, 3, 12])
    st = tmp_path / "s"
    st.write_text(" - Manhattan distance: 12\n - Cosine distance: 0.25\n")
    assert cs.read_stats_distances(str(st)) == [12.0, 0.25]
    with pytest.raises(cs.SmokeError):
        cs.same("x", np.array([1, 2]), np.array([1, 3]))


def test_refuses_without_gpu():
    """On the CPU backend (no rehearsal option) the smoke fails and prints
    no success line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert not any(line.startswith("{") and json.loads(line).get("ok")
                   for line in r.stdout.splitlines())
