"""`kat comp` parity tests against a pure-Python oracle of
src/comp.cc:366-484 compareSlice + lib/src/comp_counters.cc, including the
pass-2 always-canonical quirk (SURVEY §5.1.2)."""

import math
import random

import numpy as np
import pytest

import oracle
from kat_tpu.tools.comp import Comp


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">seq{i}\n{s}\n")


def _scale(c, scale, bins):
    s = 0 if c == 0 else math.ceil(c * scale)
    return min(s, bins - 1)


def _spec_update(spec, c):
    n = len(spec)
    spec[0 if c <= 0 else (n - 1 if c >= n else c)] += 1


def _oracle_comp(seqs1, seqs2, k, d1_bins, d2_bins, d1_scale=1.0,
                 d2_scale=1.0, canonical1=True, canonical2=True):
    c1 = oracle.count_seqs(seqs1, k, canonical1)
    c2 = oracle.count_seqs(seqs2, k, canonical2)
    dm = min(d1_bins, d2_bins)
    mx = np.zeros((d1_bins, d2_bins), np.uint64)
    ctr = dict(hash1_total=0, hash2_total=0, hash1_distinct=0,
               hash2_distinct=0, hash1_only_total=0, hash2_only_total=0,
               hash1_only_distinct=0, hash2_only_distinct=0,
               shared_hash1_total=0, shared_hash2_total=0, shared_distinct=0)
    sp1 = [0] * dm
    sp2 = [0] * dm
    ssp1 = [0] * dm
    ssp2 = [0] * dm
    for key, h1 in c1.items():
        # pass 1 probe of hash2 honours hash2's canonical flag
        q = min(key, oracle.revcomp(key, k)) if canonical2 else key
        h2 = c2.get(q, 0)
        ctr["hash1_total"] += h1
        ctr["hash1_distinct"] += 1
        _spec_update(sp1, h1)
        if not h2:
            ctr["hash1_only_total"] += h1
            ctr["hash1_only_distinct"] += 1
        if h1 and h2:
            ctr["shared_hash1_total"] += h1
            ctr["shared_hash2_total"] += h2
            ctr["shared_distinct"] += 1
            _spec_update(ssp1, h1)
            _spec_update(ssp2, h2)
        mx[_scale(h1, d1_scale, d1_bins), _scale(h2, d2_scale, d2_bins)] += 1
    for key, h2 in c2.items():
        # pass 2 probe of hash1 is ALWAYS canonical (comp.cc:447 bug)
        q = min(key, oracle.revcomp(key, k))
        h1 = c1.get(q, 0)
        ctr["hash2_total"] += h2
        ctr["hash2_distinct"] += 1
        _spec_update(sp2, h2)
        if not h1:
            ctr["hash2_only_total"] += h2
            ctr["hash2_only_distinct"] += 1
            mx[0, _scale(h2, d2_scale, d2_bins)] += 1
    return ctr, mx, sp1, sp2, ssp1, ssp2


@pytest.fixture
def seq_sets():
    rng = random.Random(7)

    def mk(n, seed_extra):
        r = random.Random(seed_extra)
        out = []
        for _ in range(n):
            ln = r.randint(15, 60)
            out.append("".join(r.choice("ACGT") for _ in range(ln)))
        return out

    base = mk(30, 1)
    set1 = base + mk(15, 2)
    set2 = base[:20] + mk(15, 3)
    rng.shuffle(set1)
    return set1, set2


def _run_comp(tmp_path, seqs1, seqs2, k, d1_bins=101, d2_bins=101,
              canonical1=True, canonical2=True, d1_scale=1.0, d2_scale=1.0):
    fa1 = tmp_path / "a.fa"
    fa2 = tmp_path / "b.fa"
    _write_fasta(fa1, seqs1)
    _write_fasta(fa2, seqs2)
    c = Comp([str(fa1)], [str(fa2)])
    c.quiet = True
    c.d1_bins = d1_bins
    c.d2_bins = d2_bins
    c.d1_scale = d1_scale
    c.d2_scale = d2_scale
    c.set_mer_len(k)
    c.inputs[0].canonical = canonical1
    c.inputs[1].canonical = canonical2
    for inp in c.inputs:
        inp.hash_size = 4096
    c.output_prefix = str(tmp_path / "out")
    c.execute()
    return c


@pytest.mark.parametrize("k", [9])
def test_comp_counters_and_matrix(tmp_path, seq_sets, k):
    s1, s2 = seq_sets
    c = _run_comp(tmp_path, s1, s2, k)
    ctr, mx, sp1, sp2, ssp1, ssp2 = _oracle_comp(s1, s2, k, 101, 101)
    for key, want in ctr.items():
        assert c.counters[key] == want, key
    np.testing.assert_array_equal(c.main_mx.data, mx)
    np.testing.assert_array_equal(c.spectrum1, np.asarray(sp1, np.uint64))
    np.testing.assert_array_equal(c.spectrum2, np.asarray(sp2, np.uint64))
    np.testing.assert_array_equal(c.shared_spectrum1,
                                  np.asarray(ssp1, np.uint64))
    np.testing.assert_array_equal(c.shared_spectrum2,
                                  np.asarray(ssp2, np.uint64))


def test_comp_non_canonical_pass2_quirk(tmp_path, seq_sets):
    """hash1 non-canonical: pass-2 lookups into hash1 still canonicalize
    (the reference pointer-as-bool bug)."""
    s1, s2 = seq_sets
    k = 9
    c = _run_comp(tmp_path, s1, s2, k, canonical1=False)
    ctr, mx, *_ = _oracle_comp(s1, s2, k, 101, 101, canonical1=False)
    for key, want in ctr.items():
        assert c.counters[key] == want, key
    np.testing.assert_array_equal(c.main_mx.data, mx)


def test_comp_scaling(tmp_path, seq_sets):
    s1, s2 = seq_sets
    k = 9
    c = _run_comp(tmp_path, s1, s2, k, d1_bins=11, d2_bins=7,
                  d1_scale=0.5, d2_scale=0.25)
    ctr, mx, *_ = _oracle_comp(s1, s2, k, 11, 7, d1_scale=0.5, d2_scale=0.25)
    for key, want in ctr.items():
        assert c.counters[key] == want, key
    np.testing.assert_array_equal(c.main_mx.data, mx)


def test_comp_stats_file(tmp_path, seq_sets):
    s1, s2 = seq_sets
    c = _run_comp(tmp_path, s1, s2, 9)
    c.output_hists = True
    c.save()
    stats = open(str(c.output_prefix) + ".stats").read()
    assert "K-mer statistics for: " in stats
    assert f" - Hash 1: {c.counters['hash1_total']}" in stats
    assert "Manhattan distance: " in stats
    assert "Jaccard distance: " in stats
    hist1 = open(str(c.output_prefix) + ".1.hist").read().splitlines()
    body = [ln for ln in hist1 if ln and not ln.startswith("#")]
    assert body[0].startswith("0 ")
    assert len(body) == 101


@pytest.mark.parametrize("canonical1", [True, False],
                         ids=["sorted-probes", "unsorted-probes"])
def test_comp_join_lookup_matches_default(tmp_path, seq_sets, monkeypatch,
                                          canonical1):
    """comp with the sort-merge-join lookups forced (KAT_TPU_JOIN=1) is
    bit-identical to the binary-search run.  canonical inputs take the
    sorted-probe fast path (pass1/2 queries are a sorted table's own
    keys — no query sort); a non-canonical hash1 makes pass1's
    canonicalized probe stream unsorted and must fall back to the general
    join."""
    s1, s2 = seq_sets
    k = 9
    (tmp_path / "ref").mkdir()
    (tmp_path / "join").mkdir()
    want = _run_comp(tmp_path / "ref", s1, s2, k, canonical1=canonical1)

    monkeypatch.setenv("KAT_TPU_JOIN", "1")
    got = _run_comp(tmp_path / "join", s1, s2, k, canonical1=canonical1)
    assert got.counters == want.counters
    np.testing.assert_array_equal(got.main_mx.data, want.main_mx.data)
    np.testing.assert_array_equal(got.spectrum1, want.spectrum1)
    np.testing.assert_array_equal(got.spectrum2, want.spectrum2)
    np.testing.assert_array_equal(got.shared_spectrum1,
                                  want.shared_spectrum1)
    np.testing.assert_array_equal(got.shared_spectrum2,
                                  want.shared_spectrum2)
