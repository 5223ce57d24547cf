"""Property sweep: random sequence sets at boundary k values must count
identically to the oracle through the full Input.count machinery (native
reader when available, fused flush, growth)."""

import random

import pytest

import oracle
from kat_tpu.core import counting, wide
from kat_tpu.tools.common import Input


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


def _table_dict(table, k):
    if isinstance(table, wide.WideTable):
        keys, counts = wide.table_to_numpy(table)
        return dict(zip(keys, counts.tolist()))
    keys, counts = counting.table_to_numpy(table)
    return dict(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32, 33, 48, 63])
def test_count_boundary_k(tmp_path, k):
    rng = random.Random(k * 131)
    seqs = []
    for _ in range(25):
        n = rng.randint(max(k, 2), max(k + 50, 120))
        seqs.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.08 else "ACGT")
            for _ in range(n)))
    # adversarial extras: homopolymers, palindromes, exact-k sequences
    seqs.append("A" * (k + 9))
    seqs.append("ACGT" * ((k + 3) // 4 + 2))
    seqs.append("G" * k)
    fa = tmp_path / "f.fa"
    _write_fasta(fa, seqs)

    inp = Input(paths=[str(fa)])
    inp.mer_len = k
    inp.hash_size = 2048  # force growth on some k
    inp.validate()
    inp.count(quiet=True)
    got = _table_dict(inp.table, k)
    want = dict(oracle.count_seqs(seqs, k))
    assert got == want, f"k={k}"


@pytest.mark.parametrize("k", [5, 27, 33])
def test_count_python_reader_fallback(tmp_path, k, monkeypatch):
    """The pure-Python bucketed reader + StreamingCounter path (used when
    the native library is unavailable) must agree with the oracle."""
    monkeypatch.setenv("KAT_TPU_NO_NATIVE", "1")
    rng = random.Random(k * 7)
    seqs = ["".join(rng.choice("ACGTN" if rng.random() < 0.05 else "ACGT")
                    for _ in range(rng.randint(k, k + 80)))
            for _ in range(20)]
    fa = tmp_path / "f.fa"
    _write_fasta(fa, seqs)
    inp = Input(paths=[str(fa)])
    inp.mer_len = k
    inp.hash_size = 4096
    inp.validate()
    inp.count(quiet=True)
    got = _table_dict(inp.table, k)
    want = dict(oracle.count_seqs(seqs, k))
    assert got == want


@pytest.mark.parametrize("k", [5, 31, 33])
def test_count_non_canonical_boundary(tmp_path, k):
    rng = random.Random(k)
    seqs = ["".join(rng.choice("ACGT") for _ in range(k + 40))
            for _ in range(10)]
    fa = tmp_path / "f.fa"
    _write_fasta(fa, seqs)
    inp = Input(paths=[str(fa)])
    inp.mer_len = k
    inp.canonical = False
    inp.hash_size = 4096
    inp.validate()
    inp.count(quiet=True)
    got = _table_dict(inp.table, k)
    want = dict(oracle.count_seqs(seqs, k, canonical=False))
    assert got == want


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_join_fuzz_random_tables_and_queries(seed):
    """Random (table, query) pairs through the join and the binary
    search must agree exactly — sizes chosen to land on and off the
    sort/merge padding boundaries."""
    import numpy as np

    import jax.numpy as jnp

    from kat_tpu.core import counting
    from kat_tpu.ops.join import counts_join

    rng = np.random.default_rng(seed)
    n_keys = int(rng.integers(3, 700))
    cap = int(rng.integers(n_keys, 2 * n_keys + 64))
    m = int(rng.integers(1, 1500))
    keys = np.unique(rng.integers(1, 1 << 40, size=n_keys * 2,
                                  dtype=np.uint64))[:n_keys]
    cnts = rng.integers(1, 10_000, size=len(keys)).astype(np.uint32)
    table = counting.table_from_numpy(keys, cnts, capacity=cap)

    q = rng.choice(
        np.concatenate([keys,
                        rng.integers(1, 1 << 40, size=m,
                                     dtype=np.uint64)]), size=m)
    sent = rng.random(m) < 0.05
    q[sent] = np.uint64(0xFFFFFFFFFFFFFFFF)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    ref = np.asarray(counting.lookup(table, qhi, qlo))
    tw = (table.keys_hi, table.keys_lo)
    got = np.asarray(counts_join(tw, table.counts, (qhi, qlo)))
    np.testing.assert_array_equal(got, ref, err_msg=(
        f"seed={seed} n={n_keys} cap={cap} m={m}"))
