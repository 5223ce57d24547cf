"""The sort + segmented-reduce core (core/counting._unique_reduce and the
wide core/wide._unique_reduce_wide) and the streaming counters built on it,
against dict / numpy oracles: run boundaries, sentinel padding, overflow
reporting, weight accumulation, multi-plane keys of every width the flush
uses, and the counters' flush cadence, growth replay and mid-stream reads."""

import random
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from kat_tpu.core import counting, wide
from kat_tpu.core.kmers import SENTINEL
from kat_tpu.io import fastx

S = int(SENTINEL)


def _oracle(cols, w):
    d = defaultdict(int)
    for row in zip(*[c.tolist() for c in cols], w.tolist()):
        key, ww = row[:-1], row[-1]
        if all(x == S for x in key):
            continue
        d[key] = (d[key] + ww) % (1 << 32)
    return sorted(d.items())


_narrow_reduce = jax.jit(counting._unique_reduce, static_argnums=3)
_wide_reduce = jax.jit(wide._unique_reduce_wide, static_argnums=2)


def _reduce(cols, w, out_size):
    cols = tuple(jnp.asarray(c) for c in cols)
    if len(cols) == 2:
        out = _narrow_reduce(cols[0], cols[1], jnp.asarray(w), out_size)
    else:
        out = _wide_reduce(cols, jnp.asarray(w), out_size)
    *got, nu = out
    return [np.asarray(c) for c in got], int(nu)


def _random_case(rng, n, nk, n_words=2, sent_frac=0.2, wmax=5):
    """Unsorted rows drawn from nk distinct keys, a sentinel share with
    zero weight (the padding contract)."""
    keys = rng.integers(0, nk, n)
    uniq = rng.integers(0, 1 << 32, (nk, n_words), dtype=np.uint64)
    cols = [uniq[keys, j].astype(np.uint32) for j in range(n_words)]
    w = rng.integers(0, wmax, n).astype(np.uint32)
    m = rng.random(n) < sent_frac
    for c in cols:
        c[m] = S
    w[m] = 0
    return cols, w


def _check(got, nu, want, n_words, out_size):
    assert nu == len(want)
    for j in range(n_words):
        assert got[j][:nu].tolist() == [k[j] for k, _ in want]
    assert got[n_words][:nu].tolist() == [v for _, v in want]
    assert all((g[nu:] == S).all() for g in got[:n_words])
    assert (got[n_words][nu:] == 0).all()
    assert got[0].shape == (out_size,)


@pytest.mark.parametrize("seed,n,nk", [
    (0, 100, 1), (1, 1023, 7), (2, 1024, 500), (3, 3001, 59),
    (4, 6000, 6000), (5, 40_000, 900),
])
def test_narrow_random_parity(seed, n, nk):
    rng = np.random.default_rng(seed)
    cols, w = _random_case(rng, n, nk)
    got, nu = _reduce(cols, w, n + 64)
    _check(got, nu, _oracle(cols, w), 2, n + 64)


@pytest.mark.parametrize("n_words", [3, 4, 6, 8])
def test_wide_random_parity(n_words):
    rng = np.random.default_rng(7 + n_words)
    cols, w = _random_case(rng, 3000, 40, n_words=n_words)
    got, nu = _reduce(cols, w, 3100)
    _check(got, nu, _oracle(cols, w), n_words, 3100)


@pytest.mark.parametrize("n_words,n", [
    (10, 1), (12, 2), (12, 2048), (16, 3001), (8, 1 << 14), (3, 4097),
])
def test_multi_plane_sort_widths(n_words, n):
    """Keys of 3..16 planes (k up to 255) with heavy ties and sentinel
    rows at arbitrary, non-power-of-two lengths: one variadic lax.sort
    must order every plane and keep weights with their keys."""
    rng = np.random.default_rng(n_words * 1000 + n)
    cols = [rng.integers(0, 3, n).astype(np.uint32) for _ in range(n_words)]
    w = rng.integers(1, 9, n).astype(np.uint32)
    sent = rng.random(n) < 0.1
    for c in cols:
        c[sent] = S
    w[sent] = 0
    got, nu = _reduce(cols, w, n)
    _check(got, nu, _oracle(cols, w), n_words, n)


@pytest.mark.parametrize("n_words", [2, 4])
def test_all_sentinel(n_words):
    n = 2048
    cols = [np.full(n, S, np.uint32) for _ in range(n_words)]
    got, nu = _reduce(cols, np.zeros(n, np.uint32), 256)
    assert nu == 0
    assert (got[0] == S).all() and (got[n_words] == 0).all()


@pytest.mark.parametrize("n_words", [2, 4])
def test_single_run_spans_whole_input(n_words):
    """One key repeated across the whole input: the run total is the
    full length and lands in slot 0."""
    n = 8 * 128 * 3 + 17
    cols = [np.full(n, 5 + j, np.uint32) for j in range(n_words)]
    got, nu = _reduce(cols, np.ones(n, np.uint32), 128)
    assert nu == 1
    assert [g[0] for g in got[:n_words]] == [5 + j for j in range(n_words)]
    assert got[n_words][0] == n


def test_no_sentinel_tail_exact_out_size():
    """Input with no sentinel rows and out_size == n: the last run ends at
    the array's end, not at a sentinel boundary."""
    n = 1024
    hi = np.repeat(np.arange(64, dtype=np.uint32), 16)[::-1].copy()
    lo = hi * 3
    got, nu = _reduce([hi, lo], np.ones(n, np.uint32), n)
    assert nu == 64
    assert got[2][:64].tolist() == [16] * 64
    assert got[0][63] == 63 and got[1][63] == 189


@pytest.mark.parametrize("n_words", [2, 4])
def test_overflow_reports_true_count(n_words):
    """out_size far below the distinct count: the table is truncated but
    n_unique reports the TRUE count, which is what the growth replay
    keys on."""
    rng = np.random.default_rng(3)
    cols, w = _random_case(rng, 4096, 600, n_words=n_words, sent_frac=0.0,
                           wmax=3)
    w[:] = np.maximum(w, 1)
    want = _oracle(cols, w)
    got, nu = _reduce(cols, w, 64)
    assert nu == len(want) > 64
    assert got[0].shape == (64,)
    assert got[n_words].tolist() == [v for _, v in want[:64]]


def test_count_accumulation_large_weights():
    """Run totals accumulate in uint32 and wrap mod 2**32."""
    n = 2048
    cols = [np.zeros(n, np.uint32), np.full(n, 2, np.uint32)]
    w = np.full(n, 1 << 20, np.uint32)
    got, nu = _reduce(cols, w, 128)
    assert nu == 1
    assert got[2][0] == (n << 20) % (1 << 32)


def test_count_batch_and_merge_tables_agree():
    """count_batch over a concatenation == merge_tables of the parts."""
    rng = np.random.default_rng(17)
    a = rng.integers(0, 300, 5000).astype(np.uint32)
    b = rng.integers(200, 500, 3000).astype(np.uint32)
    ta = counting.count_batch(jnp.asarray(a >> 5), jnp.asarray(a),
                              jnp.ones(a.shape, bool), out_size=1024)
    tb = counting.count_batch(jnp.asarray(b >> 5), jnp.asarray(b),
                              jnp.ones(b.shape, bool), out_size=1024)
    ab = np.concatenate([a, b])
    whole = counting.count_batch(jnp.asarray(ab >> 5), jnp.asarray(ab),
                                 jnp.ones(ab.shape, bool), out_size=2048)
    merged = counting.merge_tables(ta, tb)
    for x, y in zip(merged, whole):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _random_codes(rng, rows, length):
    codes = rng.integers(0, 4, (rows, length)).astype(np.uint8)
    codes[rng.random((rows, length)) < 0.02] = 255  # invalid bases
    return codes


def _code_seqs(batches):
    return ["".join("ACGT"[c] if c < 4 else "N" for c in row)
            for b in batches for row in b]


def _narrow_dict(t):
    keys, counts = counting.table_to_numpy(t)
    return dict(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("flush_batches", [1, 2, 3, 7])
def test_code_counter_flush_cadence(flush_batches):
    """Any flush cadence (one flush per batch, partial pow2-padded tails,
    one flush for everything) gives the oracle's table."""
    rng = np.random.default_rng(8)
    batches = [_random_codes(rng, 8, 64) for _ in range(7)]
    sc = counting.CodeStreamingCounter(
        9, canonical=True, initial_capacity=1 << 10,
        flush_batches=flush_batches)
    for b in batches:
        sc.add_codes(b)
    assert _narrow_dict(sc.finish()) == dict(
        oracle.count_seqs(_code_seqs(batches), 9))


def test_code_counter_growth_replay():
    """A tiny initial capacity forces deferred overflow checks to replay
    flushes at doubled capacity, several doublings deep."""
    rng = np.random.default_rng(13)
    batches = [_random_codes(rng, 16, 64) for _ in range(4)]
    sc = counting.CodeStreamingCounter(
        11, canonical=True, initial_capacity=1 << 6, flush_batches=1,
        max_capacity=1 << 14)
    for b in batches:
        sc.add_codes(b)
    got = _narrow_dict(sc.finish())
    assert sc.capacity >= 1 << 10
    assert got == dict(oracle.count_seqs(_code_seqs(batches), 11))


def test_code_counter_disable_grow_raises():
    rng = np.random.default_rng(14)
    sc = counting.CodeStreamingCounter(
        11, canonical=True, initial_capacity=1 << 6, flush_batches=1,
        disable_grow=True)
    with pytest.raises(counting.TableFullError):
        for _ in range(3):
            sc.add_codes(_random_codes(rng, 16, 64))
        sc.finish()


def test_current_table_settles_pending_overflow():
    """After an overflowing flush `.table` is truncated until the deferred
    check runs; current_table() settles it mid-stream."""
    rng = np.random.default_rng(15)
    batches = [_random_codes(rng, 16, 64) for _ in range(2)]
    sc = counting.CodeStreamingCounter(
        9, canonical=True, initial_capacity=1 << 6, flush_batches=1)
    for b in batches:
        sc.add_codes(b)
    assert sc._unchecked is not None
    mid = _narrow_dict(sc.current_table())
    assert sc._unchecked is None
    assert mid == dict(oracle.count_seqs(_code_seqs(batches), 9))


@pytest.mark.parametrize("k,initial_capacity", [(41, 1 << 9), (41, 1 << 5),
                                                (63, 1 << 7)])
def test_wide_code_counter_matches_oracle(k, initial_capacity):
    """The wide fused flush, with and without growth replays."""
    rng = np.random.default_rng(k + initial_capacity)
    batches = [_random_codes(rng, 4, 96) for _ in range(5)]
    sc = wide.WideCodeStreamingCounter(
        k, canonical=True, initial_capacity=initial_capacity,
        flush_batches=2)
    for b in batches:
        sc.add_codes(b)
    keys, counts = wide.table_to_numpy(sc.finish())
    assert dict(zip(keys, counts.tolist())) == dict(
        oracle.count_seqs(_code_seqs(batches), k))


def test_wide_current_table_settles_pending_overflow():
    rng = np.random.default_rng(21)
    batches = [_random_codes(rng, 4, 96) for _ in range(3)]
    sc = wide.WideCodeStreamingCounter(
        41, canonical=True, initial_capacity=1 << 4, flush_batches=1)
    for b in batches:
        sc.add_codes(b)
    keys, counts = wide.table_to_numpy(sc.current_table())
    assert dict(zip(keys, counts.tolist())) == dict(
        oracle.count_seqs(_code_seqs(batches), 41))


def test_counter_irregular_batch_rows():
    """Batches with fewer rows than the first are row-padded with invalid
    codes, taller ones start a new flush shape; counts stay exact."""
    rng = random.Random(3)
    nrng = np.random.default_rng(3)
    batches = [_random_codes(nrng, rng.choice([3, 8, 16]), 64)
               for _ in range(9)]
    sc = counting.CodeStreamingCounter(
        13, canonical=True, initial_capacity=1 << 8, flush_batches=2)
    for b in batches:
        sc.add_codes(b)
    assert _narrow_dict(sc.finish()) == dict(
        oracle.count_seqs(_code_seqs(batches), 13))


def test_counter_encoded_fastx_batches():
    """Batches from the python encoder (seams repeated across rows)."""
    rng = random.Random(5)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(20, 300)))
            for _ in range(40)]
    recs = [fastx.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    sc = counting.CodeStreamingCounter(
        17, canonical=True, initial_capacity=1 << 8, flush_batches=3)
    for b in fastx.encode_batches(iter(recs), 17, target_codes=1 << 10):
        sc.add_codes(np.asarray(b))
    assert _narrow_dict(sc.finish()) == dict(oracle.count_seqs(seqs, 17))
