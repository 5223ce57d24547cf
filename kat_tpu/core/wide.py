"""Wide-key (k in (31, 127]) count tables: multi-word keys, same
sort+segmented-reduce engine as core/counting.py.

The reference's mer_dna holds k-mers in arrays of 64-bit words
(mer_dna.hpp), supporting arbitrary k; this module extends the engine past
the packed-u64 path with keys as words_for_k(k) uint32 words (big-first):
4 for k <= 63, 6 for k <= 95, 8 for k <= 127.  The flush is one variadic
`lax.sort` over all key planes plus the weight, so the wide path shares
all design decisions with the narrow one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .counting import _run_totals
from .kmers import (N_WORDS_WIDE, SENTINEL, extract_kmers_wide,
                    words_for_k)


class WideTable(NamedTuple):
    """Sorted unique-key table with multi-word keys (big-first tuple)."""
    words: tuple
    counts: jax.Array
    n_unique: jax.Array

    @property
    def capacity(self) -> int:
        return self.words[0].shape[0]

    @property
    def n_words(self) -> int:
        return len(self.words)


def empty_table(capacity: int, n_words: int = 4) -> WideTable:
    s = jnp.full((capacity,), SENTINEL, jnp.uint32)
    return WideTable((s,) * n_words, jnp.zeros((capacity,), jnp.uint32),
                     jnp.zeros((), jnp.int32))


def _unique_reduce_wide(words, w, out_size: int):
    """Multi-word-key variant of counting._unique_reduce (same derivation)."""
    n = words[0].shape[0]
    *ws_sorted, w_s = jax.lax.sort((*words, w), num_keys=len(words))

    nxt_same = jnp.ones((n - 1,), jnp.bool_)
    for wd in ws_sorted:
        nxt_same = nxt_same & (wd[:-1] == wd[1:])
    is_last = jnp.concatenate([~nxt_same, jnp.ones((1,), jnp.bool_)])
    running = jnp.cumsum(w_s.astype(jnp.uint32), dtype=jnp.uint32)

    real = jnp.zeros((n,), jnp.bool_)
    for wd in ws_sorted:
        real = real | (wd != SENTINEL)
    keep = is_last & real
    ckey = [jnp.where(keep, wd, SENTINEL) for wd in ws_sorted]
    crun = jnp.where(keep, running, 0)

    *ckey, crun = jax.lax.sort((*ckey, crun), num_keys=len(ckey))
    n_unique = jnp.sum(keep.astype(jnp.int32))
    cw = _run_totals(crun, n_unique)

    if out_size < n:
        ckey = [c[:out_size] for c in ckey]
        cw = cw[:out_size]
    elif out_size > n:
        pad = out_size - n
        ckey = [jnp.concatenate([c, jnp.full((pad,), SENTINEL, jnp.uint32)])
                for c in ckey]
        cw = jnp.concatenate([cw, jnp.zeros((pad,), jnp.uint32)])
    return (*ckey, cw, n_unique)


_unique_reduce_wide_jit = jax.jit(_unique_reduce_wide, static_argnums=2)


@jax.jit
def lookup_wide(table: WideTable, qwords) -> jax.Array:
    """Vectorized lexicographic binary search over the sorted wide table."""
    shape = qwords[0].shape
    qs = [q.reshape(-1) for q in qwords]
    cap = table.capacity
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1

    lo_idx = jnp.zeros(qs[0].shape, jnp.int32)
    hi_idx = jnp.full(qs[0].shape, cap, jnp.int32)
    twords = table.words

    def body(_, carry):
        lo_i, hi_i = carry
        mid = (lo_i + hi_i) // 2
        less = jnp.zeros_like(lo_i, jnp.bool_)
        eq = jnp.ones_like(lo_i, jnp.bool_)
        for tw, q in zip(twords, qs):
            m = tw[mid]
            less = less | (eq & (m < q))
            eq = eq & (m == q)
        return jnp.where(less, mid + 1, lo_i), jnp.where(less, hi_i, mid)

    lo_idx, hi_idx = jax.lax.fori_loop(0, steps, body, (lo_idx, hi_idx))
    pos = jnp.minimum(lo_idx, cap - 1)
    found = lo_idx < cap
    for tw, q in zip(twords, qs):
        found = found & (tw[pos] == q)
    out = jnp.where(found, table.counts[pos], 0).astype(jnp.uint32)
    return out.reshape(shape)


class WideCodeStreamingCounter:
    """CodeStreamingCounter for wide keys: fused extract+reduce flush.

    Shares counting.CodeStreamingCounter's optimistic-commit INVARIANT:
    `.table` is only guaranteed valid after `finish()`/`current_table()`
    (the last flush's overflow check is deferred one flush)."""

    def __init__(self, k: int, canonical: bool = True,
                 initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_batches: int = 16):
        self.k = k
        self.canonical = canonical
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.flush_batches = int(flush_batches)
        self.n_words = words_for_k(k)
        self.table = empty_table(self.capacity, self.n_words)
        self._codes: list = []
        self._shape: tuple | None = None
        self._flush_fns: dict = {}
        # deferred overflow check — see counting.CodeStreamingCounter
        self._unchecked: tuple | None = None

    def add_codes(self, codes) -> None:
        if not isinstance(codes, jax.Array):
            codes = np.asarray(codes, np.uint8)
        if codes.ndim != 2:
            raise ValueError("expected [rows, length] code batch")
        if self._shape is not None and codes.shape[1] != self._shape[1]:
            self._flush()
        if self._shape is None or codes.shape[0] != self._shape[0]:
            if self._shape is not None:
                rows = self._shape[0]
                if codes.shape[0] > rows:
                    self._flush()
                    self._shape = codes.shape
                else:
                    codes = jnp.concatenate([
                        jnp.asarray(codes),
                        jnp.full((rows - codes.shape[0], codes.shape[1]),
                                 255, jnp.uint8)])
            else:
                self._shape = codes.shape
        self._codes.append(jax.device_put(codes))
        if len(self._codes) >= self.flush_batches:
            self._flush()

    def _flush_fn(self, b: int, rows: int, length: int, cap: int):
        key = (b, rows, length, cap)
        if key not in self._flush_fns:
            k = self.k
            canonical = self.canonical

            @jax.jit
            def fused(t: WideTable, codes):
                with jax.named_scope("extract"):
                    words, valid = extract_kmers_wide(
                        codes.reshape(-1, length), k, canonical)
                with jax.named_scope("merge_table"):
                    cat = [jnp.concatenate([tw, wd.reshape(-1)])
                           for tw, wd in zip(t.words, words)]
                    cw = jnp.concatenate(
                        [t.counts, valid.reshape(-1).astype(jnp.uint32)])
                return _unique_reduce_wide(tuple(cat), cw, cap)

            self._flush_fns[key] = fused
        return self._flush_fns[key]

    def _flush(self) -> None:
        if not self._codes:
            return
        rows, length = self._shape
        b = len(self._codes)
        # see counting.CodeStreamingCounter._flush: exact steady-state shape
        if b == self.flush_batches:
            target_b = b
        else:
            target_b = min(1 << max(0, int(np.ceil(np.log2(b)))),
                           self.flush_batches)
        pad = [jnp.full((rows, length), 255, jnp.uint8)] * (target_b - b)
        stack = jnp.stack(self._codes + pad)
        self._codes = []
        self._shape = None
        self._check_overflow()
        fn = self._flush_fn(target_b, rows, length, self.capacity)
        *ws, cw, n_unique = fn(self.table, stack)
        # optimistic commit; overflow check deferred one flush so the host
        # never blocks on n_unique mid-stream (counting.py has the full
        # rationale)
        self._unchecked = (self.table, stack, target_b, rows, length)
        self.table = WideTable(tuple(ws), cw, n_unique)
        n_unique.copy_to_host_async()

    def _grow(self) -> None:
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
            from .counting import TableFullError

            raise TableFullError(
                f"Count table full at capacity {self.capacity}")
        self.capacity *= 2

    def _check_overflow(self) -> None:
        if self._unchecked is None:
            return
        prev, stack, target_b, rows, length = self._unchecked
        self._unchecked = None
        while int(self.table.n_unique) > self.capacity:
            self._grow()
            prev = _grow_table(prev, self.capacity)
            fn = self._flush_fn(target_b, rows, length, self.capacity)
            *ws, cw, n_unique = fn(prev, stack)
            self.table = WideTable(tuple(ws), cw, n_unique)

    def device_sync(self) -> int:
        """See counting.CodeStreamingCounter.device_sync."""
        return int(self.table.n_unique)

    def current_table(self) -> WideTable:
        """Checked mid-stream accessor (see counting.CodeStreamingCounter
        .current_table)."""
        self._check_overflow()
        return self.table

    def finish(self) -> WideTable:
        self._flush()
        self._check_overflow()
        return self.table


def _grow_table(t: WideTable, capacity: int) -> WideTable:
    pad = capacity - t.capacity
    s = jnp.full((pad,), SENTINEL, jnp.uint32)
    return WideTable(
        tuple(jnp.concatenate([w, s]) for w in t.words),
        jnp.concatenate([t.counts, jnp.zeros((pad,), jnp.uint32)]),
        t.n_unique)


def table_words_to_numpy(t: WideTable):
    """(words [n, n_words] uint32 big-first, counts [n] uint32) — vectorized
    host export of the real entries (no per-key python loop)."""
    n = int(t.n_unique)
    words = np.stack([np.asarray(w[:n], np.uint32) for w in t.words], axis=1)
    counts = np.asarray(t.counts[:n], np.uint32)
    return words, counts


def table_to_numpy(t: WideTable):
    """(python-int keys list, counts) — keys exceed uint64 so stay ints.

    Vectorized to uint64 word-pairs; only the final big-int assembly is a
    (cheap) python comprehension over pre-combined halves."""
    words, counts = table_words_to_numpy(t)
    if words.shape[1] % 2:  # odd word counts (3-word path): zero-extend
        words = np.concatenate(
            [np.zeros((words.shape[0], 1), np.uint32), words], axis=1)
    w64 = words.astype(np.uint64)
    halves = [(w64[:, i] << np.uint64(32)) | w64[:, i + 1]
              for i in range(0, words.shape[1], 2)]
    keys = [_join_halves([int(h[i]) for h in halves])
            for i in range(len(counts))]
    return keys, counts


def _join_halves(hs) -> int:
    v = 0
    for h in hs:
        v = (v << 64) | h
    return v


def table_from_words(words: np.ndarray, counts: np.ndarray,
                     capacity: int | None = None,
                     n_words: int | None = None) -> WideTable:
    """Build a wide table from host ([n, n_words] uint32 big-first words,
    counts); keys need not be sorted or unique (duplicates are summed)."""
    words = np.asarray(words, np.uint32)
    if words.ndim != 2:
        words = words.reshape(-1, n_words or N_WORDS_WIDE)
    nw = words.shape[1]
    counts = np.asarray(counts, np.uint32)
    cap = capacity or max(1, words.shape[0])
    wt = tuple(jnp.asarray(words[:, i]) for i in range(nw))
    out = _unique_reduce_wide_jit(wt, jnp.asarray(counts), cap)
    return WideTable(tuple(out[:nw]), out[nw], out[nw + 1])


def ints_to_words(keys, n_words: int = N_WORDS_WIDE) -> np.ndarray:
    """Python-int keys -> [n, n_words] uint32 big-first words."""
    keys = list(keys)
    ws = np.zeros((len(keys), n_words), np.uint32)
    for i, kk in enumerate(keys):
        for wi in range(n_words):
            ws[i, wi] = (kk >> (32 * (n_words - 1 - wi))) & 0xFFFFFFFF
    return ws


def table_from_ints(keys, counts, capacity: int | None = None,
                    n_words: int = N_WORDS_WIDE) -> WideTable:
    """Build a wide table from python-int keys (host-side)."""
    words = ints_to_words(keys, n_words)
    counts = np.asarray(counts, np.uint32)
    cap = capacity or max(1, words.shape[0])
    return table_from_words(words, counts, cap)
