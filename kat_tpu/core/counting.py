"""Sort + segment-reduce k-mer counting: the data-parallel replacement for
jellyfish's lock-free CAS hash (reference:
deps/jellyfish-2.2.0/include/jellyfish/large_hash_array.hpp `add`/`claim_key`
and hash_counter.hpp `cooperative::hash_counter`).

Design: a count table is a *sorted* (by 64-bit key, as (hi, lo) uint32 pairs)
fixed-capacity array of unique keys plus uint32 counts.  Building it is a
`lax.sort` (num_keys=2, carries the weight operand) followed by a segmented
reduce; merging two tables (or a table and a fresh batch) is the same op on
the concatenation.  Deterministic, functional, static-shape — every step is
a plain `lax`/`jax.numpy` program that XLA compiles for the device.

Capacity policy: the reference doubles its hash cooperatively when full
(hash_counter.hpp:204-244); here the host wrapper doubles the static capacity
and re-runs the (cached-per-capacity) jitted merge when `n_unique` exceeds
capacity — same observable behaviour, no device-side mutation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import SENTINEL


class CountTable(NamedTuple):
    """Sorted unique-key count table.

    keys_hi/keys_lo: [capacity] uint32, ascending by (hi, lo); padding slots
      (beyond n_unique) hold the SENTINEL key.
    counts: [capacity] uint32, 0 in padding slots.
    n_unique: scalar int32 — number of real entries.
    """
    keys_hi: jax.Array
    keys_lo: jax.Array
    counts: jax.Array
    n_unique: jax.Array

    @property
    def capacity(self) -> int:
        return self.keys_hi.shape[0]


def empty_table(capacity: int) -> CountTable:
    return CountTable(
        keys_hi=jnp.full((capacity,), SENTINEL, jnp.uint32),
        keys_lo=jnp.full((capacity,), SENTINEL, jnp.uint32),
        counts=jnp.zeros((capacity,), jnp.uint32),
        n_unique=jnp.zeros((), jnp.int32),
    )


def _run_totals(running: jax.Array, n_unique: jax.Array) -> jax.Array:
    """Per-run weight totals from compacted running totals.

    `running` holds, in key order, the running total of the sorted weights
    at the last element of each kept run (the first n_unique entries) and
    0 after them.  Only the sentinel run, which sorts last, is dropped, so
    consecutive entries are consecutive runs and each run's total is the
    difference of its running total and the one before (u32, exact mod
    2^32 like the counts themselves).
    """
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), running[:-1]])
    live = jnp.arange(running.shape[0]) < n_unique
    return jnp.where(live, running - prev, 0).astype(jnp.uint32)


def _unique_reduce(hi, lo, w, out_size: int):
    """Sort flat (hi, lo, w) and reduce duplicate keys by summing weights.

    Returns a CountTable-shaped tuple of size `out_size`.  Sentinel keys sort
    last; their weights must be 0 so they are indistinguishable from padding.

    The run-last entries are *compacted* to the front by a second sort whose
    key is the element key for run-lasts and the sentinel for everything
    else, carrying the running total (one cumsum) of the sorted weights;
    `_run_totals` turns those into per-run totals.  Net: 2 sorts + 1 cumsum,
    no scatter or gather.
    """
    n = hi.shape[0]
    with jax.named_scope("sort"):
        hi_s, lo_s, w_s = jax.lax.sort((hi, lo, w), num_keys=2)

    with jax.named_scope("scan"):
        nxt_same = (hi_s[:-1] == hi_s[1:]) & (lo_s[:-1] == lo_s[1:])
        is_last = jnp.concatenate([~nxt_same, jnp.ones((1,), jnp.bool_)])
        running = jnp.cumsum(w_s.astype(jnp.uint32), dtype=jnp.uint32)

    with jax.named_scope("compact"):
        real = ~((hi_s == SENTINEL) & (lo_s == SENTINEL))
        keep = is_last & real
        chi = jnp.where(keep, hi_s, SENTINEL)
        clo = jnp.where(keep, lo_s, SENTINEL)
        crun = jnp.where(keep, running, 0)
        chi, clo, crun = jax.lax.sort((chi, clo, crun), num_keys=2)
        n_unique = jnp.sum(keep.astype(jnp.int32))
        cw = _run_totals(crun, n_unique)

    if out_size == n:
        return chi, clo, cw, n_unique
    if out_size < n:
        return chi[:out_size], clo[:out_size], cw[:out_size], n_unique
    pad = out_size - n
    return (jnp.concatenate([chi, jnp.full((pad,), SENTINEL, jnp.uint32)]),
            jnp.concatenate([clo, jnp.full((pad,), SENTINEL, jnp.uint32)]),
            jnp.concatenate([cw, jnp.zeros((pad,), jnp.uint32)]),
            n_unique)


@functools.partial(jax.jit, static_argnames=("out_size",))
def count_batch(hi: jax.Array, lo: jax.Array, valid: jax.Array,
                out_size: int | None = None) -> CountTable:
    """Count one batch of extracted k-mers into a fresh table.

    hi/lo/valid: any (matching) shape; flattened internally.  out_size
    defaults to the number of windows (worst case all-distinct).
    """
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    w = valid.reshape(-1).astype(jnp.uint32)
    out = out_size or hi.shape[0]
    return CountTable(*_unique_reduce(hi, lo, w, out))


@functools.partial(jax.jit, static_argnames=("capacity",))
def merge_tables(a: CountTable, b: CountTable,
                 capacity: int | None = None) -> CountTable:
    """Merge two count tables; output capacity defaults to capA + capB.

    The caller must check `n_unique <= capacity` afterwards (host-side grow
    policy lives in StreamingCounter).
    """
    cap = capacity or (a.capacity + b.capacity)
    hi = jnp.concatenate([a.keys_hi, b.keys_hi])
    lo = jnp.concatenate([a.keys_lo, b.keys_lo])
    w = jnp.concatenate([a.counts, b.counts])
    return CountTable(*_unique_reduce(hi, lo, w, cap))


@functools.partial(jax.jit, static_argnames=("capacity",))
def absorb_batch(table: CountTable, hi: jax.Array, lo: jax.Array,
                 valid: jax.Array, capacity: int) -> CountTable:
    """table <- table + one batch of raw k-mers, output capacity `capacity`."""
    bhi = hi.reshape(-1)
    blo = lo.reshape(-1)
    bw = valid.reshape(-1).astype(jnp.uint32)
    chi = jnp.concatenate([table.keys_hi, bhi])
    clo = jnp.concatenate([table.keys_lo, blo])
    cw = jnp.concatenate([table.counts, bw])
    return CountTable(*_unique_reduce(chi, clo, cw, capacity))


class TableFullError(RuntimeError):
    pass


class CodeStreamingCounter:
    """Streaming counter over raw 2-bit code batches with a fully fused
    flush: window extraction + canonical pack + sort + segmented reduce run
    as ONE jitted program per ~16 batches.

    Compared to StreamingCounter (which extracts per batch), this removes
    per-batch dispatch latency and lets XLA fuse extraction into the sort's
    first pass.  Batches must share one [rows, length] shape (the native
    reader emits uniform batches); the stack is padded to the next
    power-of-two batch count so compiled shapes stay few.

    INVARIANT: `.table` is only guaranteed valid after `finish()` (or
    `current_table()`).  Between flushes the overflow check of the LAST
    flush is deliberately deferred (optimistic commit, see `_flush`), so
    mid-stream `.table` may be silently truncated if that flush
    overflowed capacity; `current_table()` is the checked accessor for
    mid-stream readers.
    """

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
        self.table = empty_table(self.capacity)
        self._codes: list = []
        self._shape: tuple | None = None
        self._flush_fns: dict = {}
        # Deferred overflow check: (pre-flush table, stack, target_b, rows,
        # length) of the one flush whose n_unique has not been fetched yet.
        self._unchecked: tuple | None = None

    def add_codes(self, codes) -> None:
        if not isinstance(codes, jax.Array):
            codes = np.asarray(codes, np.uint8)
        if codes.ndim != 2:
            raise ValueError("expected [rows, length] code batch")
        if self._shape is not None and codes.shape[1] != self._shape[1]:
            self._flush()
        if self._shape is None or codes.shape[0] != self._shape[0]:
            # Row-pad to the first batch's row count (255 = invalid code).
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
            from .kmers import extract_kmers

            k = self.k
            canonical = self.canonical

            @jax.jit
            def fused(thi, tlo, tc, codes):
                with jax.named_scope("extract"):
                    hi, lo, valid = extract_kmers(
                        codes.reshape(-1, length), k, canonical)
                with jax.named_scope("merge_table"):
                    chi = jnp.concatenate([thi, hi.reshape(-1)])
                    clo = jnp.concatenate([tlo, lo.reshape(-1)])
                    cw = jnp.concatenate(
                        [tc, valid.reshape(-1).astype(jnp.uint32)])
                return _unique_reduce(chi, clo, cw, cap)

            self._flush_fns[key] = fused
        return self._flush_fns[key]

    def _flush(self) -> None:
        if not self._codes:
            return
        rows, length = self._shape
        b = len(self._codes)
        # Steady-state flushes (b == flush_batches) keep their exact batch
        # count — one standing compiled shape.  Only the final partial
        # flush pads to a power of two (log-many residual shapes).
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
        nhi, nlo, nc, n_unique = fn(
            self.table.keys_hi, self.table.keys_lo, self.table.counts,
            stack)
        # Optimistic commit: fetching n_unique here would idle the device
        # for a full dispatch round-trip per flush (the host can't run
        # ahead while it blocks on the scalar).  The overflow check is
        # deferred to the NEXT flush/finish, by which point the scalar is
        # already computed; on overflow the flush replays from the kept
        # pre-flush table at doubled capacity.
        self._unchecked = (self.table, stack, target_b, rows, length)
        self.table = CountTable(nhi, nlo, nc, n_unique)
        # start the scalar's device->host copy now, so that it overlaps
        # the next flush's work
        n_unique.copy_to_host_async()

    def _grow(self) -> None:
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
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
            nhi, nlo, nc, n_unique = fn(
                prev.keys_hi, prev.keys_lo, prev.counts, stack)
            self.table = CountTable(nhi, nlo, nc, n_unique)

    def device_sync(self) -> int:
        """Block until this counter's most recently scheduled device work
        completes by fetching its newest scalar.  Returns that scalar."""
        return int(self.table.n_unique)

    def current_table(self) -> CountTable:
        """The resident table with all deferred work settled — the safe
        mid-stream accessor (plain `.table` may be transiently truncated
        right after an overflowing flush)."""
        self._check_overflow()
        return self.table

    def finish(self) -> CountTable:
        self._flush()
        self._check_overflow()
        return self.table


def _grow_table(t: CountTable, capacity: int) -> CountTable:
    """A settled (sorted, unique) table padded with sentinel slots to
    `capacity` — no re-sort needed."""
    pad = capacity - t.capacity
    s = jnp.full((pad,), SENTINEL, jnp.uint32)
    return CountTable(jnp.concatenate([t.keys_hi, s]),
                      jnp.concatenate([t.keys_lo, s]),
                      jnp.concatenate([t.counts,
                                       jnp.zeros((pad,), jnp.uint32)]),
                      t.n_unique)


class StreamingCounter:
    """Host-side streaming accumulator with capacity doubling.

    Mirrors the observable behaviour of jellyfish's cooperative resize
    (hash_counter.hpp:204-244): when a merge would exceed capacity, capacity
    doubles and the merge re-runs (allowed unless `disable_grow`).

    Batches are buffered on device and the (expensive) sort+reduce against
    the resident table runs once per `flush_windows` k-mers instead of once
    per batch — the log-structured-merge idea, amortising the table's sort
    cost across many batches.  Buffers are padded to power-of-2 sizes so
    the number of distinct compiled shapes stays logarithmic.
    """

    def __init__(self, initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_windows: int = 1 << 25):
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.flush_windows = int(flush_windows)
        self.table = empty_table(self.capacity)
        self._pending: list = []
        self._pending_n = 0

    def _grow(self):
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
            raise TableFullError(
                f"Count table full at capacity {self.capacity}")
        self.capacity *= 2
        self.table = _grow_table(self.table, self.capacity)

    def add(self, hi, lo, valid):
        hi = hi.reshape(-1)
        lo = lo.reshape(-1)
        w = valid.reshape(-1).astype(jnp.uint32)
        if self._pending_n + hi.shape[0] > self.flush_windows:
            self._flush()
        self._pending.append((hi, lo, w))
        self._pending_n += int(hi.shape[0])
        if self._pending_n >= self.flush_windows:
            self._flush()

    def _flush(self):
        if not self._pending_n:
            return
        target = 1 << max(1, int(np.ceil(np.log2(self._pending_n))))
        target = min(target, max(self.flush_windows, self._pending_n))
        pad = target - self._pending_n
        parts = self._pending
        if pad:
            parts = parts + [(
                jnp.full((pad,), SENTINEL, jnp.uint32),
                jnp.full((pad,), SENTINEL, jnp.uint32),
                jnp.zeros((pad,), jnp.uint32))]
        hi = jnp.concatenate([p[0] for p in parts])
        lo = jnp.concatenate([p[1] for p in parts])
        w = jnp.concatenate([p[2] for p in parts])
        self._pending = []
        self._pending_n = 0
        while True:
            new = absorb_batch(self.table, hi, lo, w, self.capacity)
            n = int(new.n_unique)
            if n <= self.capacity:
                self.table = new
                return
            self._grow()

    def finish(self) -> CountTable:
        self._flush()
        return self.table


# ---------------------------------------------------------------------------
# Lookup: vectorized lower-bound binary search over the sorted table.  This is
# the analogue of large_hash_array.hpp:404-476 `get_key_id` random probing,
# but as log2(capacity) dense gather rounds (no pointer chasing).
# ---------------------------------------------------------------------------

@jax.jit
def lookup(table: CountTable, qhi: jax.Array, qlo: jax.Array) -> jax.Array:
    """Counts for query keys (0 where absent). Shapes of qhi/qlo preserved."""
    shape = qhi.shape
    qh = qhi.reshape(-1)
    ql = qlo.reshape(-1)
    cap = table.capacity
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1

    lo_idx = jnp.zeros(qh.shape, jnp.int32)
    hi_idx = jnp.full(qh.shape, cap, jnp.int32)

    def body(_, carry):
        lo_i, hi_i = carry
        mid = (lo_i + hi_i) // 2
        mh = table.keys_hi[mid]
        ml = table.keys_lo[mid]
        less = (mh < qh) | ((mh == qh) & (ml < ql))
        return jnp.where(less, mid + 1, lo_i), jnp.where(less, hi_i, mid)

    lo_idx, hi_idx = jax.lax.fori_loop(0, steps, body, (lo_idx, hi_idx))
    pos = jnp.minimum(lo_idx, cap - 1)
    found = (table.keys_hi[pos] == qh) & (table.keys_lo[pos] == ql) & (
        lo_idx < cap)
    out = jnp.where(found, table.counts[pos], 0).astype(jnp.uint32)
    return out.reshape(shape)


def table_to_numpy(table: CountTable):
    """(keys u64, counts u32) as host numpy arrays, real entries only."""
    n = int(table.n_unique)
    hi = np.asarray(table.keys_hi[:n], np.uint64)
    lo = np.asarray(table.keys_lo[:n], np.uint64)
    counts = np.asarray(table.counts[:n], np.uint32)
    return (hi << np.uint64(32)) | lo, counts


def table_from_numpy(keys: np.ndarray, counts: np.ndarray,
                     capacity: int | None = None) -> CountTable:
    """Build a device table from host (u64 keys, counts); keys need not be
    sorted or unique (duplicates are summed)."""
    keys = np.asarray(keys, np.uint64)
    counts = np.asarray(counts, np.uint32)
    cap = capacity or max(1, len(keys))
    hi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return CountTable(*_unique_reduce_jit(hi, lo, jnp.asarray(counts), cap))


# one compiled program per shape (op-by-op dispatch of the scan's dozens
# of small ops would compile each of them separately)
_unique_reduce_jit = jax.jit(_unique_reduce, static_argnums=3)
