"""Uniform operations over narrow (CountTable, k<=31) and wide (WideTable,
k<=63) count tables, so tool engines stay single-source."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from . import counting, kmers, wide


def is_wide(table) -> bool:
    return isinstance(table, wide.WideTable)


def key_words(table):
    """Big-first uint32 word tuple of the table's keys."""
    if is_wide(table):
        return table.words
    return (table.keys_hi, table.keys_lo)


def real_mask(table) -> jax.Array:
    """True for slots holding a real key (non-sentinel)."""
    m = None
    for w in key_words(table):
        s = w != kmers.SENTINEL
        m = s if m is None else (m | s)
    return m


def _join_policy() -> bool:
    """Route a bulk lookup through the sort-merge join (ops/join.py)
    instead of the binary search?  KAT_TPU_JOIN=1 selects the join; the
    binary search is the default until a measurement on the card says
    otherwise (ROADMAP S4)."""
    return os.environ.get("KAT_TPU_JOIN") == "1"


def lookup(table, qwords, assume_sorted: bool = False) -> jax.Array:
    """Counts for query keys given as a word tuple matching the table.

    The vectorized binary search answers by default; KAT_TPU_JOIN=1 routes
    bulk queries through the sort-merge join (ops/join.py).

    assume_sorted=True promises the flattened queries are already in
    ascending key order (e.g. they are another sorted table's keys) —
    the join then skips its query sort.  Ignored by the binary-search
    path, which is order-independent.
    """
    if _join_policy():
        from ..ops.join import counts_join

        return counts_join(key_words(table), table.counts, tuple(qwords),
                           queries_sorted=assume_sorted)
    if is_wide(table):
        return wide.lookup_wide(table, qwords)
    return counting.lookup(table, qwords[0], qwords[1])


def lookup_dual(t_a, t_b):
    """Counts of each table's keys in the OTHER table through one merge
    (ops/join.counts_join_dual) — comp's pass-1/2 cross probes fused.

    Returns (b_counts_for_a_keys, a_counts_for_b_keys) aligned with each
    table's capacity, or None when the join is not selected (callers fall
    back to two independent lookups)."""
    if not _join_policy():
        return None
    from ..ops.join import counts_join_dual

    return counts_join_dual(key_words(t_a), t_a.counts,
                            key_words(t_b), t_b.counts)


def compact(table, min_capacity: int = 1 << 17):
    """Host-side shrink of a FINISHED table to the smallest pow2 capacity
    holding its real entries (sorted layout: real rows are a prefix).

    Probing a table whose capacity doubled past its final fill wastes
    work on padding (a binary-search step, or a join pass over the whole
    capacity); tools call this once before their lookup loops."""
    n = int(table.n_unique)
    cap = table.counts.shape[0]
    tgt = max(min_capacity, 1 << max(0, int(np.ceil(np.log2(max(n, 1))))))
    if tgt >= cap:
        return table
    if is_wide(table):
        return wide.WideTable(tuple(w[:tgt] for w in table.words),
                              table.counts[:tgt], table.n_unique)
    return counting.CountTable(table.keys_hi[:tgt], table.keys_lo[:tgt],
                               table.counts[:tgt], table.n_unique)


def canonicalize(qwords, k: int):
    """min(key, revcomp) over a word tuple (sentinel-preserving)."""
    if len(qwords) == 2:
        return kmers.canonicalize(qwords[0], qwords[1], k)
    return kmers.canonicalize_words(qwords, k)


def gc_count(qwords) -> jax.Array:
    if len(qwords) == 2:
        return kmers.gc_count(qwords[0], qwords[1])
    return kmers.gc_count_words(qwords)


def extract(codes, k: int, canonical: bool):
    """(words, valid) for any supported k."""
    if k <= kmers.MAX_K:
        hi, lo, valid = kmers.extract_kmers(codes, k, canonical)
        return (hi, lo), valid
    words, valid = kmers.extract_kmers_wide(codes, k, canonical)
    return words, valid


def counts_array(table) -> jax.Array:
    return table.counts


def gc_of_keys(table) -> jax.Array:
    """GC count per table slot (garbage at sentinel slots; mask with
    real_mask)."""
    return gc_count(key_words(table))


def n_unique(table) -> jax.Array:
    return table.n_unique


def where_real(table, values, fill=0):
    return jnp.where(real_mask(table), values, fill)
