"""Sort-merge-join point lookups: an alternative bulk-query engine for the
analysis phase (sect / cold / comp probes / filter-seq profiles).

The reference serves its second hot loop — random point probes into a
shared hash (src/comp.cc:401-404,447, src/sect.cc:536,
src/filter_sequence.cc:363) — with a prefetched O(1) probe
(deps/jellyfish-2.2.0/include/jellyfish/large_hash_array.hpp:404-476
`get_key_id`).  The default here is a vectorized binary search
(core/counting.lookup): log2(cap) rounds of random gathers per query.
This module answers the same queries with streaming passes only:

1. sort the queries by key (original position riding as a payload),
2. bitonic-MERGE them with the resident sorted table (ops/merge.py),
   table rows carrying (count, idx=SENTINEL), queries (0, idx),
3. propagate each equal-key run's unique table count to every run member
   with a doubling windowed max (counts are >=1 for real table rows, 0
   everywhere else, and table keys are unique — so the run max IS the
   answer; no stability assumption on the merge is needed),
4. un-permute with ONE 2-plane sort by idx and slice the query rows back
   out (merge padding sorts to the front with idx 0, table rows to the
   back with idx SENTINEL).

Cost is ~O((n_table + m) log) streaming work instead of m random-probe
chains.  Which engine wins on the GPU is an open measurement; the join is
selected with KAT_TPU_JOIN=1 (core/tables.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.kmers import SENTINEL


def _run_max_multi(words, cs):
    """Max of each plane in cs over each run of equal keys (lexicographic
    word tuples), via Hillis-Steele window doubling: after step t every
    element holds the max over a radius-(2^t - 1) window clipped to its
    run.  log2(n) elementwise passes, no gathers; the run-reachability
    plane is computed once and shared by every count plane."""
    cs = list(cs)
    n = cs[0].shape[0]
    eq = jnp.ones((n - 1,), jnp.bool_)
    for w in words:
        eq = eq & (w[1:] == w[:-1])
    # reach[i] at distance d: key[i] == key[i-d] (runs are contiguous)
    reach = jnp.concatenate([jnp.zeros((1,), jnp.bool_), eq])
    d = 1
    while d < n:
        rb = jnp.concatenate([reach[d:], jnp.zeros((d,), jnp.bool_)])
        for i, c in enumerate(cs):
            zc = jnp.zeros((d,), c.dtype)
            cl = jnp.concatenate([zc, c[:-d]])
            cr = jnp.concatenate([c[d:], zc])
            cs[i] = jnp.maximum(c, jnp.maximum(jnp.where(reach, cl, 0),
                                               jnp.where(rb, cr, 0)))
        if 2 * d < n:
            reach = reach & jnp.concatenate(
                [jnp.zeros((d,), jnp.bool_), reach[:-d]])
        # one kernel per pass: each reads two positions of the last, so
        # fused passes would recompute 2^passes inputs per element
        cs, reach = jax.lax.optimization_barrier((cs, reach))
        d *= 2
    return cs


def _run_max(words, c):
    return _run_max_multi(words, (c,))[0]


@functools.partial(jax.jit, static_argnames=("queries_sorted",))
def counts_join(twords, tcounts, qwords,
                queries_sorted: bool = False) -> jax.Array:
    """Counts for query keys against a sorted unique-key table.

    twords: tuple of uint32 key-word planes, ascending lexicographic,
      sentinel-key padding at the tail (counts 0 there).
    tcounts: uint32 counts aligned with twords.
    qwords: query key-word planes (any matching shape); sentinel-key
      queries return 0.  Returns uint32 counts in the queries' shape.

    queries_sorted=True asserts the flattened queries are ALREADY in
    ascending lexicographic key order (sentinel queries therefore at the
    tail) and skips the query sort.  comp's probe streams are another
    sorted table's own keys, so its pass-1/2 joins ride this for free
    (src/comp.cc:401-404,447 walks hash1/hash2 in iteration order)."""
    from .merge import merge_sorted

    n_words = len(twords)
    shape = qwords[0].shape
    qs = tuple(q.reshape(-1).astype(jnp.uint32) for q in qwords)
    m = qs[0].shape[0]
    if m == 0:
        return jnp.zeros(shape, jnp.uint32)
    n_t = twords[0].shape[0]
    idx = jnp.arange(1, m + 1, dtype=jnp.uint32)
    tidx = jnp.full((n_t,), SENTINEL, jnp.uint32)
    zcnt = jnp.zeros((m,), jnp.uint32)

    if queries_sorted:
        # already key-ordered; idx (ascending) is a valid tiebreak as-is
        sq = qs + (idx,)
    else:
        sq = jax.lax.sort(qs + (idx,), num_keys=n_words)

    mw, mp = merge_sorted(twords, (tcounts, tidx),
                          sq[:n_words], (zcnt, sq[n_words]))
    mcnt, midx = mp
    big_n = mw[0].shape[0]
    c = _run_max(mw, mcnt)

    si, sc = jax.lax.sort((midx, c), num_keys=1)
    # ascending idx: [merge padding idx=0 | queries idx 1..m | table
    # rows idx=SENTINEL]; the merge's pad count is static.
    front = big_n - n_t - m
    out = sc[front:front + m].astype(jnp.uint32)
    return out.reshape(shape)


@jax.jit
def counts_join_dual(awords, acounts, bwords, bcounts):
    """Counts of each sorted unique-key table's keys in the OTHER table,
    through ONE merge.

    comp's pass 1 probes hash2 with hash1's keys and pass 2 probes hash1
    with hash2's keys (src/comp.cc:401-404,447); since both probe streams
    are the tables' own sorted keys, a single bitonic merge of the two
    tables answers BOTH directions: every equal-key run holds at most one
    row of each table (keys are unique per table), so the run max of each
    table's count plane is the other table's answer.  A source plane
    (1=a, 2=b, 0=merge padding) drives two stable compactions whose
    stream order is each table's own sorted order — no query sorts, no
    un-permutes.

    Returns (b_counts_for_a_keys [len(a)], a_counts_for_b_keys [len(b)]),
    uint32; sentinel (padding) rows get 0.
    """
    from .merge import merge_sorted

    na = awords[0].shape[0]
    nb = bwords[0].shape[0]
    a_payload = (acounts, jnp.zeros((na,), jnp.uint32),
                 jnp.ones((na,), jnp.uint32))
    b_payload = (jnp.zeros((nb,), jnp.uint32), bcounts,
                 jnp.full((nb,), 2, jnp.uint32))
    mw, mp = merge_sorted(awords, a_payload, bwords, b_payload)

    mca, mcb, msrc = mp
    ra, rb = _run_max_multi(mw, (mca, mcb))

    # stable sort by NOT-kept moves each table's rows to the front in
    # stream (= that table's key) order
    _f, sa = jax.lax.sort(((msrc != 1).astype(jnp.uint32), rb),
                          num_keys=1)
    _g, sb = jax.lax.sort(((msrc != 2).astype(jnp.uint32), ra),
                          num_keys=1)
    return sa[:na].astype(jnp.uint32), sb[:nb].astype(jnp.uint32)
