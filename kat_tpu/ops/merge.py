"""Bitonic merge of two sorted key streams — pure XLA, no sort.

`lax.sort` has no way to exploit pre-sortedness, so merging two sorted
streams through it costs a full comparator sort.  A bitonic *merge*
needs only log2(n) compare-exchange stages, each a pure elementwise
min/max pass: [A ascending | B descending] is bitonic, and each stage
halves the disorder scale.  Every stage is reshape + slice + select —
bandwidth-bound, no scatters/gathers.

The sort-merge join (ops/join.py) merges a sorted table with sorted
queries, or two sorted tables, through it.

Keys are tuples of uint32 words in lexicographic significance order (2 for
narrow, 4 for wide) with sentinel (all-ones) padding keys sorting last;
extra payload planes ride along with the swaps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.kmers import SENTINEL


def _lex_less(a_words, b_words):
    """a < b lexicographically over uint32 word tuples."""
    less = jnp.zeros(a_words[0].shape, jnp.bool_)
    eq = jnp.ones(a_words[0].shape, jnp.bool_)
    for a, b in zip(a_words, b_words):
        less = less | (eq & (a < b))
        eq = eq & (a == b)
    return less


def _pad_sentinel(words, payload, n: int):
    cur = words[0].shape[0]
    if cur == n:
        return list(words), list(payload)
    pad = n - cur
    words = [jnp.concatenate([x, jnp.full((pad,), SENTINEL, jnp.uint32)])
             for x in words]
    payload = [jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
               for x in payload]
    return words, payload


def merge_sorted(a_words, a_payload, b_words, b_payload):
    """Merge sorted streams A and B (ascending, sentinel-padded tails).

    a_words/b_words: tuples of uint32 key-word arrays (same word count);
    a_payload/b_payload: tuples of equal-length payload arrays (same count
    and dtypes on both sides).  Returns (words, payload) of length
    next_pow2(len(A) + len(B)) with sentinel/zero padding at the tail.
    """
    n_words = len(a_words)
    na, nb = a_words[0].shape[0], b_words[0].shape[0]
    n = 1 << int(np.ceil(np.log2(max(na + nb, 2))))
    # Pad the tail of B (ascending + all-ones padding stays ascending),
    # then reverse it: [A asc | B desc] is bitonic for any split point.
    a_words, a_payload = _pad_sentinel(a_words, a_payload, na)
    b_words, b_payload = _pad_sentinel(b_words, b_payload, n - na)
    planes = [jnp.concatenate([a, b[::-1]])
              for a, b in zip(list(a_words) + list(a_payload),
                              list(b_words) + list(b_payload))]

    s = n // 2
    while s >= 1:
        shaped = [p.reshape(-1, 2, s) for p in planes]
        top = [p[:, 0, :] for p in shaped]
        bot = [p[:, 1, :] for p in shaped]
        swap = _lex_less(bot[:n_words], top[:n_words])
        planes = [
            jnp.stack([jnp.where(swap, b, t), jnp.where(swap, t, b)],
                      axis=1).reshape(-1)
            for t, b in zip(top, bot)]
        # one kernel per stage: each reads two positions of the last, so
        # fused stages would recompute 2^stages inputs per element
        planes = list(jax.lax.optimization_barrier(planes))
        s //= 2
    return tuple(planes[:n_words]), tuple(planes[n_words:])
