"""Sequence parallelism for very long contigs: halo-exchanged window
coverage over a device mesh.

The reference streams multi-Mbp contigs through 4KB chunks with a
(k-1)-char seam so no window is lost
(mer_overlap_sequence_parser.hpp:44-52) and interlaces sequences over
threads (sect.cc:480-486).  The data-parallel analogue (SURVEY §2.5 P8 /
§5 long-context): a contig's base stream is split into contiguous spans,
one per device; each device receives the first (k-1) bases of the NEXT span
via `ppermute` (the seam reborn as a ring halo exchange), extracts its
windows, and queries a replicated count table locally.  Per-span coverage
vectors concatenate into the contig's full per-base profile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import kmers
from ..core.counting import CountTable, lookup


@functools.partial(jax.jit, static_argnames=("k", "canonical", "mesh"))
def _halo_counts(table: CountTable, codes: jax.Array, k: int,
                 canonical: bool, mesh: Mesh):
    axis = mesh.axis_names[0]
    n = int(np.prod(mesh.devices.shape))
    span = codes.shape[0] // n

    def body(codes_l, thi, tlo, tc):
        table_l = CountTable(thi, tlo, tc, jnp.zeros((), jnp.int32))
        # Ring halo: my left edge goes to my left neighbour, so every
        # device receives the first (k-1) bases of the NEXT span.  The last
        # span receives span 0's edge (wrapped); its affected windows fall
        # beyond L-k+1 and are sliced off by the caller.
        edge = jax.lax.slice_in_dim(codes_l.reshape(-1), 0, k - 1)
        halo = jax.lax.ppermute(
            edge, axis, perm=[(i, (i - 1) % n) for i in range(n)])
        ext = jnp.concatenate([codes_l.reshape(-1), halo])
        hi, lo, valid = kmers.extract_kmers(ext[None], k, canonical=False)
        if canonical:
            qh, ql = kmers.canonicalize(hi, lo, k)
        else:
            qh, ql = hi, lo
        counts = lookup(table_l, qh, ql)
        counts = jnp.where(valid, counts, 0)
        gc = jnp.where(valid, kmers.gc_count(hi, lo).astype(jnp.int32), -1)
        return counts.reshape(1, -1), gc.reshape(1, -1)

    spec = P(axis, None)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec, P(), P(), P()),
        out_specs=(spec, spec),
        check_vma=False)
    return fn(codes.reshape(n, span), table.keys_hi, table.keys_lo,
              table.counts)


def sharded_window_profile(table: CountTable, codes: np.ndarray, k: int,
                           canonical: bool, mesh: Mesh
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Per-window (counts, gc) of one long 2-bit-coded sequence, computed
    with one span per mesh device and a (k-1) ring halo.

    codes: [L] uint8 codes (>=4 invalid).  Returns two [L - k + 1] arrays:
    uint32 counts (0 for invalid windows) and int32 GC (-1 for invalid).
    """
    codes = np.asarray(codes, np.uint8)
    L = codes.shape[0]
    if L < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    n = int(np.prod(mesh.devices.shape))
    span = -(-L // n)  # ceil
    pad = n * span - L
    padded = np.concatenate([codes, np.full(pad, 255, np.uint8)])
    counts, gc = _halo_counts(table, jnp.asarray(padded), k, canonical,
                              mesh)
    nw = L - k + 1
    return (np.asarray(counts).reshape(-1)[:nw],
            np.asarray(gc).reshape(-1)[:nw])


def sharded_window_counts(table: CountTable, codes: np.ndarray, k: int,
                          canonical: bool, mesh: Mesh) -> np.ndarray:
    """Counts-only convenience wrapper over sharded_window_profile."""
    return sharded_window_profile(table, codes, k, canonical, mesh)[0]


# ---------------------------------------------------------------------------
# Routed halo path: sequence parallelism WITHOUT table replication.  Each
# device extracts the windows of its span (ring halo for the (k-1) seam as
# above) and answers them via shard-routed lookups into the mesh-resident
# sharded table (P6 + P8 combined) — at real scale a 10^9-entry table
# cannot be replicated per device.  Narrow and wide keys both supported.
# ---------------------------------------------------------------------------


def _halo_routed_body(codes_l, *targs, k: int, canonical: bool, n: int,
                      qcap: int, axis_names, n_words: int):
    from ..core import tables as _tables
    from .analysis import _local_table, _routed_counts_local

    t = _local_table(n_words, targs)
    edge = jax.lax.slice_in_dim(codes_l.reshape(-1), 0, k - 1)
    halo = jax.lax.ppermute(
        edge, axis_names, perm=[(i, (i - 1) % n) for i in range(n)])
    ext = jnp.concatenate([codes_l.reshape(-1), halo])
    words, valid = _tables.extract(ext[None], k, canonical=False)
    q = _tables.canonicalize(words, k) if canonical else words
    counts, dropped = _routed_counts_local(
        t, tuple(w.reshape(-1) for w in q), n, qcap, k, axis_names)
    counts = jnp.where(valid.reshape(-1), counts, 0)
    gc = jnp.where(valid,
                   _tables.gc_count(words).astype(jnp.int32), -1)
    return counts.reshape(1, -1), gc.reshape(1, -1), dropped


@functools.partial(jax.jit,
                   static_argnames=("k", "canonical", "qcap", "n_words",
                                    "mesh"))
def _halo_routed(codes, *targs, k: int, canonical: bool, qcap: int,
                 n_words: int, mesh: Mesh):
    axis_names = tuple(mesh.axis_names)
    n = int(np.prod(mesh.devices.shape))
    span = codes.shape[0] // n
    # multi-axis meshes route over the flattened device space, matching
    # ShardedCounter's table layout
    first = axis_names if len(axis_names) > 1 else axis_names[0]
    spec = P(first, None)
    nspec = P(first)
    body = functools.partial(
        _halo_routed_body, k=k, canonical=canonical, n=n, qcap=qcap,
        axis_names=axis_names, n_words=n_words)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec,) + (spec,) * (n_words + 1) + (nspec,),
        out_specs=(spec, spec, P()),
        check_vma=False)
    return fn(codes.reshape(n, span), *targs)


def sharded_window_profile_routed(counter, codes: np.ndarray, k: int,
                                  canonical: bool
                                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-window (counts, gc) of one long sequence against a live
    ShardedCounter: spans + ring halo for extraction, all_to_all-routed
    lookups for the counts (reference sect.cc:527-541 random probes; the
    table stays sharded)."""
    codes = np.asarray(codes, np.uint8)
    L = codes.shape[0]
    if L < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    mesh = counter.mesh
    n = counter.n
    span = -(-L // n)  # ceil
    pad = n * span - L
    padded = jnp.asarray(np.concatenate(
        [codes, np.full(pad, 255, np.uint8)]))
    targs = (*counter.twords, counter.tc, counter.n_unique)
    # each span holds `span` windows; with the canonical-hash balance a
    # 4x slack over the uniform share is plenty (retried on overflow)
    qcap = max(1, min(span, int(np.ceil(span / n * 4.0))))
    while True:
        counts, gc, dropped = _halo_routed(
            padded, *targs, k=k, canonical=canonical, qcap=qcap,
            n_words=counter.n_words, mesh=mesh)
        if int(dropped) == 0:
            break
        if qcap >= span:
            raise RuntimeError("routed halo lookup cannot converge")
        qcap = min(span, qcap * 2)
    nw = L - k + 1
    return (np.asarray(counts).reshape(-1)[:nw],
            np.asarray(gc).reshape(-1)[:nw])
