"""Distributed analysis phase: comp/gcp/hist over mesh-sharded tables.

The reference runs its analysis slice-parallel over ONE shared hash with
random probes into the others (src/comp.cc:366-484 compareSlice,
src/gcp.cc:179-197 analyseSlice).  Here the tables never leave the mesh:
every input is counted with the same canonical-hash partition function
(parallel/sharded.py `owner_shard`), so a key and every probe derived from
it (raw, reverse-complement, canonicalized) live on the same shard in
every table.  Cross-hash probes therefore become *local* binary-search
joins on co-partitioned shards, and all counters / spectra / matrices are
exact integer reductions merged with `psum` — no host-side table merge at
any point (SURVEY §7 step 6, §2.5 P4/P6).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..core import comp_engine, stats
from ..core.counting import CountTable
from ..core.kmers import SENTINEL
from ..core.wide import WideTable
from .collectives import psum_exact
from .sharded import ShardedCounter, owner_shard


def _local_row_data(arr) -> np.ndarray:
    """This process's rows of a row-sharded global array, in row order.

    Multi-process counterpart of np.asarray(arr): a [n, w] array with
    spec P(axis, None) has one addressable shard per LOCAL device; stitch
    them back together in global row order."""
    pieces = {}
    for s in arr.addressable_shards:
        start = s.index[0].start or 0
        if start not in pieces:
            pieces[start] = np.asarray(s.data)
    return np.concatenate([pieces[i] for i in sorted(pieces)], axis=0)


def _table_args(c: ShardedCounter):
    """Flatten a counter's sharded arrays into shard_map arguments."""
    return (*c.twords, c.tc, c.n_unique)


def _local_table(n_words: int, args):
    """Rebuild the local shard's table view inside a shard_map body.

    args: n_words word slices [1, cap] + counts [1, cap] + n_unique [1].
    """
    words = [a[0] for a in args[:n_words]]
    counts = args[n_words][0]
    nu = args[n_words + 1][0]
    if n_words == 2:
        return CountTable(words[0], words[1], counts, nu)
    return WideTable(tuple(words), counts, nu)


def _specs_for(c: ShardedCounter):
    spec = c._tspec
    nspec = P(spec[0])
    return (spec,) * (c.n_words + 1) + (nspec,)


def comp_sharded(c1: ShardedCounter, c2: ShardedCounter,
                 c3: ShardedCounter | None, *, k: int, d1_bins: int,
                 d2_bins: int, dm_size: int, d1_scale: float,
                 d2_scale: float, canon2: bool, canon3: bool,
                 sorted1: bool = False, sorted2: bool = False,
                 sorted3: bool = False):
    """All three comp passes with the tables left sharded on the mesh.

    Returns the same host-side structures as the single-table passes
    (counters dict, spectra, matrices) — byte-identical by construction:
    co-partitioning makes each shard's probes exact, and the psum merges
    are integer sums of disjoint shard contributions.
    """
    for c in (c1, c2, c3):
        if c is not None:
            c.check()
    mesh = c1.mesh
    axis_names = tuple(mesh.axis_names)
    three = c3 is not None
    nw = c1.n_words

    counters = [c for c in (c1, c2, c3) if c is not None]
    in_specs = tuple(s for c in counters for s in _specs_for(c))
    args = tuple(a for c in counters for a in _table_args(c))
    n_args = nw + 2

    def body(*flat):
        t1 = _local_table(nw, flat[:n_args])
        t2 = _local_table(nw, flat[n_args:2 * n_args])
        t3 = _local_table(nw, flat[2 * n_args:]) if three else None

        # each shard's table slice is itself sorted with sentinel tail,
        # so the sorted-probe promises hold per shard exactly as they do
        # for the single table — including the fused pass1+pass2 cross
        # probe (one local merge per shard; co-partitioning makes every
        # cross-key local)
        from ..core import tables as _tables

        pre = (_tables.lookup_dual(t1, t2)
               if (sorted2 and sorted1) else None)
        h2_pre, h1_pre = pre if pre is not None else (None, None)
        outs1 = comp_engine.pass1(
            t1, t2, t3, k=k, d1_bins=d1_bins, d2_bins=d2_bins,
            dm_size=dm_size, d1_scale=d1_scale, d2_scale=d2_scale,
            canon2=canon2, canon3=canon3, three=three,
            sorted2=sorted2, sorted3=sorted3, h2_pre=h2_pre)
        outs2 = comp_engine.pass2(t2, t1, k=k, d2_bins=d2_bins,
                                  dm_size=dm_size, d2_scale=d2_scale,
                                  sorted1=sorted1, h1_pre=h1_pre)
        outs3 = comp_engine.pass3(t3) if three else {}
        tree = (outs1[:5] + (outs1[5:] if three else ()), outs2, outs3)
        return psum_exact(tree, axis_names)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=(P(), P(), P()), check_vma=False)
    outs1, outs2, outs3 = jax.jit(fn)(*args)
    if not three:
        outs1 = outs1 + (None, None, None)
    return outs1, outs2, outs3


def gcp_sharded(c: ShardedCounter, mer_len: int, cvg_bins: int,
                cvg_scale: float = 1.0) -> np.ndarray:
    """GC x coverage matrix per shard + psum (reference gcp.cc:179-197)."""
    c.check()
    axis_names = tuple(c.mesh.axis_names)
    nw = c.n_words

    def body(*flat):
        t = _local_table(nw, flat)
        grid = stats.gcp_matrix(t, mer_len, cvg_bins, cvg_scale)
        return psum_exact(grid, axis_names)

    fn = shard_map(body, mesh=c.mesh, in_specs=_specs_for(c),
                   out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(fn)(*_table_args(c)), np.uint64)


def hist_sharded(c: ShardedCounter, base: int, ceil_: int, inc: int,
                 nb_buckets: int) -> np.ndarray:
    """Occurrence histogram per shard + psum (P3/P4)."""
    return c.histogram(base, ceil_, inc, nb_buckets)


# ---------------------------------------------------------------------------
# P6: shard-routed point lookups.  Queries are routed to the shard owning
# their canonical form with all_to_all, answered by a local binary-search
# join against that shard's slice, and routed back to their source
# positions.  This is the mesh analogue of the reference's random probes
# into a shared hash (src/sect.cc:527-541) without ever replicating or
# gathering the table.
# ---------------------------------------------------------------------------


def _route_queries_local(qwords, n_dest: int, qcap: int, k: int):
    """Sort local queries by owner shard into [n_dest, qcap] buffers,
    carrying the original position so answers can be unpermuted."""
    m = qwords[0].shape[0]
    dest = owner_shard(qwords, k, n_dest)
    sent = jnp.ones(qwords[0].shape, jnp.bool_)
    for w in qwords:
        sent = sent & (w == SENTINEL)
    dest = jnp.where(sent, n_dest, dest)  # park sentinel queries
    idx = jnp.arange(m, dtype=jnp.uint32)
    d_s, *qs_s, idx_s = jax.lax.sort((dest, *qwords, idx), num_keys=1)

    pos_in = jnp.arange(m, dtype=jnp.int32)
    is_first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                d_s[1:] != d_s[:-1]])
    seg_start = jnp.where(is_first, pos_in, 0)
    d = 1
    while d < m:
        seg_start = jnp.maximum(
            seg_start,
            jnp.concatenate([jnp.zeros((d,), jnp.int32), seg_start[:-d]]))
        d *= 2
    pos = pos_in - seg_start

    in_range = (pos < qcap) & (d_s < n_dest)
    target = jnp.where(in_range, d_s * qcap + pos, n_dest * qcap)
    bufs = [jnp.full((n_dest * qcap,), SENTINEL, jnp.uint32).at[target].set(
        q, mode="drop").reshape(n_dest, qcap) for q in qs_s]
    # invalid marker for unused slots: index m (out of range)
    buf_idx = jnp.full((n_dest * qcap,), m, jnp.uint32).at[target].set(
        idx_s, mode="drop").reshape(n_dest, qcap)
    dropped = jnp.sum(((~in_range) & (d_s < n_dest)).astype(jnp.int64))
    return bufs, buf_idx, dropped


def _routed_counts_local(t, qwords, n_dest: int, qcap: int, k: int,
                         axis_names):
    """Inside a shard_map body: answer arbitrary local queries against the
    mesh-sharded table.  Queries go to the shard owning their canonical
    form (all_to_all), are answered by a local binary search, and ride
    back with their source position.  Returns ([m] uint32 counts,
    psum'd dropped count)."""
    qwords = tuple(q.reshape(-1) for q in qwords)
    m = qwords[0].shape[0]

    bufs, buf_idx, dropped = _route_queries_local(qwords, n_dest, qcap, k)
    rq = [jax.lax.all_to_all(b, axis_names, 0, 0, tiled=True) for b in bufs]
    ridx = jax.lax.all_to_all(buf_idx, axis_names, 0, 0, tiled=True)

    from ..core import tables as _tables

    counts = _tables.lookup(t, tuple(r.reshape(-1) for r in rq))
    counts = counts.reshape(n_dest, qcap)

    # answers ride back with their original index
    back_c = jax.lax.all_to_all(counts, axis_names, 0, 0, tiled=True)
    back_i = jax.lax.all_to_all(ridx, axis_names, 0, 0, tiled=True)
    flat_c = back_c.reshape(-1)
    flat_i = back_i.reshape(-1).astype(jnp.int32)
    out = jnp.zeros((m,), jnp.uint32).at[flat_i].set(flat_c, mode="drop")
    dropped = psum_exact(dropped, axis_names)
    return out, dropped


def _lookup_step_local(*flat, n_words: int, n_dest: int, qcap: int, k: int,
                       axis_names):
    qwords = flat[:n_words]
    t = _local_table(n_words, flat[n_words:])
    out, dropped = _routed_counts_local(t, qwords, n_dest, qcap, k,
                                        axis_names)
    return out[None], dropped


class ShardedLookup:
    """Batch point-lookup service over a live ShardedCounter (P6).

    Queries of any shape are flattened, padded across the mesh's devices,
    routed to owner shards, answered locally, and returned in the callers'
    layout.  Sentinel queries return 0.
    """

    def __init__(self, counter: ShardedCounter):
        counter.check()
        self.c = counter
        self._fns: dict = {}

    def _fn(self, per_dev: int, qcap: int):
        key = (per_dev, qcap)
        if key not in self._fns:
            c = self.c
            spec = c._tspec
            body = functools.partial(
                _lookup_step_local, n_words=c.n_words, n_dest=c.n,
                qcap=qcap, k=c.k, axis_names=c.axis_names)
            fn = shard_map(
                body, mesh=c.mesh,
                in_specs=(spec,) * c.n_words + _specs_for(c),
                out_specs=(spec, P()), check_vma=False)
            self._fns[key] = jax.jit(fn)
        return self._fns[key]

    def _plan_qcap(self, qs: list, per_dev: int,
                   n_rows: int | None = None) -> int:
        """EXACT routing capacity from a host-side pass over the queries:
        the largest (source device, owner shard) bucket, rounded up to a
        power of two so compiled shapes stay logarithmic.  This replaces
        the old guess-and-double loop, whose every doubling recompiled
        the routed-lookup program —
        pathological query skew now costs at most ONE compile per
        (per_dev, pow2-qcap) pair and never a retry.

        `n_rows` is how many device rows `qs` covers — the full mesh in a
        single-controller run, this process's local devices in a
        multi-process run (bucket identity only needs LOCAL row distinctness;
        the global max is agreed by allgather in the caller)."""
        from ..parallel.sharded import owner_shard_np

        c = self.c
        n_rows = c.n if n_rows is None else n_rows
        real = np.zeros(qs[0].shape, np.bool_)
        for q in qs:
            real |= q != SENTINEL
        dest = owner_shard_np(tuple(qs), c.k, c.n).astype(np.int64)
        src = np.repeat(np.arange(n_rows, dtype=np.int64), per_dev)
        flat = np.where(real, src * c.n + dest, n_rows * c.n)
        counts = np.bincount(flat, minlength=n_rows * c.n + 1)[:n_rows * c.n]
        need = int(counts.max()) if counts.size else 1
        qcap = 1 << max(0, int(np.ceil(np.log2(max(need, 1)))))
        return max(1, min(qcap, per_dev))

    def lookup(self, qwords) -> np.ndarray:
        """Counts for query word arrays (any matching shape).

        In a multi-process (multi-host) run this is a COLLECTIVE: every
        process must call it in lockstep, each passing its OWN local
        queries (local shapes may differ per process), and each receives
        the counts for exactly its own queries.  The padded per-device
        query width and the routing capacity are agreed globally (two
        tiny allgathers per call), so the compiled program is identical
        on every process."""
        if jax.process_count() > 1:
            return self._lookup_multiprocess(qwords)
        c = self.c
        shape = qwords[0].shape
        qs = [np.asarray(q, np.uint32).reshape(-1) for q in qwords]
        m = qs[0].shape[0]
        per_dev = -(-max(m, 1) // c.n)
        total = per_dev * c.n
        qs = [np.concatenate([q, np.full((total - m,), SENTINEL,
                                         np.uint32)]) for q in qs]
        qcap = self._plan_qcap(qs, per_dev)
        while True:
            fn = self._fn(per_dev, qcap)
            qdev = [jax.device_put(
                jnp.asarray(q.reshape(c.n, per_dev)), c._tsharding)
                for q in qs]
            out, dropped = fn(*qdev, *_table_args(c))
            if int(dropped) == 0:
                break
            # safety net only — the exact plan above should never drop
            qcap = min(per_dev, qcap * 2)
        res = np.asarray(out, np.uint32).reshape(-1)[:m]
        return res.reshape(shape)

    def _lookup_multiprocess(self, qwords) -> np.ndarray:
        """Multi-controller lookup: the global query array is assembled
        from per-process local batches (process-major rows, exactly like
        ShardedCounter._put), the routed program runs on the global mesh,
        and each process reads back only its addressable rows.  The
        retry doubling stays coordinated because `dropped` is replicated:
        every process observes the same value and recompiles the same
        (per_dev, qcap) program."""
        from jax.experimental import multihost_utils

        c = self.c
        shape = qwords[0].shape
        qs = [np.asarray(q, np.uint32).reshape(-1) for q in qwords]
        m = qs[0].shape[0]
        n_local = jax.local_device_count()
        m_max = int(multihost_utils.process_allgather(
            np.asarray([m], np.int64), tiled=True).max())
        per_dev = -(-max(m_max, 1) // n_local)
        total = per_dev * n_local
        qs = [np.concatenate([q, np.full((total - m,), SENTINEL,
                                         np.uint32)]) for q in qs]
        qcap = self._plan_qcap(qs, per_dev, n_rows=n_local)
        qcap = int(multihost_utils.process_allgather(
            np.asarray([qcap], np.int64), tiled=True).max())
        while True:
            fn = self._fn(per_dev, qcap)
            qdev = [jax.make_array_from_process_local_data(
                c._tsharding, q.reshape(n_local, per_dev),
                (c.n, per_dev)) for q in qs]
            out, dropped = fn(*qdev, *_table_args(c))
            if int(dropped) == 0:
                break
            qcap = min(per_dev, qcap * 2)
        res = _local_row_data(out).reshape(-1)[:m]
        return np.asarray(res, np.uint32).reshape(shape)


def window_counts_routed(svc: ShardedLookup, codes, k: int,
                         canonical: bool):
    """Sharded-table counterpart of core.coverage.window_counts: extract
    windows single-device, answer counts via shard-routed lookups.
    Returns numpy (counts, gc, valid) in the same layout/semantics."""
    from ..core import tables as _tables

    codes = jnp.asarray(codes)
    words, valid = _tables.extract(codes, k, canonical=False)
    q = _tables.canonicalize(words, k) if canonical else words
    counts = svc.lookup([np.asarray(w) for w in q])
    valid_np = np.asarray(valid)
    counts = np.where(valid_np, counts, 0).astype(np.uint32)
    gc = np.where(valid_np,
                  np.asarray(_tables.gc_count(words)).astype(np.int32),
                  -1).astype(np.int32)
    return counts, gc, valid_np
