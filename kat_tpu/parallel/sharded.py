"""K-mer-space sharded counting over a `jax.sharding.Mesh`.

This is the multi-device replacement for jellyfish's single shared CAS hash
(reference deps/jellyfish-2.2.0/include/jellyfish/hash_counter.hpp
`cooperative::hash_counter` + large_hash_array.hpp `add`/`claim_key`; SURVEY
§2.5 P2/P3/P9): instead of N pthreads CAS-inserting into one mmap'd array,
every device

  1. buffers its slice of the read batches (data parallelism — the
     reference's cooperative input pool, P1), then per flush
  2. extracts k-mers and sorts them ONCE by (owner shard, key) — the
     shard id is folded into spare high key bits when they fit (narrow
     keys, few shards), else carried as one extra sort plane,
  3. routes each shard's now-contiguous, already-key-sorted bucket to its
     owner with a tiled `all_to_all` — buckets are cut with
     `dynamic_slice`, no scatter,
  4. concatenates the arrivals with the resident shard table and runs the
     same sort + segmented reduce as the single-device counter
     (core/counting._unique_reduce).

Low-dimensional results (histograms, GC matrices, comp counters) are then
per-shard reductions merged with `psum` (P4).  Tables never need a
cooperative resize barrier (P7): capacity is static per shard and overflow
is reported to the host, which re-launches at 2x — the observable behaviour
of hash_counter.hpp:204-244's size doubling.

Works on any mesh shape (multi-axis meshes route over the flattened device
space) and for both narrow (k <= 31, 2-word) and wide (k <= 127,
4/6/8-word) keys.  The 8-virtual-device CPU tests run the identical
program.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import stats, wide as wide_mod
from ..core.counting import CountTable, _unique_reduce, table_from_numpy
from .collectives import psum_exact
from ..core.kmers import MAX_K, SENTINEL, words_for_k
from ..core.tables import extract
from ..core.wide import WideTable, _unique_reduce_wide


@functools.lru_cache(maxsize=None)
def _cached_mesh(n: int, shape: tuple, axis_names: tuple) -> Mesh:
    devs = jax.devices()
    arr = np.asarray(devs[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def make_mesh(n_devices: int | None = None,
              shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("shards",)) -> Mesh:
    """Mesh over the first n devices; default 1D axis "shards".  Cached so
    co-partitioned counters (comp's inputs) share one Mesh object."""
    n = n_devices or len(jax.devices())
    shape = tuple(shape) if shape is not None else (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return _cached_mesh(n, shape, tuple(axis_names))


def shard_hash(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """32-bit finalizer-style mixer over a packed (hi, lo) key.

    Plays the role of jellyfish's random GF(2) matrix hash
    (rectangular_binary_matrix.hpp:138-146) for shard ownership: k-mer keys
    are highly structured (low entropy in high bits), so counts would skew
    badly under a plain modulo.  murmur3-fmix32 over the mixed words.
    """
    return shard_hash_words((hi, lo))


def shard_hash_words(words) -> jax.Array:
    x = words[0] ^ jnp.uint32(0x9E3779B9)
    for w in words:
        x = (x ^ w) * jnp.uint32(0x85EBCA6B)
        x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def shard_hash_words_np(words) -> np.ndarray:
    """Numpy mirror of shard_hash_words (bit-exact), for host-side paths
    (checkpoint placement, lookup capacity planning) that must not touch
    any device."""
    u = np.uint32
    x = words[0] ^ u(0x9E3779B9)
    for w in words:
        x = (x ^ w) * u(0x85EBCA6B)
        x = x ^ (x >> u(16))
    x = x * u(0x7FEB352D)
    x = x ^ (x >> u(15))
    x = x * u(0x846CA68B)
    x = x ^ (x >> u(16))
    return x


def owner_shard_np(words, k: int, n_dest: int) -> np.ndarray:
    """Numpy mirror of owner_shard: fmix32 of the canonical key form."""
    from ..core.kmers import canonical_np, canonical_words_np, join_u64

    words = tuple(np.asarray(w, np.uint32) for w in words)
    if len(words) == 2:
        ck = canonical_np(join_u64(words[0], words[1]), k)
        cw = ((ck >> np.uint64(32)).astype(np.uint32),
              (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    else:
        rows = canonical_words_np(np.stack(words, axis=1), k)
        cw = tuple(rows[:, i] for i in range(rows.shape[1]))
    return shard_hash_words_np(cw) % np.uint32(n_dest)


def owner_shard(words, k: int, n_dest: int) -> jax.Array:
    """Shard ownership of a key: hash of its CANONICAL form.

    Owning by canonical hash (not raw hash) guarantees that a key, its
    reverse complement, and any canonicalized probe of it land on the same
    shard — the property that makes the whole analysis phase (comp's
    cross-hash probes, sect/cold lookups) local joins on co-partitioned
    shards (SURVEY §7 step 6; reference src/comp.cc:447 canonicalizes
    pass-2 probes unconditionally)."""
    from ..core import tables

    cwords = tables.canonicalize(words, k)
    return (shard_hash_words(cwords) % jnp.uint32(n_dest)).astype(jnp.int32)


def _fold_shift(k: int, n_dest: int) -> int | None:
    """Bit position for folding the owner-shard id into spare high key
    bits of the packed (hi, lo) pair — valid when the key occupies >= 32
    bits and the id (top bit kept zero so a folded real key can never
    collide with the all-ones SENTINEL) fits above the 2k used bits."""
    if k > MAX_K or 2 * k < 32:
        return None
    spare = 64 - 2 * k
    if n_dest > (1 << (spare - 1)):
        return None
    return 2 * k - 32


def _flush_local(*args, k: int, canonical: bool, n_dest: int,
                 route_cap: int, table_cap: int,
                 axis_names: tuple[str, ...], n_words: int, b: int,
                 length: int, fold_shift: int | None,
                 route_identity: bool = False):
    """Per-device flush body: extract -> dest-keyed sort -> slice buckets
    -> all_to_all -> sort + segmented reduce with the shard table."""
    codes = args[:b]
    twords = tuple(a[0] for a in args[b:b + n_words])
    tc = args[b + n_words][0]
    prev_max = args[b + n_words + 1]
    prev_dropped = args[b + n_words + 2]

    # -- 1. extract windows from every buffered batch ---------------------
    cat = jnp.concatenate([c.reshape(-1, length) for c in codes])
    words, valid = extract(cat, k, canonical)
    words = tuple(w.reshape(-1) for w in words)
    valid = valid.reshape(-1)

    # -- 2. owner shard, folded or as an extra sort plane -----------------
    dest = owner_shard(words, k, n_dest).astype(jnp.uint32)
    if fold_shift is not None:
        hi, lo = words
        fhi = jnp.where(valid, (dest << fold_shift) | hi, SENTINEL)
        planes = (fhi, lo)
    else:
        dplane = jnp.where(valid, dest, SENTINEL)
        planes = (dplane,) + words
    nk = len(planes)

    # -- 3. ONE local sort orders by (dest, key) --------------------------
    planes_s = jax.lax.sort(planes, num_keys=nk)

    # -- 4. bucket boundaries: n_dest+1 binary searches, no scan ----------
    if fold_shift is not None:
        dest_s = planes_s[0] >> fold_shift
    else:
        dest_s = planes_s[0]
    qs = jnp.arange(n_dest + 1, dtype=jnp.uint32)
    starts = jnp.searchsorted(dest_s, qs).astype(jnp.int32)
    cnts = starts[1:] - starts[:-1]
    dropped = jnp.sum(
        jnp.maximum(cnts - route_cap, 0).astype(jnp.uint64))

    # -- 5. cut [n_dest, route_cap] buckets with dynamic slices -----------
    # (scatter-free: each bucket is a contiguous, already-key-sorted
    # segment of the sorted stream; tails mask to sentinels)
    send = planes_s if fold_shift is not None else planes_s[1:]
    pos = jnp.arange(route_cap, dtype=jnp.int32)
    bufs = []
    for p in send:
        padded = jnp.concatenate(
            [p, jnp.full((route_cap,), SENTINEL, jnp.uint32)])
        rows = [jnp.where(pos < cnts[d],
                          jax.lax.dynamic_slice(padded, (starts[d],),
                                                (route_cap,)),
                          SENTINEL)
                for d in range(n_dest)]
        bufs.append(jnp.stack(rows))

    # -- 6. route to owners ----------------------------------------------
    # (route_identity: timing-harness knob — identical compute with the
    # exchange elided, so collective cost = full - identity; results are
    # WRONG globally and must only feed timing)
    if n_dest > 1 and not route_identity:
        arr = [jax.lax.all_to_all(bf, axis_names, 0, 0, tiled=True)
               for bf in bufs]
    else:
        arr = bufs
    arr = [a.reshape(-1) for a in arr]

    # -- 7. strip the dest bits (uniform == my shard id on real keys) -----
    if fold_shift is not None:
        ahi, alo = arr
        is_sent = (ahi == SENTINEL) & (alo == SENTINEL)
        ahi = jnp.where(is_sent, SENTINEL,
                        ahi & jnp.uint32((1 << fold_shift) - 1))
        arr = [ahi, alo]

    # -- 8. sort + segmented reduce with the resident shard table ---------
    sent = jnp.ones(arr[0].shape, jnp.bool_)
    for m in arr[:n_words]:
        sent = sent & (m == SENTINEL)
    w = (~sent).astype(jnp.uint32)
    cat_w = tuple(jnp.concatenate([tw.reshape(-1), a])
                  for tw, a in zip(twords, arr))
    cw = jnp.concatenate([tc.reshape(-1), w])
    if n_words == 2:
        out = _unique_reduce(cat_w[0], cat_w[1], cw, table_cap)
    else:
        out = _unique_reduce_wide(cat_w, cw, table_cap)

    *nwords, nc, n_unique = out
    new_max = jnp.maximum(prev_max, n_unique[None])
    dropped = prev_dropped + psum_exact(dropped, axis_names)
    return (*(wd[None] for wd in nwords), nc[None], n_unique[None],
            new_max, dropped)


class ShardedCounter:
    """Streaming k-mer counter whose table lives sharded across a mesh.

    Local shard tables are [1, capacity] slices of [n_devices, capacity]
    global word/count arrays.  `add_codes` buffers one [rows, L] uint8
    code batch (rows padded to a multiple of n_devices); every
    `flush_batches` batches (or at shape changes / `flush()`) the buffered
    batches go through ONE jitted extract+route+merge program — the LSM
    structure that amortizes the resident table's merge cost, mirroring
    the single-device CodeStreamingCounter.  `finish` returns a host-merged
    CountTable (k <= 31) or WideTable (k <= 127); `histogram` reduces on
    device and `psum`s.
    """

    def __init__(self, mesh: Mesh, k: int, canonical: bool = True,
                 shard_capacity: int = 1 << 18,
                 route_slack: float = 2.0,
                 flush_batches: int = 16,
                 route_identity: bool = False,
                 disable_grow: bool = False,
                 max_capacity: int = 1 << 30):
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.k = k
        self.canonical = canonical
        self.n = int(np.prod(mesh.devices.shape))
        self.n_words = words_for_k(k)
        self.shard_capacity = int(shard_capacity)
        self.route_slack = float(route_slack)
        self.flush_batches = int(flush_batches)
        self.disable_grow = bool(disable_grow)
        self.max_capacity = int(max_capacity)

        self._route_identity = bool(route_identity)

        spec = P(self.axis_names if len(self.axis_names) > 1
                 else self.axis_names[0], None)
        self._tspec = spec
        self._tsharding = NamedSharding(mesh, spec)
        self._nsharding = NamedSharding(mesh, P(spec[0]))
        self._rsharding = NamedSharding(mesh, P())
        self.multiprocess = jax.process_count() > 1

        def filled(shape, sharding, fill, dtype):
            # make_array_from_callback works in single- AND multi-process
            # runs (device_put of a full array requires every device to be
            # addressable, which fails across hosts)
            def piece(idx):
                pshape = tuple(
                    len(range(*s.indices(d))) for s, d in zip(idx, shape))
                return np.full(pshape, fill, dtype)

            return jax.make_array_from_callback(shape, sharding, piece)

        cap_shape = (self.n, self.shard_capacity)
        self.twords = [filled(cap_shape, self._tsharding, SENTINEL,
                              np.uint32) for _ in range(self.n_words)]
        self.tc = filled(cap_shape, self._tsharding, 0, np.uint32)
        self.n_unique = filled((self.n,), self._nsharding, 0, np.int32)
        # running max of per-flush unique counts: overflow of ANY flush
        # must be detectable even if later flushes report lower counts
        self.n_max = filled((self.n,), self._nsharding, 0, np.int32)
        self._dropped = filled((), self._rsharding, 0, np.uint64)
        self._codes: list = []
        self._shape: tuple | None = None
        self._flush_fns: dict = {}
        self._pad_fns: dict = {}
        # the ONE flush whose overflow/drop status has not been fetched
        # yet: (pre-flush state, codes, b, rows, length) — kept so an
        # overflowing flush REPLAYS in place at doubled capacity/slack
        # instead of forcing the caller to recount the whole stream
        # (the observable behaviour of hash_counter.hpp:204-244's
        # in-place cooperative resize)
        self._pending: tuple | None = None

    def _route_cap(self, b: int, rows: int, length: int) -> int:
        windows_local = b * (rows // self.n) * (length - self.k + 1)
        route_cap = int(np.ceil(
            windows_local / self.n * self.route_slack))
        return max(min(route_cap, windows_local), 1)

    def _flush_fn(self, b: int, rows: int, length: int):
        route_cap = self._route_cap(b, rows, length)
        key = (b, rows, length, self.shard_capacity, route_cap)
        if key not in self._flush_fns:
            spec = self._tspec
            nspec = P(spec[0])
            nw = self.n_words
            body = functools.partial(
                _flush_local, k=self.k, canonical=self.canonical,
                n_dest=self.n, route_cap=route_cap,
                table_cap=self.shard_capacity,
                axis_names=self.axis_names, n_words=nw, b=b,
                length=length,
                fold_shift=_fold_shift(self.k, self.n),
                route_identity=self._route_identity)
            fn = shard_map(
                body, mesh=self.mesh,
                in_specs=(spec,) * b + (spec,) * (nw + 1) + (nspec, P()),
                out_specs=(spec,) * (nw + 1) + (nspec, nspec, P()),
                check_vma=False)
            # no donation: the pre-flush table must survive one flush so
            # an overflow can replay in place
            self._flush_fns[key] = jax.jit(fn)
        return self._flush_fns[key]

    def _pad_tables(self, twords, tc, new_cap: int):
        """Grow [n, cap] shard tables to [n, new_cap] (sentinel/zero
        fill) on device, preserving the mesh sharding."""
        old_cap = twords[0].shape[1]
        key = (old_cap, new_cap)
        if key not in self._pad_fns:
            pad = new_cap - old_cap

            @functools.partial(jax.jit, static_argnames=("fill",),
                               out_shardings=self._tsharding)
            def padf(x, fill):
                return jnp.concatenate(
                    [x, jnp.full((x.shape[0], pad), fill, x.dtype)],
                    axis=1)

            self._pad_fns[key] = padf
        padf = self._pad_fns[key]
        return ([padf(tw, fill=int(SENTINEL)) for tw in twords],
                padf(tc, fill=0))

    def _put(self, codes) -> jax.Array:
        """Pad rows to the mesh multiple and shard row-wise."""
        if (isinstance(codes, jax.Array) and not self.multiprocess
                and codes.ndim == 2 and codes.shape[0] % self.n == 0):
            # already on device with compatible rows: re-layout only,
            # no round trip through the host
            return jax.device_put(codes, self._tsharding)
        codes = np.asarray(codes, np.uint8)
        rows, length = codes.shape
        if self.multiprocess:
            n_local = jax.local_device_count()
            if rows % n_local:
                pad = n_local - rows % n_local
                codes = np.concatenate(
                    [codes, np.full((pad, length), 255, np.uint8)])
                rows += pad
            rows *= jax.process_count()
            return jax.make_array_from_process_local_data(
                self._tsharding, codes, (rows, length))
        if rows % self.n:
            pad = self.n - rows % self.n
            codes = np.concatenate(
                [codes, np.full((pad, length), 255, np.uint8)])
        return jax.device_put(jnp.asarray(codes), self._tsharding)

    def add_codes(self, codes) -> None:
        """Buffer one [rows, L] uint8 code batch.

        In a multi-process run every process passes its OWN rows (the same
        row count everywhere — pad short batches); the global batch is the
        process-major concatenation."""
        if not isinstance(codes, jax.Array):
            codes = np.asarray(codes, np.uint8)
        if codes.ndim != 2:
            raise ValueError("expected [rows, length] code batch")
        dev = self._put(codes)
        if self._shape is not None and dev.shape != self._shape:
            self.flush()
        self._shape = dev.shape
        self._codes.append(dev)
        if len(self._codes) >= self.flush_batches:
            self.flush()

    def flush(self) -> None:
        """Absorb every buffered batch into the resident shard tables.

        Optimistic commit (same pattern as the single-device counter): the
        flush's overflow/drop scalars are fetched at the NEXT
        flush/check, by which point they are already computed; on
        overflow the flush replays from the kept pre-flush state at
        doubled capacity (or route slack) — in place, no recount."""
        if not self._codes:
            return
        self._settle()
        rows, length = self._shape
        b = len(self._codes)
        codes = self._codes
        self._codes = []
        self._shape = None
        self._launch(codes, b, rows, length)

    def _launch(self, codes, b: int, rows: int, length: int) -> None:
        prev = (list(self.twords), self.tc, self.n_max, self._dropped)
        fn = self._flush_fn(b, rows, length)
        *outs, self.n_unique, self.n_max, self._dropped = fn(
            *codes, *self.twords, self.tc, self.n_max, self._dropped)
        self.twords = list(outs[:self.n_words])
        self.tc = outs[self.n_words]
        self._pending = (prev, codes, b, rows, length)

    def _grow_capacity(self) -> None:
        if self.disable_grow or self.shard_capacity * 2 > self.max_capacity:
            raise RuntimeError(
                f"shard table overflow: unique keys > capacity "
                f"{self.shard_capacity} and growth is "
                f"{'disabled' if self.disable_grow else 'capped'}")
        self.shard_capacity *= 2

    def _settle(self) -> None:
        """Fetch the deferred flush's status; replay in place on
        overflow (capacity doubling) or routing drops (slack doubling)."""
        if self._pending is None:
            return
        prev, codes, b, rows, length = self._pending
        self._pending = None
        prev_tw, prev_tc, prev_nmax, prev_dropped = prev
        while True:
            n_u = self._host_array(self.n_unique)
            d_now = int(self._host_array(self._dropped))
            d_prev = int(self._host_array(prev_dropped))
            over_cap = bool((n_u > self.shard_capacity).any())
            if not over_cap and d_now == d_prev:
                return
            if over_cap:
                self._grow_capacity()
                prev_tw, prev_tc = self._pad_tables(
                    prev_tw, prev_tc, self.shard_capacity)
            if d_now > d_prev:
                windows_local = (b * (rows // self.n)
                                 * (length - self.k + 1))
                if self._route_cap(b, rows, length) >= windows_local:
                    raise RuntimeError(
                        f"{d_now - d_prev} k-mers dropped in routing at "
                        "maximum route capacity")  # cannot happen
                self.route_slack *= 2
            fn = self._flush_fn(b, rows, length)
            *outs, self.n_unique, self.n_max, self._dropped = fn(
                *codes, *prev_tw, prev_tc, prev_nmax, prev_dropped)
            self.twords = list(outs[:self.n_words])
            self.tc = outs[self.n_words]

    def _host_array(self, arr) -> np.ndarray:
        """Full host copy of a mesh-sharded array (allgather across
        processes when the mesh spans hosts)."""
        if self.multiprocess:
            from jax.experimental import multihost_utils

            return np.asarray(
                multihost_utils.process_allgather(arr, tiled=True))
        return np.asarray(arr)

    def check(self) -> None:
        self.flush()
        self._settle()
        # backstops only — _settle replays every overflow in place
        dropped = int(self._host_array(self._dropped))
        if dropped:
            raise RuntimeError(
                f"{dropped} k-mers dropped in routing; increase "
                "route_slack")
        n_u = self._host_array(self.n_max)
        if (n_u > self.shard_capacity).any():
            raise RuntimeError(
                f"shard table overflow: {n_u.max()} unique keys > capacity "
                f"{self.shard_capacity}")

    @property
    def dropped(self) -> int:
        return int(self._host_array(self._dropped))

    def finish(self) -> CountTable | WideTable:
        """Merge shard tables into one host-side sorted table."""
        self.check()
        n_u = self._host_array(self.n_unique)
        c = self._host_array(self.tc).astype(np.uint32)
        words = [self._host_array(tw).astype(np.uint64)
                 for tw in self.twords]
        parts_c = [c[i, :n_u[i]] for i in range(self.n)]
        all_c = np.concatenate(parts_c) if parts_c else np.zeros(0, np.uint32)
        cap = 1 << max(1, int(np.ceil(np.log2(max(len(all_c), 2)))))
        if self.n_words == 2:
            keys = (words[0] << np.uint64(32)) | words[1]
            parts_k = [keys[i, :n_u[i]] for i in range(self.n)]
            all_k = np.concatenate(parts_k) if parts_k else \
                np.zeros(0, np.uint64)
            return table_from_numpy(all_k, all_c, capacity=cap)
        parts_w = [np.stack([wd[i, :n_u[i]] for wd in words], axis=1)
                   for i in range(self.n)]
        all_w = (np.concatenate(parts_w) if parts_w else
                 np.zeros((0, self.n_words), np.uint64))
        return wide_mod.table_from_words(all_w.astype(np.uint32), all_c,
                                         capacity=cap)

    def histogram(self, base: int, ceil: int, inc: int,
                  nb_buckets: int) -> np.ndarray:
        """Sharded histogram: per-shard bincount + psum (SURVEY P3/P4)."""
        self.check()
        spec = self._tspec

        def local_hist(counts):
            c = counts.reshape(-1).astype(jnp.int64)
            bucket = jnp.where(c < base, 0,
                               jnp.where(c > ceil, nb_buckets - 1,
                                         (c - base) // inc)).astype(jnp.int32)
            h = stats.mask_bincount((nb_buckets,), bucket, c > 0)
            return psum_exact(h, self.axis_names)

        fn = shard_map(local_hist, mesh=self.mesh, in_specs=(spec,),
                       out_specs=P())
        return np.asarray(jax.jit(fn)(self.tc), np.uint64)
