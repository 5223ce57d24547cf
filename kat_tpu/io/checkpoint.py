"""Sharded count-table checkpoints.

In the reference the jellyfish .jf dump IS the checkpoint (SURVEY §5:
`--dump_hash` + LOAD mode re-consumption).  This build keeps that format
for interchange (io/jellyfish.py) and adds a native sharded checkpoint for
large tables: one .npz per shard plus a JSON manifest carrying k, the
canonical flag, the shard count and the shard-hash identifier, so a resumed
run can place shards directly on the same mesh layout without re-routing.

Both narrow (k <= 31, u64 keys) and wide (k > 31, [n, n_words] uint32 word rows)
tables are supported; the manifest's "key_words" field records which.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core import counting, wide as wide_mod

MANIFEST = "manifest.json"
# fmix32 over the CANONICAL key form — the same ownership rule the mesh
# uses (parallel.sharded.owner_shard), so shards place directly on the
# mesh layout even for canonical=False tables whose stored keys are raw.
SHARD_HASH_ID = "canonical-fmix32-v1"


# host-side numpy mirrors (shared with the lookup capacity planner)
from ..core.kmers import canonical_np as _canonical_keys_np  # noqa: E402
from ..core.kmers import canonical_words_np as _canonical_words_np  # noqa


def _shard_dest(keys_or_words: np.ndarray, n_shards: int,
                wide: bool, k: int) -> np.ndarray:
    """Owner shard of each key: fmix32 of its CANONICAL form — identical
    to the mesh's parallel.sharded.owner_shard, so a resumed run can
    place shards without re-routing regardless of the table's canonical
    flag (canonicalization is a no-op for already-canonical keys)."""
    from ..parallel.sharded import owner_shard_np

    if wide:
        words = tuple(keys_or_words[:, i].astype(np.uint32)
                      for i in range(keys_or_words.shape[1]))
    else:
        words = ((keys_or_words >> np.uint64(32)).astype(np.uint32),
                 (keys_or_words & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return owner_shard_np(words, k, n_shards)


def save_table(path: str, table: counting.CountTable | wide_mod.WideTable,
               k: int, canonical: bool, n_shards: int = 1) -> None:
    """Checkpoint a host-side CountTable or WideTable, re-partitioned into
    n_shards by the same owner-shard hash the mesh uses."""
    os.makedirs(path, exist_ok=True)
    wide = isinstance(table, wide_mod.WideTable)
    if wide:
        keys, counts = wide_mod.table_words_to_numpy(table)
        key_words = keys.shape[1]
    else:
        keys, counts = counting.table_to_numpy(table)
        key_words = 2
    if n_shards > 1:
        dest = _shard_dest(keys, n_shards, wide, k)
    else:
        dest = np.zeros(len(counts), np.uint32)
    for s in range(n_shards):
        m = dest == s
        np.savez_compressed(os.path.join(path, f"shard_{s:05d}.npz"),
                            keys=keys[m], counts=counts[m])
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump({
            "format": "kat_tpu/count_table",
            "version": 3,
            "k": int(k),
            "canonical": bool(canonical),
            "n_shards": int(n_shards),
            "shard_hash": SHARD_HASH_ID,
            "key_words": int(key_words),
            "n_unique": int(len(counts)),
            "total": int(counts.sum(dtype=np.uint64)),
        }, f, indent=2)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    if m.get("format") != "kat_tpu/count_table":
        raise ValueError(f"not a kat_tpu count-table checkpoint: {path}")
    return m


def load_table(path: str) -> tuple[
        counting.CountTable | wide_mod.WideTable, dict]:
    """Load a checkpoint into one host-side table (+ manifest)."""
    m = load_manifest(path)
    wide = m.get("key_words", 2) > 2
    keys_parts = []
    counts_parts = []
    for s in range(m["n_shards"]):
        z = np.load(os.path.join(path, f"shard_{s:05d}.npz"))
        keys_parts.append(z["keys"])
        counts_parts.append(z["counts"])
    counts = np.concatenate(counts_parts) if counts_parts else \
        np.zeros(0, np.uint32)
    cap = 1 << max(1, int(np.ceil(np.log2(max(len(counts), 2)))))
    if wide:
        words = np.concatenate(keys_parts) if keys_parts else \
            np.zeros((0, m["key_words"]), np.uint32)
        return wide_mod.table_from_words(words, counts, capacity=cap), m
    keys = np.concatenate(keys_parts) if keys_parts else \
        np.zeros(0, np.uint64)
    return counting.table_from_numpy(keys, counts, capacity=cap), m


def save_sharded_counter(path: str, counter) -> None:
    """Checkpoint a live mesh-sharded counter WITHOUT host-merging the
    table: each process writes only its addressable shards (one .npz per
    shard, keys in each shard's resident sorted order), process 0 writes
    the manifest.  Because shards are written under the counter's own
    canonical-hash ownership, `load_sharded_counter` places them back on
    a same-size mesh with zero re-routing.

    Reference role: the .jf dump is the reference's checkpoint (SURVEY
    §5); this is its multi-device-native counterpart.
    """
    import jax

    counter.check()
    os.makedirs(path, exist_ok=True)
    nw = counter.n_words
    n_u_global = counter._host_array(counter.n_unique)

    # each process persists its own addressable rows
    my_shards = sorted(
        s.index[0].start if s.index[0].start is not None else 0
        for s in counter.tc.addressable_shards)
    for sid in my_shards:
        n_u = int(n_u_global[sid])
        words = [np.asarray(
            [sh.data for sh in tw.addressable_shards
             if (sh.index[0].start or 0) == sid][0])[0, :n_u]
            for tw in counter.twords]
        cnts = np.asarray(
            [sh.data for sh in counter.tc.addressable_shards
             if (sh.index[0].start or 0) == sid][0])[0, :n_u]
        if nw == 2:
            keys = (words[0].astype(np.uint64) << np.uint64(32)) \
                | words[1].astype(np.uint64)
        else:
            keys = np.stack([w.astype(np.uint32) for w in words], axis=1)
        np.savez_compressed(os.path.join(path, f"shard_{sid:05d}.npz"),
                            keys=keys, counts=cnts.astype(np.uint32))

    if jax.process_index() == 0:
        c_total = counter._host_array(counter.tc).astype(np.uint64)
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump({
                "format": "kat_tpu/count_table",
                "version": 3,
                "k": int(counter.k),
                "canonical": bool(counter.canonical),
                "n_shards": int(counter.n),
                "shard_hash": SHARD_HASH_ID,
                "key_words": int(nw),
                "n_unique": int(n_u_global.sum()),
                "total": int(c_total.sum()),
            }, f, indent=2)
    if counter.multiprocess:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("kat_tpu_checkpoint_save")


def load_sharded_counter(path: str, mesh, **counter_kwargs):
    """Resume a checkpoint as a live ShardedCounter with each shard
    placed DIRECTLY on its owner device — no host merge, no re-routing
    (requires n_shards == mesh device count and the canonical-hash
    partition scheme; `load_table` is the lenient fallback)."""
    import jax

    from ..parallel.sharded import ShardedCounter

    m = load_manifest(path)
    n = int(np.prod(mesh.devices.shape))
    if m["n_shards"] != n:
        raise ValueError(
            f"checkpoint has {m['n_shards']} shards but the mesh has {n} "
            "devices; load with load_table() and recount, or re-save")
    if m.get("shard_hash") != SHARD_HASH_ID:
        raise ValueError(
            f"checkpoint shard_hash {m.get('shard_hash')!r} != "
            f"{SHARD_HASH_ID!r}: direct placement would mis-route")
    nw = int(m.get("key_words", 2))

    # capacity: pow2 covering the largest shard
    sizes = []
    for s in range(n):
        z = np.load(os.path.join(path, f"shard_{s:05d}.npz"))
        sizes.append(len(z["counts"]))
    cap = 1 << max(4, int(np.ceil(np.log2(max(max(sizes), 2)))))

    sc = ShardedCounter(mesh, int(m["k"]), canonical=bool(m["canonical"]),
                        shard_capacity=cap, **counter_kwargs)

    from ..core.kmers import SENTINEL as _S

    def shard_words(sid: int):
        z = np.load(os.path.join(path, f"shard_{sid:05d}.npz"))
        keys, cnts = z["keys"], z["counts"]
        if nw == 2:
            ws = [(keys >> np.uint64(32)).astype(np.uint32),
                  (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
        else:
            ws = [keys[:, i].astype(np.uint32) for i in range(nw)]
        return ws, cnts.astype(np.uint32), len(cnts)

    def filled(w_idx):
        def piece(idx):
            sid = idx[0].start or 0
            ws, cnts, n_u = shard_words(sid)
            if w_idx < nw:
                row = np.full(cap, _S, np.uint32)
                row[:n_u] = ws[w_idx]
            else:
                row = np.zeros(cap, np.uint32)
                row[:n_u] = cnts
            return row[None]

        return jax.make_array_from_callback(
            (n, cap), sc._tsharding, piece)

    sc.twords = [filled(i) for i in range(nw)]
    sc.tc = filled(nw)
    sc.n_unique = jax.make_array_from_callback(
        (n,), sc._nsharding,
        lambda idx: np.asarray([sizes[idx[0].start or 0]], np.int32))
    sc.n_max = sc.n_unique
    return sc


def load_shard(path: str, shard: int) -> tuple[np.ndarray, np.ndarray]:
    """(keys, counts) of one shard — for direct per-device placement.

    Refuses checkpoints partitioned under a different ownership rule
    (e.g. version-2 raw-key-hash checkpoints): placing those directly
    would silently route lookups to the wrong shards.  `load_table`
    stays lenient — it concatenates every shard, so placement never
    matters there."""
    m = load_manifest(path)
    if m.get("n_shards", 1) > 1 and m.get("shard_hash") != SHARD_HASH_ID:
        raise ValueError(
            f"checkpoint {path} was partitioned with "
            f"shard_hash={m.get('shard_hash')!r} (expected "
            f"{SHARD_HASH_ID!r}); direct shard placement would mis-route "
            "— load with load_table() and re-save to re-partition")
    z = np.load(os.path.join(path, f"shard_{shard:05d}.npz"))
    return z["keys"], z["counts"]
