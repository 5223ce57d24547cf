"""Shared tool plumbing: the analogue of KAT's `InputHandler`
(reference lib/src/input_handler.cc) — glob expansion, file-type sniffing
(sequence files vs jellyfish hashes), COUNT-vs-LOAD dispatch, 5' trim lists,
and hash dumping.
"""

from __future__ import annotations

import glob as _glob
import itertools
import os
import sys
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from .. import DEFAULT_HASH_SIZE, DEFAULT_MER_LEN
from ..core import counting, kmers
from ..io import fastx, jellyfish
from ..utils.timer import stage


class InputMode(Enum):
    COUNT = 0
    LOAD = 1


def brace_expand(pattern: str) -> list[str]:
    """Minimal {a,b} brace expansion (glob(3) GLOB_BRACE)."""
    i = pattern.find("{")
    if i < 0:
        return [pattern]
    depth = 0
    for j in range(i, len(pattern)):
        if pattern[j] == "{":
            depth += 1
        elif pattern[j] == "}":
            depth -= 1
            if depth == 0:
                inner = pattern[i + 1:j]
                parts = []
                d = 0
                last = 0
                for t, ch in enumerate(inner):
                    if ch == "{":
                        d += 1
                    elif ch == "}":
                        d -= 1
                    elif ch == "," and d == 0:
                        parts.append(inner[last:t])
                        last = t + 1
                parts.append(inner[last:])
                out = []
                for p in parts:
                    out.extend(brace_expand(pattern[:i] + p + pattern[j + 1:]))
                return out
    return [pattern]


def glob_files(spec: str | list[str]) -> list[str]:
    """Glob expansion mirroring InputHandler::globFiles (input_handler.cc:
    245-316): space-separated patterns, tilde + brace expansion, NOCHECK
    (pattern kept verbatim when nothing matches)."""
    elements = [spec] if isinstance(spec, str) else list(spec)
    out: list[str] = []
    for el in elements:
        # "shard://<pattern>" marks a multi-host input group: the pattern
        # expands normally here (all processes see the same path list, so
        # headers/artifact names stay identical); the per-process FILE
        # slice is taken at read time (Input._code_batches).  In a
        # multi-process run the slice is applied to COUNT inputs with or
        # without the prefix — counting the same file on every host would
        # multiply every k-mer by the host count.
        if el.startswith("shard://"):
            el = el[len("shard://"):]
        if fastx.is_generator_path(el):
            # a gen:<shell command> is opaque: the command may contain
            # spaces/globs that belong to the SHELL, not to this group
            out.append(el)
            continue
        # each element may itself hold space-separated patterns (the
        # reference passes one quoted "file1 file2" positional through
        # boost::po and splits inside globFiles)
        for raw in el.split(" "):
            if not raw:
                continue
            matched_any = False
            for pat in brace_expand(os.path.expanduser(raw)):
                hits = sorted(_glob.glob(pat))
                if hits:
                    out.extend(hits)
                    matched_any = True
            if not matched_any:
                out.append(raw)
    if not out:
        raise ValueError("No input provided for this input group")
    return out


@dataclass
class Input:
    """One input group: either sequence files to count or a .jf to load."""
    paths: list[str]
    index: int = 1
    canonical: bool = True
    mer_len: int = DEFAULT_MER_LEN
    hash_size: int = DEFAULT_HASH_SIZE
    trim5: list[int] = field(default_factory=list)
    dump_hash: bool = False
    disable_grow: bool = False
    mode: InputMode = InputMode.COUNT
    table: counting.CountTable | None = None
    header: jellyfish.JfHeader | None = None
    # Live mesh-sharded counter (tables resident on the mesh).  When set,
    # the analysis phase runs sharded (parallel/analysis.py) and the host
    # table is only materialized on explicit demand (host_table()).
    shards: object | None = None

    def validate(self) -> None:
        if self.trim5 and len(self.trim5) not in (1, len(self.paths)):
            raise ValueError(
                "Inconsistent number of inputs and trimming settings.")
        mode = None
        for p in self.paths:
            if not fastx.is_stream_path(p) and not os.path.exists(p):
                raise FileNotFoundError(
                    f"Could not find input file at: {p}; please check the "
                    "path and try again.")
            m = (InputMode.COUNT if fastx.is_sequence_file(p)
                 else InputMode.LOAD)
            if mode is None:
                mode = m
            elif m != mode:
                raise ValueError(
                    "Cannot mix sequence files and jellyfish hashes.  "
                    f"Input: {p}")
        self.mode = mode or InputMode.COUNT

    # -- naming helpers (input_handler.cc:160-178) --
    def path_string(self) -> str:
        return " ".join(self.paths)

    def file_name(self) -> str:
        return " ".join(os.path.basename(p) for p in self.paths)

    # -- counting / loading --
    def count(self, quiet: bool = False) -> None:
        # Start small and let the streaming counter double as needed; the
        # user's hash_size is an upper bound like jellyfish's initial size.
        cap0 = 1 << 20
        with stage(f"Input {self.index} is a sequence file.  Counting kmers "
                   f"for input {self.index} ({self.path_string()})",
                   quiet=quiet):
            import jax

            n_dev = len(jax.devices())
            # Mesh-sharded counting engages automatically on multi-device
            # accelerator backends; on CPU (tests, virtual meshes) it is
            # opt-in via KAT_TPU_SHARD=1 because per-shape shard_map
            # compiles dwarf tiny workloads.
            # multi-process runs MUST shard: a per-process private table
            # would hold only that host's file slice
            want_shard = (os.environ.get("KAT_TPU_SHARD") == "1"
                          or jax.default_backend() != "cpu"
                          or jax.process_count() > 1)
            if (n_dev > 1 and want_shard
                    and not os.environ.get("KAT_TPU_NO_SHARD")):
                self.shards = self._count_sharded(n_dev)
            elif self.mer_len > kmers.MAX_K:
                from ..core import wide

                sc = wide.WideCodeStreamingCounter(
                    self.mer_len, self.canonical,
                    initial_capacity=min(cap0,
                                         _next_pow2(self.hash_size)),
                    max_capacity=max(_next_pow2(self.hash_size), cap0),
                    disable_grow=self.disable_grow)
                for batch in self._code_batches():
                    sc.add_codes(batch)
                self.table = sc.finish()
            else:
                from ..io import native

                if native.available() and not os.environ.get(
                        "KAT_TPU_NO_NATIVE"):
                    # Uniform batches from the native reader: fused
                    # extract+reduce flush.
                    sc = counting.CodeStreamingCounter(
                        self.mer_len, self.canonical,
                        initial_capacity=min(cap0,
                                             _next_pow2(self.hash_size)),
                        max_capacity=max(_next_pow2(self.hash_size), cap0),
                        disable_grow=self.disable_grow)
                    for batch in self._code_batches():
                        sc.add_codes(batch)
                else:
                    sc = counting.StreamingCounter(
                        initial_capacity=min(cap0,
                                             _next_pow2(self.hash_size)),
                        max_capacity=max(_next_pow2(self.hash_size), cap0),
                        disable_grow=self.disable_grow)
                    for batch in self._code_batches():
                        hi, lo, valid = kmers.extract_kmers(
                            batch, self.mer_len, self.canonical)
                        sc.add(hi, lo, valid)
                self.table = sc.finish()
        if self.shards is not None:
            # _host_array allgathers across processes when the mesh spans
            # hosts (a plain np.asarray can only see addressable shards)
            n_uniq = int(self.shards._host_array(
                self.shards.n_unique).sum())
        else:
            n_uniq = int(self.table.n_unique)
        self.header = jellyfish.JfHeader(
            key_len=2 * self.mer_len, counter_len=4,
            canonical=self.canonical,
            size=_next_pow2(2 * n_uniq))

    def window_counts(self, codes):
        """(counts, gc, valid) per window of a [rows, L] code batch —
        answered by shard-routed lookups when this input was counted on a
        mesh (P6), by a local binary-search gather otherwise."""
        if self.shards is not None:
            from ..parallel.analysis import (ShardedLookup,
                                             window_counts_routed)

            if getattr(self, "_lookup_svc", None) is None:
                self._lookup_svc = ShardedLookup(self.shards)
            return window_counts_routed(
                self._lookup_svc, codes, self.mer_len, self.canonical)
        import jax.numpy as jnp

        from ..core import coverage

        c, g, v = coverage.window_counts(
            self._compacted_table(), jnp.asarray(codes), self.mer_len,
            self.canonical)
        return np.asarray(c), np.asarray(g), np.asarray(v)

    def window_hit_counts(self, codes):
        """Per-row (hits, valid windows) with the reduction done on
        device — fetches two [rows] vectors instead of [rows, W] planes
        (the profile loop of filter seq only needs ratios)."""
        if self.shards is not None:
            c, _g, v = self.window_counts(codes)
            return (((c > 0) & v).sum(axis=-1).astype(np.int64),
                    v.sum(axis=-1).astype(np.int64))
        import jax.numpy as jnp

        from ..core import coverage

        hits, nwin = coverage.window_hit_counts(
            self._compacted_table(), jnp.asarray(codes), self.mer_len,
            self.canonical)
        return np.asarray(hits), np.asarray(nwin)

    def _compacted_table(self):
        """The finished table compacted for the lookup phase (cached per
        table identity): bulk lookups pay streaming passes over the
        table's capacity, so probing at the growth policy's final
        (possibly 2x-oversized) capacity wastes bandwidth."""
        from ..core import tables

        if getattr(self, "_lookup_table_src", None) is not self.table:
            self._lookup_table = tables.compact(self.table)
            self._lookup_table_src = self.table
        return self._lookup_table

    def host_table(self):
        """The (narrow or wide) host-side table, materializing it from the
        mesh shards on first demand.  Sharded-aware tools (hist/gcp/comp/
        sect/cold/filter seq) never call this; it backs .jf dumps, the
        filter kmer export, and mixed LOAD/COUNT comparisons."""
        if self.table is None and self.shards is not None:
            self.table = self.shards.finish()
        return self.table

    def _count_sharded(self, n_dev: int):
        """Count on a device mesh: data-parallel batches, k-mers routed to
        owner shards via all_to_all (SURVEY §2.5 P2).  Capacity overflow or
        routing overflow restarts the file stream with doubled limits —
        the observable behaviour of jellyfish's cooperative resize.
        Returns the live ShardedCounter (tables stay on the mesh)."""
        from ..parallel.sharded import ShardedCounter, make_mesh

        mesh = make_mesh(n_dev)
        shard_cap = _next_pow2(max(self.hash_size // n_dev, 1 << 16))
        slack = 4.0
        # growth normally happens IN PLACE inside the counter (overflow
        # replays the deferred flush at doubled capacity/slack); this
        # outer restart loop survives only as a belt-and-braces fallback
        # and for the disable_grow raise path.
        while True:
            sc = ShardedCounter(mesh, self.mer_len,
                                canonical=self.canonical,
                                shard_capacity=shard_cap,
                                route_slack=slack,
                                disable_grow=self.disable_grow)
            try:
                for batch in self._code_batches():
                    sc.add_codes(batch)
                sc.check()
                return sc
            except RuntimeError as e:
                if "dropped in routing" in str(e):
                    slack *= 2
                elif "shard table overflow" in str(e):
                    if self.disable_grow:
                        raise counting.TableFullError(str(e)) from e
                    shard_cap *= 2
                else:
                    raise

    def _shard_paths_trims(self):
        """This process's slice of the input files in a multi-process run
        (balanced by size, same round-robin as distributed.shard_files),
        with 5' trims following their files.  Single-process: everything."""
        from ..parallel.distributed import process_count, process_index

        cnt = process_count()
        if cnt <= 1:
            return self.paths, (self.trim5 or None)
        order = sorted(
            range(len(self.paths)),
            key=lambda i: -os.path.getsize(self.paths[i])
            if os.path.exists(self.paths[i]) else 0)
        mine = sorted(order[process_index()::cnt])
        paths = [self.paths[i] for i in mine]
        if self.trim5 and len(self.trim5) == len(self.paths):
            trims = [self.trim5[i] for i in mine]
        else:
            trims = self.trim5 or None  # one value applies to every file
        return paths, trims

    def _code_batches(self):
        """2-bit code batches for counting: the native densely packed
        reader when available (kat_tpu/native/fastxio.cpp), else the
        pure-Python bucketed encoder.  A background thread keeps the
        parser a few batches ahead of device compute (io/prefetch.py).

        Multi-process runs read only this process's file slice and pass
        every batch through the lockstep padder so the sharded counter's
        collective flush schedule is identical on all hosts."""
        from ..io import native
        from ..io.prefetch import prefetch
        from ..parallel.distributed import (lockstep_code_batches,
                                            process_count)

        paths, trims = self._shard_paths_trims()
        if not paths:
            it = iter(())
        else:
            any_stream = any(fastx.is_stream_path(p) for p in paths)
            if (native.available() and not any_stream
                    and not os.environ.get("KAT_TPU_NO_NATIVE")):
                it = native.stream_code_batches(
                    paths, self.mer_len, trims,
                    threads=native.reader_threads_default(len(paths)))
            else:
                # generator pipes / FIFOs / stdin go through the python
                # streaming reader (single-open, peek-based sniffing)
                recs = fastx.read_records_multi(paths, trims)
                it = fastx.encode_batches(recs, self.mer_len)
            it = prefetch(it)
        if process_count() > 1:
            yield from lockstep_code_batches(it)
        else:
            yield from it

    def load(self, quiet: bool = False) -> None:
        with stage("Loading hashes into memory", quiet=quiet):
            hdr, keys, counts = jellyfish.read_jf(self.paths[0])
            self.header = hdr
            self.canonical = hdr.canonical
            self.mer_len = hdr.mer_len
            cap = _next_pow2(max(len(keys), 1))
            if hdr.mer_len > kmers.MAX_K:
                from ..core import wide

                self.table = wide.table_from_ints(
                    keys, counts, capacity=cap,
                    n_words=kmers.words_for_k(hdr.mer_len))
            else:
                self.table = counting.table_from_numpy(
                    keys, counts, capacity=cap)

    def validate_mer_len(self, mer_len: int) -> None:
        if self.mode == InputMode.LOAD and self.header is not None:
            if self.header.key_len != mer_len * 2:
                raise ValueError(
                    "Cannot process hashes that were created with different "
                    f"K-mer lengths.  Expected: {mer_len}.  Key length was "
                    f"{self.header.key_len // 2} for : {self.paths[0]}")

    def count_or_load(self, quiet: bool = False) -> None:
        if self.mode == InputMode.COUNT:
            self.count(quiet=quiet)
        else:
            self.load(quiet=quiet)

    def dump(self, out_path: str, quiet: bool = False) -> None:
        if self.mode == InputMode.COUNT:
            with stage(f"Dumping hash to {out_path}", quiet=quiet):
                if os.path.lexists(out_path):
                    os.remove(out_path)
                table = self.host_table()
                if self.mer_len > kmers.MAX_K:
                    from ..core import wide

                    keys, counts = wide.table_to_numpy(table)
                else:
                    keys, counts = counting.table_to_numpy(table)
                jellyfish.write_jf(out_path, keys, counts, self.mer_len,
                                   self.canonical,
                                   cmdline=list(sys.argv))
        else:
            if os.path.lexists(out_path):
                os.remove(out_path)
            os.symlink(self.paths[0], out_path)


def _next_pow2(n: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(int(n), 2)))))


def parse_trim_list(spec: str) -> list[int]:
    """Comma-separated 5' trim values (histogram.cc:334-337)."""
    return [int(v) for v in spec.split(",")]


def env_int(name: str, default: int) -> int:
    """Integer env knob with a warn-and-fallback on malformed values (a
    user typo must degrade to the default, not crash at import)."""
    import warnings

    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not an integer; using {default}",
                      stacklevel=2)
        return default


def ensure_parent_dir(path_prefix: str) -> None:
    parent = os.path.dirname(os.path.abspath(path_prefix))
    os.makedirs(parent, exist_ok=True)
