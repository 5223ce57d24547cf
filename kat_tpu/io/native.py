"""ctypes bindings for the native FASTX reader (kat_tpu/native/fastxio.cpp).

The native reader is the framework's equivalent of jellyfish's C++
mer_overlap_sequence_parser + stream_manager hot path (SURVEY §2.2): it
parses FASTA/FASTQ(.gz) and emits densely packed, already-2-bit-encoded
[rows, row_len] uint8 batches with record separators and (k-1) seams, ready
for device upload.  Built on demand with g++ (cached in `.native_build/`
in the checkout, or KAT_TPU_NATIVE_CACHE); callers fall back to the pure-Python path when unavailable.

Parallelism (the reference drains one stream with N cooperating consumer
threads, deps/jellyfish-2.2.0/include/jellyfish/cooperative_pool2.hpp:28-50;
here the split is done at the byte level instead):

  - multiple files parse concurrently (one worker per file),
  - ONE large uncompressed file splits into record-aligned byte ranges,
    each parsed by its own worker (kat_fastx_open_range does the
    record-boundary sync natively),
  - a .gz stream is inherently serial to inflate, but inflate runs on a
    dedicated native producer thread overlapped with the parse
    (kat_fastx_open_threaded) — the honest ceiling for one gzip member.

ctypes releases the GIL during the native parse+inflate, so all of the
above genuinely parallelize.  Batch ORDER interleaves across workers:
use only for order-independent consumers (k-mer counting is).
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Iterator

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native",
                    "fastxio.cpp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False

# Minimum bytes of one range piece: small enough to load-balance, large
# enough that the per-piece open/sync cost stays negligible.
RANGE_CHUNK = 64 << 20


def _host_key() -> str:
    # -march=native objects must not survive a VM migration to a host with
    # a different CPU (SIGILL); key the cache on the CPU feature flags.
    try:
        import hashlib
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
        return hashlib.sha1(flags.encode()).hexdigest()[:12]
    except OSError:
        return "default"


def _build_lib() -> str | None:
    cache = os.environ.get(
        "KAT_TPU_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(_SRC)))), ".native_build", _host_key()))
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "libfastxio.so")
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(_SRC)):
        return so
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", so + ".tmp", "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so + ".tmp", so)
        return so
    except (subprocess.SubprocessError, OSError):
        return None


def get_lib() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build_lib()
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.kat_fastx_open.restype = ctypes.c_void_p
        lib.kat_fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.kat_fastx_open_range.restype = ctypes.c_void_p
        lib.kat_fastx_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
        lib.kat_fastx_open_threaded.restype = ctypes.c_void_p
        lib.kat_fastx_open_threaded.argtypes = [ctypes.c_char_p,
                                                ctypes.c_int]
        lib.kat_fastx_sniff.restype = ctypes.c_int
        lib.kat_fastx_sniff.argtypes = [ctypes.c_char_p]
        lib.kat_fastx_close.argtypes = [ctypes.c_void_p]
        lib.kat_fastx_next_codes.restype = ctypes.c_int64
        lib.kat_fastx_next_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.kat_smr_open.restype = ctypes.c_void_p
        lib.kat_smr_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
        lib.kat_smr_open_range.restype = ctypes.c_void_p
        lib.kat_smr_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
        lib.kat_smr_close.argtypes = [ctypes.c_void_p]
        lib.kat_smr_next_flush.restype = ctypes.c_int64
        lib.kat_smr_next_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.kat_smr_next_flush2.restype = ctypes.c_int64
        lib.kat_smr_next_flush2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        lib.kat_smr_attach.restype = ctypes.c_int
        lib.kat_smr_attach.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _open_item(lib, item) -> int:
    path, trim, start, end, kind = item
    if kind == "range":
        h = lib.kat_fastx_open_range(path.encode(), int(trim),
                                     int(start), int(end))
    elif kind == "gz-threaded":
        h = lib.kat_fastx_open_threaded(path.encode(), int(trim))
    else:
        h = lib.kat_fastx_open(path.encode(), int(trim))
    if not h:
        raise OSError(f"could not open sequence file: {path}")
    return h


def _stream_item(lib, item, k: int, rows: int, row_len: int,
                 stop: threading.Event | None = None
                 ) -> Iterator[np.ndarray]:
    buf = np.empty((rows, row_len), np.uint8)
    h = _open_item(lib, item)
    try:
        while not (stop is not None and stop.is_set()):
            n = lib.kat_fastx_next_codes(
                h, k, rows, row_len,
                buf.ctypes.data_as(ctypes.c_void_p))
            if n < 0:
                raise RuntimeError(f"native reader error on {item[0]}")
            if n == 0:
                break
            yield buf[:n].copy()
    finally:
        lib.kat_fastx_close(h)


def _trims_for(paths: list[str], trim5: list[int] | None) -> list[int]:
    trims = list(trim5) if trim5 else [0] * len(paths)
    if len(trims) == 1 and len(paths) > 1:
        trims = trims * len(paths)
    return trims


def _work_items(lib, paths, trims, threads: int,
                range_chunk: int = RANGE_CHUNK) -> list[tuple]:
    """(path, trim, start, end, kind) pieces.  Large plain files split
    into record-aligned byte ranges (finer than the thread count for
    load balance); gz files stay whole but inflate on a native producer
    thread whenever any parallelism is requested."""
    items: list[tuple] = []
    whole = 1 << 62
    for path, trim in zip(paths, trims):
        kind = lib.kat_fastx_sniff(path.encode())
        if kind in (1, 2) and threads > 1:
            size = os.path.getsize(path)
            n = min(threads * 2, max(1, size // range_chunk))
            if n > 1:
                step = -(-size // n)
                for s in range(0, size, step):
                    items.append((path, trim, s, min(s + step, size),
                                  "range"))
                continue
            items.append((path, trim, 0, whole, "plain"))
        elif kind == -1 and threads > 1:
            items.append((path, trim, 0, whole, "gz-threaded"))
        else:
            items.append((path, trim, 0, whole, "plain"))
    return items


def stream_code_batches(paths: list[str], k: int,
                        trim5: list[int] | None = None,
                        rows: int = 4096,
                        row_len: int = 1024,
                        threads: int = 1) -> Iterator[np.ndarray]:
    """Yield dense [<=rows, row_len] uint8 code batches across files.

    Records are packed back to back with invalid separators; a record split
    across rows repeats its (k-1)-base seam so every k-window appears
    exactly once.  Raises RuntimeError if the native library is missing.

    threads > 1 parallelizes the parse: across files, across byte ranges
    of a single plain file, and (for gz) across the inflate/parse pair.
    Batch ORDER then interleaves: use only for order-independent
    consumers (k-mer counting is).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastxio library unavailable")
    trims = _trims_for(paths, trim5)
    threads = max(1, int(threads))
    items = _work_items(lib, paths, trims, threads)
    threads = min(threads, len(items))
    if threads == 1 and not any(i[4] == "gz-threaded" for i in items):
        for item in items:
            yield from _stream_item(lib, item, k, rows, row_len)
        return

    q: queue.Queue = queue.Queue(maxsize=2 * threads)
    work = iter(items)
    work_lock = threading.Lock()
    # Abandonment protocol: if the consumer stops draining (generator
    # closed by an error or an overflow restart), `stop` is set so
    # workers blocked on the bounded queue exit and close their native
    # handles instead of leaking threads/fds/gz state.
    stop = threading.Event()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            while not stop.is_set():
                with work_lock:
                    item = next(work, None)
                if item is None:
                    break
                for batch in _stream_item(lib, item, k, rows, row_len,
                                          stop=stop):
                    if not _put(batch):
                        return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put(e)
        finally:
            _put(None)
            # a set stop flag may have swallowed the sentinel; the
            # consumer is gone then, so nobody waits on it

    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"kat-tpu-reader-{i}")
               for i in range(threads)]
    for t in workers:
        t.start()
    live = threads
    try:
        while live:
            item = q.get()
            if item is None:
                live -= 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item
    finally:
        stop.set()


class SupermerRouter:
    """Native minimizer supermer router (the host half of a
    minimizer-bucketed counting flush — see core/minimizer.py and
    native/fastxio.cpp; no counter consumes it at present).

    Streams one FASTX(.gz) file and yields per-flush chunk layouts:
    (records u64 [n_chunks, rec_per_chunk], hot groups [n, 2]
    (start_chunk, log2_chunks), n_windows)."""

    def __init__(self, path: str, k: int, m: int, bucket_bits: int,
                 trim5: int = 0, byte_range: tuple | None = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastxio library unavailable")
        self._lib = lib
        if byte_range is not None:
            self._h = lib.kat_smr_open_range(
                path.encode(), int(k), int(m), int(bucket_bits),
                int(trim5), int(byte_range[0]), int(byte_range[1]))
        else:
            self._h = lib.kat_smr_open(path.encode(), int(k), int(m),
                                       int(bucket_bits), int(trim5))
        if not self._h:
            raise OSError(
                f"could not open {path} for supermer routing (k={k}, "
                f"m={m})")

    def next_flush(self, max_chunks: int, rec_per_chunk: int,
                   max_groups: int = 512, finalize: bool = True):
        """One flush worth of routed records, or None.

        finalize=True (default): pack remainders at end of input (None
        thereafter means fully drained).  finalize=False: None means
        "current input exhausted, bins kept" — attach() more input and
        keep calling, then drain with finalize=True."""
        chunks = np.empty((max_chunks, rec_per_chunk), np.uint64)
        groups = np.zeros((max_groups, 2), np.int32)
        stats = np.zeros((3,), np.int64)
        n = self._lib.kat_smr_next_flush2(
            self._h, int(max_chunks), int(rec_per_chunk),
            chunks.ctypes.data_as(ctypes.c_void_p),
            groups.ctypes.data_as(ctypes.c_void_p), int(max_groups),
            stats.ctypes.data_as(ctypes.c_void_p),
            1 if finalize else 0)
        if n < 0:
            raise RuntimeError("supermer router error (corrupt input?)")
        if n == 0:
            return None
        return (chunks[:n], groups[:int(stats[2])].copy(),
                int(stats[0]))

    def attach(self, path: str, trim5: int = 0,
               byte_range: tuple | None = None) -> None:
        """Attach another input, KEEPING accumulated bucket bins (used
        with next_flush(finalize=False) so many byte ranges stream into
        full flushes instead of one partial tail per range)."""
        start, end = byte_range if byte_range else (0, 1 << 62)
        ok = self._lib.kat_smr_attach(self._h, path.encode(), int(trim5),
                                      int(start), int(end))
        if not ok:
            raise OSError(f"could not attach {path} to supermer router")

    def close(self) -> None:
        if self._h:
            self._lib.kat_smr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def route_flushes(paths: list[str], k: int, m: int, bucket_bits: int,
                  max_chunks: int, rec_per_chunk: int,
                  trim5: list[int] | None = None, threads: int = 1):
    """Yield supermer flush tuples (chunks, groups, n_windows) across
    files, routed by up to `threads` parallel workers.

    Large PLAIN files split into record-aligned byte ranges (each range
    gets its own router — flushes from different workers merge through
    the count table like any other flush, so no bin merging is needed);
    gz files stay whole.  GIL released during native parse+route, so
    workers genuinely parallelize.  Flush ORDER interleaves; counting is
    order-independent."""
    import queue

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastxio library unavailable")
    trims = _trims_for(paths, trim5)
    threads = max(1, int(threads))
    # Each worker owns ONE router and ATTACHES successive work items to
    # it (bins accumulate across ranges/files), so fine-grained ranges
    # load-balance without fragmenting the stream into partial tail
    # flushes — every worker emits full flushes plus exactly one
    # remainder at the very end.  The router does ~6x the per-byte work
    # of the plain parser, so even ~8MB ranges are worth parallelizing.
    items: list[tuple] = []
    whole = 1 << 62
    for path, trim in zip(paths, trims):
        kind = lib.kat_fastx_sniff(path.encode())
        size = os.path.getsize(path) if kind in (1, 2) else 0
        if kind in (1, 2) and threads > 1 and size > 2 * (RANGE_CHUNK
                                                          // 8):
            n = min(threads * 4, max(1, size // (RANGE_CHUNK // 8)))
            step = -(-size // n)
            for s in range(0, size, step):
                items.append((path, trim, s, min(s + step, size),
                              "range"))
        else:
            items.append((path, trim, 0, whole, "plain"))
    threads = min(threads, len(items))

    def open_item(item):
        path, trim, start, end, kind = item
        if kind == "range":
            return SupermerRouter(path, k, m, bucket_bits, trim5=trim,
                                  byte_range=(start, end))
        return SupermerRouter(path, k, m, bucket_bits, trim5=trim)

    def attach_item(r, item):
        path, trim, start, end, kind = item
        r.attach(path, trim5=trim,
                 byte_range=(start, end) if kind == "range" else None)

    if threads == 1:
        r = None
        try:
            for item in items:
                if r is None:
                    r = open_item(item)
                else:
                    attach_item(r, item)
                while True:
                    fl = r.next_flush(max_chunks, rec_per_chunk,
                                      finalize=False)
                    if fl is None:
                        break
                    yield fl
            if r is not None:
                while True:
                    fl = r.next_flush(max_chunks, rec_per_chunk,
                                      finalize=True)
                    if fl is None:
                        break
                    yield fl
        finally:
            if r is not None:
                r.close()
        return

    q: queue.Queue = queue.Queue(maxsize=threads + 1)
    work = iter(items)
    work_lock = threading.Lock()
    stop = threading.Event()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        r = None
        try:
            while not stop.is_set():
                with work_lock:
                    item = next(work, None)
                if item is None:
                    break
                if r is None:
                    r = open_item(item)
                else:
                    attach_item(r, item)
                while not stop.is_set():
                    fl = r.next_flush(max_chunks, rec_per_chunk,
                                      finalize=False)
                    if fl is None:
                        break
                    if not _put(fl):
                        return
            # end of this worker's inputs: drain the remainder
            while r is not None and not stop.is_set():
                fl = r.next_flush(max_chunks, rec_per_chunk,
                                  finalize=True)
                if fl is None:
                    break
                if not _put(fl):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put(e)
        finally:
            if r is not None:
                r.close()
            _put(None)

    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"kat-tpu-router-{i}")
               for i in range(threads)]
    for t in workers:
        t.start()
    live = threads
    try:
        while live:
            item = q.get()
            if item is None:
                live -= 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item
    finally:
        stop.set()


def reader_threads_default(n_paths: int) -> int:
    """Reader parallelism for order-independent counting consumers:
    KAT_TPU_READER_THREADS, else up to half the host's cores (leave the
    rest for the dispatch loop / analysis).  Single-file inputs still
    parallelize via byte ranges (plain) or the inflate pipeline (gz)."""
    env = os.environ.get("KAT_TPU_READER_THREADS")
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            import warnings

            warnings.warn(
                f"KAT_TPU_READER_THREADS={env!r} is not an integer; "
                "using the default", stacklevel=2)
    return max(1, min(max(n_paths, 4), (os.cpu_count() or 2) // 2, 16))
