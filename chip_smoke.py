"""Smoke test of kat on the GPU: the main path end to end on one card.

Data is a bacterial resequencing run made from --seed: a random genome of
E. coli K-12 MG1655's length (4,641,652 bp) written as a one-contig
assembly, and two FASTQ files of 150 bp reads from both strands at 50x
total coverage with 0.5% substitution errors.  Every phase runs through
`kat_tpu.cli.main` in this one process and is compared with a NumPy
reference computed on the host that shares no code with kat_tpu:

  0. `pytest -m gpu tests/test_gpu.py` in a child process that ends before
     this process touches JAX (one process on the card at a time);
  1. `hist -m 27 R1 R2`   — histogram file == reference, exactly;
  2. `comp -m 27 "R1 R2" assembly` — main matrix and both spectra ==
     reference, exactly; the .stats distances within the tolerance below;
  3. `sect assembly "R1 R2" -m 27` — per-position coverage (-counts.cvg)
     == reference, exactly;
  4. `hist -m 41 R1`      — the wide-key path == a reference over
     two-u64 keys, exactly.

Tolerance: every compared artifact is integer and must match exactly.
The .stats distances are float64 functions of those integer spectra, and
the file prints them with 6 significant digits (C++ stream default), so a
distance may differ from the reference by 1e-9 relative (reduction order)
plus half a unit in its last printed digit.  No float matrix product is on
this path, so TF32 does not arise.

    python chip_smoke.py                  # one card, all phases
    python chip_smoke.py --four-cards     # hist and sect sharded over 4 cards
    python chip_smoke.py --profile DIR    # phase 1 only, traced into DIR
    JAX_PLATFORMS=cpu python chip_smoke.py --cpu-rehearsal   # tiny, on CPU

The last line of standard output is {"ok": true, "device": {...}} when every
phase passed; any failure raises, exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GENOME_LEN = 4_641_652      # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 50
ERROR_RATE = 0.005
HIST_BINS = 10001           # kat hist defaults: -l 1 -h 10000 -i 1
MX_BINS = 1001              # kat comp defaults: -i/-j 1001, -x/-y 1.0
U64 = np.uint64


class SmokeError(RuntimeError):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

BASES = np.frombuffer(b"ACGT", np.uint8)


def make_data(out: str, seed: int, genome_len: int) -> dict:
    """Genome, assembly FASTA and two FASTQ files; returns the genome and
    read code matrices the reference needs."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n_reads = -(-COVERAGE * genome_len // READ_LEN)
    reads = np.empty((n_reads, READ_LEN), np.uint8)
    step = 1 << 17
    for a in range(0, n_reads, step):
        m = min(step, n_reads - a)
        starts = rng.integers(0, genome_len - READ_LEN + 1, m)
        r = genome[starts[:, None] + np.arange(READ_LEN)]
        rev = rng.random(m) < 0.5
        r[rev] = 3 - r[rev, ::-1]
        err = rng.random(r.shape) < ERROR_RATE
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads[a:a + m] = r

    asm = os.path.join(out, "assembly.fa")
    with open(asm, "wb") as f:
        f.write(b">contig1\n")
        seq = BASES[genome]
        for a in range(0, genome_len, 80):
            f.write(seq[a:a + 80].tobytes() + b"\n")
    half = n_reads // 2
    r1 = os.path.join(out, "R1.fastq")
    r2 = os.path.join(out, "R2.fastq")
    _write_fastq(r1, reads[:half], 0)
    _write_fastq(r2, reads[half:], half)
    return {"genome": genome, "reads": reads, "half": half,
            "asm": asm, "r1": r1, "r2": r2}


def _write_fastq(path: str, codes: np.ndarray, first_id: int) -> None:
    """Fixed-width records: @r<9 digits>, sequence, +, quality."""
    n, L = codes.shape
    width = 12 + (L + 1) + 2 + (L + 1)
    with open(path, "wb") as f:
        for a in range(0, n, 1 << 17):
            c = codes[a:a + (1 << 17)]
            m = c.shape[0]
            rec = np.empty((m, width), np.uint8)
            ids = np.arange(first_id + a, first_id + a + m)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            for d in range(9):
                rec[:, 2 + d] = 48 + (ids // 10 ** (8 - d)) % 10
            rec[:, 11] = 10
            rec[:, 12:12 + L] = BASES[c]
            rec[:, 12 + L] = 10
            rec[:, 13 + L] = ord("+")
            rec[:, 14 + L] = 10
            rec[:, 15 + L:15 + 2 * L] = ord("I")
            rec[:, 15 + 2 * L] = 10
            f.write(rec.tobytes())


# --------------------------------------------------------------------------
# NumPy reference
# --------------------------------------------------------------------------

def _chunked(fn, codes: np.ndarray, rows: int = 1 << 14):
    """fn over row chunks in a thread pool (NumPy releases the GIL in its
    array loops); results concatenated in row order."""
    from concurrent.futures import ThreadPoolExecutor

    parts = [codes[a:a + rows] for a in range(0, codes.shape[0], rows)]
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        outs = list(ex.map(fn, parts))
    return [np.concatenate(x) for x in zip(*outs)]


def _forward_u64(c: np.ndarray, k: int) -> np.ndarray:
    """2k-bit forward keys of every window (k <= 32), first base most
    significant."""
    w = c.shape[1] - k + 1
    fwd = c[:, :w].astype(U64)
    for j in range(1, k):
        fwd <<= U64(2)
        fwd |= c[:, j:j + w]
    return fwd


def canonical_u64(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical keys (k <= 32) of every window of every row:
    min(forward, reverse complement)."""
    def one(c):
        rc = _forward_u64(3 - c[:, ::-1], k)[:, ::-1]
        return (np.minimum(_forward_u64(c, k), rc).ravel(),)

    return _chunked(one, codes)[0]


def _forward_u128(c: np.ndarray, k: int):
    """(hi, lo) u64 halves of 2k-bit forward keys, 32 < k <= 64."""
    w = c.shape[1] - k + 1
    hi = np.zeros((c.shape[0], w), U64)
    lo = c[:, :w].astype(U64)
    for j in range(1, k):
        hi <<= U64(2)
        hi |= lo >> U64(62)
        lo <<= U64(2)
        lo |= c[:, j:j + w]
    return hi, lo


def canonical_u128(codes: np.ndarray, k: int):
    """(hi, lo) u64 halves of canonical 2k-bit keys, 32 < k <= 64."""
    def one(c):
        fhi, flo = _forward_u128(c, k)
        rhi, rlo = (x[:, ::-1] for x in _forward_u128(3 - c[:, ::-1], k))
        fwd_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
        return (np.where(fwd_le, fhi, rhi).ravel(),
                np.where(fwd_le, flo, rlo).ravel())

    return tuple(_chunked(one, codes))


def occurrence_hist(counts: np.ndarray) -> np.ndarray:
    """kat hist's default bins: counts 1..10000, then everything above."""
    return np.bincount(np.minimum(counts, HIST_BINS),
                       minlength=HIST_BINS + 1)[1:].astype(U64)


def reference(data: dict, four_cards: bool) -> dict:
    t0 = time.perf_counter()
    reads, genome = data["reads"], data["genome"]
    rk, rc = np.unique(canonical_u64(reads, 27), return_counts=True)
    ref = {"reads_keys": rk, "reads_counts": rc,
           "hist27": occurrence_hist(rc),
           "windows27": int(rc.sum()), "distinct27": int(rk.size)}
    asm_keys = canonical_u64(genome[None, :], 27)
    pos = np.minimum(np.searchsorted(rk, asm_keys), rk.size - 1)
    ref["cvg"] = np.where(rk[pos] == asm_keys, rc[pos], 0)
    if not four_cards:
        ak, ac = np.unique(asm_keys, return_counts=True)
        union = np.union1d(rk, ak)
        h1 = _counts_at(rk, rc, union)
        h2 = _counts_at(ak, ac, union)
        mx = np.zeros((MX_BINS, MX_BINS), U64)
        np.add.at(mx, (np.minimum(h1, MX_BINS - 1),
                       np.minimum(h2, MX_BINS - 1)), U64(1))
        ref["main_mx"] = mx
        shared = (h1 > 0) & (h2 > 0)
        ref["spectrum1"] = _spectrum(h1[h1 > 0])
        ref["spectrum2"] = _spectrum(h2[h2 > 0])
        ref["shared1"] = _spectrum(h1[shared])
        ref["shared2"] = _spectrum(h2[shared])
        hi, lo = canonical_u128(reads[:data["half"]], 41)
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
        starts = np.flatnonzero(np.concatenate(
            [[True], (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]))
        c41 = np.diff(np.append(starts, hi.size))
        ref["hist41"] = occurrence_hist(c41)
        ref["windows41"] = int(hi.size)
        ref["distinct41"] = int(starts.size)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def _counts_at(keys, counts, query):
    pos = np.minimum(np.searchsorted(keys, query), keys.size - 1)
    return np.where(keys[pos] == query, counts[pos], 0)


def _spectrum(h):
    return np.bincount(np.minimum(h, MX_BINS - 1),
                       minlength=MX_BINS).astype(U64)


def ref_distances(s1, s2) -> list[float]:
    """Manhattan, Euclidean, Cosine, Canberra, Jaccard of two spectra."""
    a = s1.astype(np.float64)
    b = s2.astype(np.float64)
    d = np.abs(a - b)
    tot = a + b
    canb = np.divide(d, tot, out=np.zeros_like(d), where=tot > 0).sum()
    return [d.sum(), math.sqrt((d * d).sum()),
            1.0 - (a * b).sum() / (math.sqrt((a * a).sum())
                                   * math.sqrt((b * b).sum())),
            canb, 1.0 - np.minimum(a, b).sum() / np.maximum(a, b).sum()]


# --------------------------------------------------------------------------
# Artifact readers
# --------------------------------------------------------------------------

def body_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("#")]


def read_hist(path: str) -> np.ndarray:
    rows = [ln.split() for ln in body_lines(path)]
    _require([int(r[0]) for r in rows] == list(range(1, len(rows) + 1)),
             f"{path}: unexpected bin labels")
    return np.array([int(r[1]) for r in rows], U64)


def read_spectrum(path: str) -> np.ndarray:
    """comp -h spectrum files: bins 0..1000."""
    rows = [ln.split() for ln in body_lines(path)]
    _require([int(r[0]) for r in rows] == list(range(len(rows))),
             f"{path}: unexpected bin labels")
    return np.array([int(r[1]) for r in rows], U64)


def read_matrix(path: str) -> np.ndarray:
    return np.array([[int(v) for v in ln.split()]
                     for ln in body_lines(path)], U64)


def read_stats_distances(path: str) -> list[float]:
    with open(path) as f:
        return [float(ln.split(":")[1]) for ln in f
                if " distance: " in ln]


def read_cvg(path: str) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    _require(len(lines) == 2 and lines[0] == ">contig1",
             f"{path}: expected one contig")
    return np.array(lines[1].split(), np.int64)


def same(name: str, got: np.ndarray, want: np.ndarray) -> None:
    _require(got.shape == want.shape,
             f"{name}: shape {got.shape} != reference {want.shape}")
    bad = np.flatnonzero(got.ravel() != want.ravel())
    _require(bad.size == 0,
             f"{name}: {bad.size} entries differ, first at flat index "
             f"{bad[:1].tolist()}")


# --------------------------------------------------------------------------
# Device bookkeeping
# --------------------------------------------------------------------------

def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def peaks(jax) -> list:
    out = []
    for d in jax.devices():
        st = d.memory_stats()
        out.append(st.get("peak_bytes_in_use") if st else None)
    return out


def run_gpu_tests(out: str, allow_skips: bool) -> None:
    """Phase 0: the repo's `gpu` tests in a child process."""
    xml = os.path.join(out, "gpu_tests.xml")
    env = dict(os.environ, KAT_TPU_TEST_ON_DEVICE="1")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-o", "faulthandler_timeout=300",
         f"--junitxml={xml}", os.path.join("tests", "test_gpu.py")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    suite = ET.parse(xml).getroot()
    if suite.tag == "testsuites":
        suite = suite[0]
    n = {k: int(suite.get(k, 0))
         for k in ("tests", "failures", "errors", "skipped")}
    per_test = {c.get("name"): float(c.get("time", 0))
                for c in suite.iter("testcase")}
    print(f"phase 0 pytest -m gpu: {n} rc={r.returncode} "
          f"seconds={time.perf_counter() - t0:.1f} per_test_s={per_test}",
          flush=True)
    if r.returncode != 0 or n["failures"] or n["errors"] or (
            n["skipped"] and not allow_skips) or not n["tests"]:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise SmokeError("gpu tests failed")


def compiled_flush(jax, cap: int):
    """The steady-state k=27 flush (16 native-reader batches of 4096 x 1024
    codes) compiled at table capacity `cap`."""
    from kat_tpu.core import counting

    t = jax.ShapeDtypeStruct((cap,), jax.numpy.uint32)
    codes = jax.ShapeDtypeStruct((16, 4096, 1024), jax.numpy.uint8)
    return counting.CodeStreamingCounter(27)._flush_fn(
        16, 4096, 1024, cap).lower(t, t, t, codes).compile()


def flush_memory(jax, caps: list[int]) -> None:
    for cap in caps:
        ma = compiled_flush(jax, cap).memory_analysis()
        fields = {f: getattr(ma, f) for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes") if hasattr(ma, f)}
        print(f"flush memory_analysis cap={cap}: {fields}", flush=True)


def flush_split(jax, trace_dir: str, cap: int) -> None:
    """Device time of each traced flush, split by named scope
    (benchmarks/trace_split.py)."""
    import glob
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_split", os.path.join(HERE, "benchmarks", "trace_split.py"))
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    hlo = compiled_flush(jax, cap).as_text()
    with open(os.path.join(trace_dir, "flush.hlo.txt"), "w") as f:
        f.write(hlo)
    traces = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    _require(bool(traces), f"no trace under {trace_dir}")
    res = ts.split(traces[-1], hlo)
    with open(os.path.join(trace_dir, "split.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"flush split: {json.dumps(res)}", flush=True)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def run_phase(jax, log, name: str, argv: list[str], check, ref_counts: dict,
              runs: int = 2) -> None:
    """Run one kat command `runs` times in this process and check its
    artifacts after each run.  `check` compares them with the reference
    and returns counts read from the run's own artifacts, printed beside
    the reference's.  The first run includes tracing and compilation
    (first_call_s); a later one finds every program compiled (wall_s)."""
    from kat_tpu import cli

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(argv)
        times.append(time.perf_counter() - t0)
        _require(rc == 0, f"{name}: kat exited {rc}")
        counted = check()
    print(f"phase {name}: first_call_s={times[0]:.2f} "
          f"wall_s={times[-1]:.2f} counted={json.dumps(counted)} "
          f"reference={json.dumps(ref_counts)} "
          f"peak_bytes_in_use={peaks(jax)}", flush=True)


def check_hist(name: str, path: str, want: np.ndarray) -> dict:
    got = read_hist(path)
    same(name, got, want)
    # the last bin holds every count above it, so the window total is a
    # lower bound when that bin is occupied
    windows = int((np.arange(1, got.size + 1, dtype=U64) * got).sum())
    return {"windows" if got[-1] == 0 else "windows_at_least": windows,
            "distinct": int(got.sum())}


def check_cvg(path: str, want: np.ndarray) -> dict:
    got = read_cvg(path)
    same("sect counts", got, want)
    return cvg_counts(got)


def cvg_counts(cvg: np.ndarray) -> dict:
    return {"positions": int(cvg.size), "covered": int((cvg > 0).sum())}


def check_distances(stats_path: str, ref: dict) -> None:
    got = read_stats_distances(stats_path)
    want = (ref_distances(ref["spectrum1"], ref["spectrum2"])
            + ref_distances(ref["shared1"], ref["shared2"]))
    _require(len(got) == len(want), "comp .stats: distance count")
    for g, w in zip(got, want):
        last_digit = (0.5 * 10.0 ** (math.floor(math.log10(abs(w))) - 5)
                      if w else 0.0)
        _require(abs(g - w) <= 1e-9 * abs(w) + last_digit,
                 f"comp .stats distance {g} != reference {w}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="hist -m 27 and sect sharded over 4 cards, only")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace phase 1 into DIR and run no other phase")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny genome on the CPU backend (JAX_PLATFORMS=cpu)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "kat_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    n_cards = 4 if args.four_cards else 1
    genome_len = 20_000 if args.cpu_rehearsal else GENOME_LEN
    out = os.path.join(HERE, ".smoke", f"seed{args.seed}-{genome_len}")
    os.makedirs(out, exist_ok=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    if not args.four_cards and not args.profile:
        run_gpu_tests(out, allow_skips=args.cpu_rehearsal)

    import jax

    if args.cpu_rehearsal:
        jax.config.update("jax_num_cpu_devices", n_cards)
        if args.four_cards:
            # the sharded path and sect's halo path, as on four cards
            # (the rehearsal contig is below the 1 Mbp halo threshold)
            os.environ["KAT_TPU_SHARD"] = "1"
            os.environ["KAT_TPU_HALO_MIN"] = str(genome_len // 2)
    devs = jax.devices()
    want = "cpu" if args.cpu_rehearsal else "gpu"
    if devs[0].platform != want or len(devs) < n_cards:
        print(f"need {n_cards} {want} device(s); JAX found {devs}",
              file=sys.stderr)
        return 1
    if len(devs) != n_cards:
        print(f"expected exactly {n_cards} device(s), JAX found {len(devs)}",
              file=sys.stderr)
        return 1
    from kat_tpu.io import native

    print(f"jax {jax.__version__}; devices {devs}", flush=True)
    _require(native.available(), "native reader did not build")
    print("reader=native", flush=True)

    t0 = time.perf_counter()
    data = make_data(out, args.seed, genome_len)
    print(f"data: genome={genome_len} reads={data['reads'].shape[0]} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    ref = reference(data, args.four_cards or bool(args.profile))
    print(f"reference: seconds={ref['seconds']:.1f}", flush=True)

    placements: list = []
    if args.four_cards:
        from kat_tpu.parallel import sharded

        orig_check = sharded.ShardedCounter.check

        def check(self):
            orig_check(self)
            placements.append(sorted(
                {s.device.id for s in self.tc.addressable_shards}))

        sharded.ShardedCounter.check = check

    reads = f"{data['r1']} {data['r2']}"
    p = os.path.join(out, "run")
    runs = 1 if args.profile or args.four_cards else 2
    full = not args.four_cards and not args.profile
    with open(os.path.join(out, "kat.log"), "w") as log:
        if args.profile:
            os.environ["KAT_TPU_PROFILE"] = args.profile
        run_phase(jax, log, "1 hist -m 27",
                  ["hist", "-m", "27", "-o", f"{p}.h27", "-p", "none",
                   data["r1"], data["r2"]],
                  lambda: check_hist("hist -m 27", f"{p}.h27",
                                     ref["hist27"]),
                  {"windows": ref["windows27"],
                   "distinct": ref["distinct27"]}, runs)
        os.environ.pop("KAT_TPU_PROFILE", None)
        cap = 1 << max(20, int(np.ceil(np.log2(ref["distinct27"]))))
        if args.profile:
            flush_split(jax, args.profile, cap)
        elif not args.four_cards:
            flush_memory(jax, sorted({1 << 20, cap}))

        if full:
            def check_comp():
                mx = read_matrix(f"{p}.comp-main.mx")
                same("comp main matrix", mx, ref["main_mx"])
                same("comp spectrum 1", read_spectrum(f"{p}.comp.1.hist"),
                     ref["spectrum1"])
                same("comp spectrum 2", read_spectrum(f"{p}.comp.2.hist"),
                     ref["spectrum2"])
                check_distances(f"{p}.comp.stats", ref)
                return {"distinct": int(mx.sum())}

            run_phase(jax, log, "2 comp -m 27",
                      ["comp", "-m", "27", "-o", f"{p}.comp", "-p", "none",
                       "-h", reads, data["asm"]], check_comp,
                      {"distinct": int(ref["main_mx"].sum())}, runs)

        if not args.profile:
            want_cvg = ref["cvg"].astype(np.int64)
            run_phase(jax, log, "3 sect -m 27",
                      ["sect", "-m", "27", "-o", f"{p}.sect", data["asm"],
                       reads],
                      lambda: check_cvg(f"{p}.sect-counts.cvg", want_cvg),
                      cvg_counts(want_cvg), runs)

        if full:
            run_phase(jax, log, "4 hist -m 41",
                      ["hist", "-m", "41", "-o", f"{p}.h41", "-p", "none",
                       data["r1"]],
                      lambda: check_hist("hist -m 41", f"{p}.h41",
                                         ref["hist41"]),
                      {"windows": ref["windows41"],
                       "distinct": ref["distinct41"]}, runs)

    if args.four_cards:
        _require(len(placements) >= 2 and all(
            len(pl) == 4 for pl in placements),
            f"shards not on 4 distinct devices: {placements}")
        print(f"shard devices per counted table: {placements}", flush=True)
        print(f"per-device peak_bytes_in_use: {peaks(jax)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
