"""Multi-process scaling harness: sharded counting throughput at 1/2/4
processes (SURVEY north star: >80% weak-scaling efficiency).

Launches N worker processes on localhost (jax.distributed coordinator on
127.0.0.1), each owning `--devices-per-proc` virtual CPU devices; every
process feeds its own synthetic read batches into ONE global
mesh-sharded counter (k-mer all_to_all routing across process
boundaries).  Reports canonical k-mers/s per process count, plus the
weak-scaling efficiency vs 1 process.

On GPUs the same code path runs over NCCL; this harness is the CPU
stand-in for the multi-process layout.

Usage:
    python benchmarks/scaling.py [--procs 1 2 4] [--out scaling.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

K = 21
ROWS = 256          # rows per process per batch
LENGTH = 512
BATCHES = 8



def worker(pid: int, nproc: int, dev_per_proc: int, port: int) -> None:
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc, process_id=pid)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kat_tpu.parallel.distributed import global_mesh
    from kat_tpu.parallel.sharded import ShardedCounter

    rng = np.random.default_rng(7)  # same genome everywhere
    genome = rng.integers(0, 4, 1 << 17, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, LENGTH)

    def batch(seed):
        r = np.random.default_rng(seed)
        offs = r.integers(0, genome.shape[0] - LENGTH, ROWS)
        return np.ascontiguousarray(view[offs])

    mesh = global_mesh()

    def run(route_identity: bool):
        """One measured pass; returns (total_s, per_step_s, hist|None).
        route_identity elides the all_to_all with identical compute —
        total(routed) - total(identity) estimates pure collective cost,
        so a multi-host run produces an interconnect decomposition with
        zero new code."""
        sc = ShardedCounter(mesh, K, shard_capacity=1 << 18,
                            route_slack=8.0, flush_batches=1,
                            route_identity=route_identity)
        def sync():
            # fetch only the ADDRESSABLE shards: np.asarray on a global
            # mesh-sharded array raises for non-addressable devices in
            # multi-process runs
            for s in sc.n_unique.addressable_shards:
                _ = np.asarray(s.data)

        # warmup: one batch through the full compiled path
        sc.add_codes(batch(1000 * (pid + 1)))
        sc.flush()
        sync()

        steps = []
        t0 = time.perf_counter()
        for i in range(BATCHES):
            ts = time.perf_counter()
            sc.add_codes(batch(1000 * (pid + 1) + i + 1))
            sc.flush()
            sync()  # per-step sync
            steps.append(time.perf_counter() - ts)
        if route_identity:
            return time.perf_counter() - t0, steps, None
        sc.check()
        hist = sc.histogram(1, 10001, 1, 10002)
        return time.perf_counter() - t0, steps, hist

    dt, steps, hist = run(route_identity=False)
    dt_c, steps_c, _ = run(route_identity=True)

    windows = BATCHES * ROWS * (LENGTH - K + 1) * nproc
    if pid == 0:
        print(json.dumps({
            "nproc": nproc,
            "kmers_per_s": windows / dt,
            "seconds": dt,
            "per_step_seconds": [round(s, 4) for s in steps],
            "compute_seconds": round(dt_c, 3),
            "compute_per_step_seconds": [round(s, 4) for s in steps_c],
            "collective_seconds_est": round(max(dt - dt_c, 0.0), 3),
            "distinct": int(hist[1:].sum()),
        }), flush=True)


def launch(nproc: int, dev_per_proc: int) -> dict:
    # pid-derived port: fixed ports linger in TIME_WAIT between runs
    port = 21000 + ((os.getpid() * 7 + nproc) % 9000)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per_proc}")
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--worker",
             str(pid), str(nproc), str(dev_per_proc), str(port)],
            env=env, stdout=subprocess.PIPE if pid == 0 else
            subprocess.DEVNULL,
            stderr=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
            text=True))
    out, err = procs[0].communicate(timeout=600)
    for p in procs[1:]:
        p.wait(timeout=600)
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"worker 0 produced no result (rc={procs[0].returncode}): "
        f"{out!r}\nstderr tail: {err[-2000:]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=4, type=int, default=None)
    ap.add_argument("--procs", nargs="*", type=int, default=[1, 2, 4])
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.worker is not None:
        worker(*args.worker)
        return

    results = []
    for nproc in args.procs:
        r = launch(nproc, args.devices_per_proc)
        results.append(r)
        print(f"nproc={nproc}: {r['kmers_per_s']:.0f} kmers/s "
              f"({r['seconds']:.2f}s, distinct={r['distinct']})")
    base = results[0]["kmers_per_s"] / results[0]["nproc"]
    for r in results:
        r["efficiency_vs_1proc"] = round(
            r["kmers_per_s"] / r["nproc"] / base, 3)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
