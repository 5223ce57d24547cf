"""Real multi-process jax.distributed exercise (VERDICT round-1 item 4):
two local processes with a localhost coordinator count one dataset into a
single global mesh-sharded counter; the psum-merged histogram must equal
the single-process result exactly."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, os, sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address="127.0.0.1:" + port,
            num_processes=nproc, process_id=pid)
    sys.path.insert(0, {root!r})
    import numpy as np
    from kat_tpu.parallel.distributed import global_mesh
    from kat_tpu.parallel.sharded import ShardedCounter

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 1 << 14, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, 128)

    mesh = global_mesh()
    sc = ShardedCounter(mesh, 15, shard_capacity=1 << 14, route_slack=8.0)
    # each process feeds ITS OWN slice of a fixed global batch schedule
    for i in range(4):
        r = np.random.default_rng(100 + i)
        offs = r.integers(0, genome.shape[0] - 128, 64)  # fixed global set
        mine = offs[pid::nproc]  # this process's slice of it
        sc.add_codes(np.ascontiguousarray(view[mine]))
    sc.check()
    hist = sc.histogram(1, 1001, 1, 1002)
    if pid == 0:
        print("RESULT " + json.dumps(hist.tolist()), flush=True)
""").format(root=ROOT)


def _run(nproc: int, port: int) -> list:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER, str(pid), str(nproc),
         str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e[-2000:]}"
    for o, _ in outs:
        for line in o.splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line in {outs}")


def test_two_process_histogram_matches_single():
    # ports derived from the test pid: a fixed port lingers in TIME_WAIT
    # between back-to-back runs and the coordinator fails to bind
    base = 20000 + (os.getpid() * 2) % 20000
    want = _run(1, base)
    got = _run(2, base + 1)
    assert got == want
    assert sum(want[1:]) > 0  # counted something real


WORKER_UNEVEN = textwrap.dedent("""
    import json, os, sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address="127.0.0.1:" + port,
            num_processes=nproc, process_id=pid)
    sys.path.insert(0, {root!r})
    import numpy as np
    from kat_tpu.parallel.distributed import balanced_batches, global_mesh
    from kat_tpu.parallel.sharded import ShardedCounter

    K = 33  # wide keys across process boundaries
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 1 << 14, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, 128)

    def batch(seed):
        r = np.random.default_rng(200 + seed)
        offs = r.integers(0, genome.shape[0] - 128, 16)
        return np.ascontiguousarray(view[offs])

    # fixed global schedule of 10 batches, dealt round-robin: for nproc=4
    # the per-process counts are 3/3/2/2 — deliberately UNEVEN
    mine = [batch(s) for s in range(10) if s % nproc == pid]

    mesh = global_mesh()
    sc = ShardedCounter(mesh, K, shard_capacity=1 << 14, route_slack=8.0)
    for b in balanced_batches(mine, 16, 128):
        sc.add_codes(b)
    sc.check()
    hist = sc.histogram(1, 1001, 1, 1002)
    if pid == 0:
        print("RESULT " + json.dumps(hist.tolist()), flush=True)
""").format(root=ROOT)


def _run_uneven(nproc: int, port: int) -> list:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER_UNEVEN, str(pid), str(nproc),
         str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e[-2000:]}"
    for o, _ in outs:
        for line in o.splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line in {outs}")


WORKER_ANALYSIS = textwrap.dedent("""
    import json, os, sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address="127.0.0.1:" + port,
            num_processes=nproc, process_id=pid)
    sys.path.insert(0, {root!r})
    import numpy as np
    import jax.numpy as jnp
    from kat_tpu.core import tables
    from kat_tpu.parallel.analysis import (ShardedLookup, comp_sharded,
                                           gcp_sharded)
    from kat_tpu.parallel.distributed import global_mesh
    from kat_tpu.parallel.sharded import ShardedCounter

    K = 15
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1 << 13, dtype=np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(genome, 96)

    mesh = global_mesh()

    def count(seed_base):
        sc = ShardedCounter(mesh, K, shard_capacity=1 << 13,
                            route_slack=8.0)
        for i in range(3):
            r = np.random.default_rng(seed_base + i)
            offs = r.integers(0, view.shape[0], 48)  # fixed global set
            mine = offs[pid::nproc]  # this process's slice of it
            sc.add_codes(np.ascontiguousarray(view[mine]))
        sc.check()
        return sc

    c1 = count(500)
    c2 = count(900)

    # P6 routed lookups, multi-controller: ONE fixed global query set,
    # process p answering slice [p::nproc] (UNEVEN: m % nproc != 0)
    qr = np.random.default_rng(1234)
    qoffs = qr.integers(0, view.shape[0], 11)
    words, valid = tables.extract(
        jnp.asarray(np.ascontiguousarray(view[qoffs])), K,
        canonical=False)
    qw = tables.canonicalize(words, K)
    qglob = [np.asarray(w).reshape(-1) for w in qw]
    mine = [g[pid::nproc] for g in qglob]
    res = ShardedLookup(c1).lookup(mine)
    print("LOOKUP %d " % pid + json.dumps(
        np.asarray(res, np.int64).tolist()), flush=True)

    # comp + gcp over the mesh-sharded tables (replicated outputs)
    outs = comp_sharded(c1, c2, None, k=K, d1_bins=101, d2_bins=101,
                        dm_size=31, d1_scale=1.0, d2_scale=1.0,
                        canon2=True, canon3=True)
    digest = [[int(np.asarray(leaf).sum()),
               np.asarray(leaf).reshape(-1)[:4].astype(np.int64).tolist()]
              for leaf in jax.tree_util.tree_leaves(outs)]
    grid = gcp_sharded(c1, K, 101, 1.0)
    if pid == 0:
        print("ANALYSIS " + json.dumps(
            {{"comp": digest, "gcp_sum": int(grid.sum()),
              "gcp_nz": int((grid > 0).sum())}}), flush=True)
""").format(root=ROOT)


def _run_analysis(nproc: int, port: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER_ANALYSIS, str(pid), str(nproc),
         str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e[-3000:]}"
    got: dict = {"lookup": {}}
    for o, _ in outs:
        for line in o.splitlines():
            if line.startswith("LOOKUP "):
                pid_s, payload = line[len("LOOKUP "):].split(" ", 1)
                got["lookup"][int(pid_s)] = json.loads(payload)
            elif line.startswith("ANALYSIS "):
                got["analysis"] = json.loads(line[len("ANALYSIS "):])
    return got


def test_two_process_analysis_matches_single():
    """The ANALYSIS phase multi-controller (VERDICT r3 'beyond-parity'
    item): shard-routed lookups with per-process local queries, plus
    comp_sharded/gcp_sharded on a 2-process global mesh, all exactly equal
    to the single-process results."""
    base = 28000 + (os.getpid() * 5) % 12000
    want = _run_analysis(1, base)
    got = _run_analysis(2, base + 1)
    # reassemble the interleaved per-process query slices
    single = want["lookup"][0]
    merged = [None] * len(single)
    for pid, vals in got["lookup"].items():
        merged[pid::2] = vals
    assert merged == single
    assert sum(single) > 0  # real hits
    assert got["analysis"] == want["analysis"]
    assert want["analysis"]["gcp_sum"] > 0


WORKER_CLI = textwrap.dedent("""
    import json, os, sys
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address="127.0.0.1:" + port,
            num_processes=nproc, process_id=pid)
    sys.path.insert(0, {root!r})
    from kat_tpu import cli
    rc = cli.main([
        "hist", "-m", "17", "-H", "200000", "-o", out,
        "shard:///root/reference/tests/data/ecoli_r{{1,2}}.1K.fastq"])
    assert rc == 0
    # the artifact stays on disk for the parent: printing ~69KB into the
    # parent's sequentially-drained 64KB pipe deadlocks the collective
    # shutdown (worker blocks in print, peer waits in the exit barrier)
    print("HIST %d OK" % pid, flush=True)
""").format(root=ROOT)


def _run_cli(nproc: int, port: int, tmp) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    # fresh per-worker compile-cache dirs: keeps the workers out of the
    # session-shared persistent cache (stale cross-host AOT entries there
    # are the documented hang/SIGILL hazard)
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER_CLI, str(pid), str(nproc),
         str(port), os.path.join(tmp, f"hist_{nproc}p_{pid}")],
        env=dict(env, JAX_COMPILATION_CACHE_DIR=os.path.join(
            tmp, f"jaxcache_{nproc}p_{pid}")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    outs = [p.communicate(timeout=600) for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("worker(s) failed:\n" + "\n".join(
            f"--- pid {i} rc={p.returncode}\n{o[:800]}\n{e[-2500:]}"
            for i, (p, (o, e)) in enumerate(zip(procs, outs))))
    assert all("OK" in o for o, _ in outs)
    return {pid: open(os.path.join(tmp, f"hist_{nproc}p_{pid}")).read()
            for pid in range(nproc)}


def test_two_process_cli_hist_shard_scheme_matches_single(tmp_path):
    """The documented multi-host CLI recipe end to end: `kat hist
    shard://...` on a 2-process global mesh slices the FILES per process
    (uneven: r1/r2 differ in size), keeps the collective flush schedule in
    lockstep via padded batches, and every process writes the same
    artifact as a plain single-process run over both files."""
    base = 16000 + (os.getpid() * 7) % 14000
    want = _run_cli(1, base, str(tmp_path))
    got = _run_cli(2, base + 1, str(tmp_path))
    assert got[0] == want[0]
    assert got[1] == want[0]
    assert "###" in want[0]  # a real mme-headered histogram


def test_four_process_uneven_wide_matches_single():
    """4 localhost processes x 2 devices, UNEVEN per-process batch counts
    (balanced with empty padding batches), wide (k=33) keys: exact parity
    with the single-process result (VERDICT r2 item 5)."""
    base = 24000 + (os.getpid() * 3) % 16000
    want = _run_uneven(1, base)
    got = _run_uneven(4, base + 1)
    assert got == want
    assert sum(want[1:]) > 0
