"""Where the program keeps what it builds, and how its GPU-only entry
points behave without a GPU: the compile cache (JAX_COMPILATION_CACHE_DIR
or one fixed path in the checkout), the native reader's build directory,
bench.py's refusal, and the multi-device dry run."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, kat_tpu; "
         "print(jax.config.jax_compilation_cache_dir)")


def _probe(env):
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_compile_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _probe(env) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _probe(env) == str(tmp_path)


def test_native_build_dir_in_checkout(monkeypatch):
    from kat_tpu.io import native

    monkeypatch.delenv("KAT_TPU_NATIVE_CACHE", raising=False)
    so = native._build_lib()
    if so is None:
        pytest.skip("g++ or zlib unavailable")
    assert so.startswith(os.path.join(ROOT, ".native_build") + os.sep)


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "needs a GPU" in r.stderr
    assert not r.stdout.strip()


def test_graft_entry_forward():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    thi, tlo, counts, n_unique, hist = fn(*args)
    assert int(n_unique) == int(np.asarray(hist).sum())
    assert int(np.asarray(counts).sum()) == 64 * (128 - 27 + 1)


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_too_few_devices_raises():
    import __graft_entry__ as ge

    with pytest.raises(RuntimeError, match="need 64 devices"):
        ge._ensure_devices(64)
