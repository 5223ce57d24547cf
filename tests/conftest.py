"""Test configuration: the CPU backend with 8 virtual devices, so sharded
paths (all_to_all / psum over a Mesh) run without an accelerator.

KAT_TPU_TEST_ON_DEVICE=1 leaves the platform to JAX: chip_smoke.py sets it
for its `pytest -m gpu` child, the one test run that uses the card."""

import os
import pathlib
import sys
import tempfile

if not os.environ.get("KAT_TPU_TEST_ON_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    # Per-host-CPU + per-boot cache dir: XLA:CPU caches machine code for
    # the host it compiled on, and code from another CPU model can fault.
    def _host_key():
        try:
            import hashlib
            with open("/proc/cpuinfo") as f:
                block = f.read().split("\n\n", 1)[0]
            try:
                with open("/proc/sys/kernel/random/boot_id") as f:
                    block += f.read()
            except OSError:
                pass
            return hashlib.sha1(block.encode()).hexdigest()[:12]
        except OSError:
            return "default"

    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(tempfile.gettempdir(),
                     f"kat_tpu_jax_cache-{_host_key()}"))
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                          "0.5")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REFERENCE_DATA = pathlib.Path("/root/reference/tests/data")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def ref_data():
    if not REFERENCE_DATA.exists():
        pytest.skip("reference test data not available")
    return REFERENCE_DATA


@pytest.fixture
def gpu():
    """The GPU devices JAX sees; skips the test when there are none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    return devs
