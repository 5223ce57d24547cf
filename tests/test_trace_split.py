"""benchmarks/trace_split.py: the reduction from a profiler trace to the
flush's device time per named scope."""

import importlib.util
import os

import jax
import numpy as np

from kat_tpu.core import counting

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "trace_split", os.path.join(ROOT, "benchmarks", "trace_split.py"))
ts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ts)

HLO = """HloModule jit_fused

%fused_computation.1 (p0: u32[8]) -> u32[8] {
  %p0 = u32[8]{0} parameter(0)
  ROOT %add.1 = u32[8]{0} add(%p0, %p0), metadata={op_name="jit(fused)/scan/add"}
}

ENTRY %main (a: u32[8]) -> u32[8] {
  %a = u32[8]{0} parameter(0)
  %sort.3 = u32[8]{0} sort(%a), dimensions={0}, metadata={op_name="jit(fused)/sort/sort"}
  %fusion.1 = u32[8]{0} fusion(%sort.3), kind=kLoop, calls=%fused_computation.1
  ROOT %sort.4 = u32[8]{0} sort(%fusion.1), dimensions={0}, metadata={op_name="jit(fused)/compact/sort"}
}
"""


def test_scope_map_direct_and_fused():
    m = ts.scope_map(HLO)
    assert m["sort.3"] == "sort"
    assert m["sort.4"] == "compact"
    assert m["fusion.1"] == "scan"      # from the fused computation
    assert "a" not in m


def test_busy_union_of_overlapping_events():
    evs = [(0, 10, "m", "x"), (5, 10, "m", "y"), (30, 5, "m", "z"),
           (31, 2, "m", "w")]
    assert ts._busy_ns(evs) == 15 + 5


def test_split_of_a_traced_flush(tmp_path):
    """A real trace of two flushes of the CPU backend: both executions
    are found and their time lands in the flush's named scopes."""
    rng = np.random.default_rng(0)
    codes = [rng.integers(0, 4, (64, 256), dtype=np.uint8)
             for _ in range(4)]
    sc = counting.CodeStreamingCounter(21, initial_capacity=1 << 14,
                                       flush_batches=2)
    sc.add_codes(codes[0])
    sc.add_codes(codes[1])
    sc.device_sync()                          # compile outside the trace
    jax.profiler.start_trace(str(tmp_path))
    try:
        for c in codes:
            sc.add_codes(c)
        sc.device_sync()
    finally:
        jax.profiler.stop_trace()
    t = jax.ShapeDtypeStruct((1 << 14,), np.uint32)
    hlo = sc._flush_fn(2, 64, 256, 1 << 14).lower(
        t, t, t, jax.ShapeDtypeStruct((2, 64, 256), np.uint8)
    ).compile().as_text()
    trace = next((tmp_path / "plugins" / "profile").glob("*/*.xplane.pb"))
    res = ts.split(str(trace), hlo, gap_ms=0.5)
    assert res["events"] > 0 and res["mapped_ops"] > 0
    assert len(res["executions"]) >= 2
    scopes = set()
    for e in res["executions"]:
        scopes |= set(e["by_scope_ms"])
    assert {"sort", "compact"} <= scopes
