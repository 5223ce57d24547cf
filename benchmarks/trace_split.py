"""Device-time split of a profiled run by named scope.

Reads a `jax.profiler` trace (.xplane.pb) and the optimized HLO text of
one jitted program (`compiled.as_text()`), and reports for each execution
of that program the device time spent in each `jax.named_scope` of the
source.  The counting flush (core/counting.py) names its stages
`extract`, `merge_table`, `sort`, `scan` and `compact`.

Device events are the kernel events of the `/device:*` planes (the CPU
backend, which has none, reports its XLA ops on host threads instead).
Each event's `hlo_op` stat names an instruction of the optimized HLO; the
instruction's `op_name` metadata (or, for a fusion without one, that of
the instructions it fuses) names the scope.  Executions of the program
are the runs of its events separated by more than `gap_ms` of device time
in which it ran nothing.

    python benchmarks/trace_split.py TRACE.xplane.pb FLUSH.hlo.txt [module]
"""

from __future__ import annotations

import json
import re
import sys
from collections import defaultdict

SCOPES = ("extract", "merge_table", "sort", "scan", "compact")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def _scope_of(op_name: str, scopes) -> str | None:
    for part in op_name.split("/"):
        if part in scopes:
            return part
    return None


def scope_map(hlo_text: str, scopes=SCOPES) -> dict:
    """HLO instruction name -> scope for every instruction that has one."""
    direct: dict = {}
    calls: dict = {}
    per_comp: dict = defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OPNAME.search(line)
        sc = _scope_of(op.group(1), scopes) if op else None
        if sc:
            direct[name] = sc
            per_comp[comp].append(sc)
        c = _CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    out = dict(direct)
    for name, callee in calls.items():
        if name not in out and per_comp.get(callee):
            found = per_comp[callee]
            out[name] = max(set(found), key=found.count)
    return out


def device_events(path: str):
    """(start_ns, duration_ns, hlo_module, hlo_op) of every device op."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name.startswith("/host:CPU")]
    out = []
    for p in planes:
        lines = list(p.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            for e in ln.events:
                st = dict(e.stats)
                if "hlo_op" in st:
                    out.append((int(e.start_ns), int(e.duration_ns),
                                str(st.get("hlo_module", "")),
                                str(st["hlo_op"])))
    out.sort()
    return out


def _busy_ns(events) -> int:
    total, end = 0, None
    for s, d, *_ in events:
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def split(path: str, hlo_text: str, module: str = "jit_fused",
          gap_ms: float = 5.0) -> dict:
    smap = scope_map(hlo_text)
    evs = device_events(path)
    if not evs:
        return {"events": 0}
    window = evs[-1][0] + evs[-1][1] - evs[0][0]
    mine = [e for e in evs if e[2] == module]
    runs: list = []
    for e in mine:
        if runs and e[0] - (runs[-1][-1][0] + runs[-1][-1][1]) <= gap_ms * 1e6:
            runs[-1].append(e)
        else:
            runs.append([e])
    execs = []
    for r in runs:
        by = defaultdict(int)
        for _s, d, _m, op in r:
            by[smap.get(op, "other")] += d
        execs.append({
            "start_ms": (r[0][0] - evs[0][0]) / 1e6,
            "wall_ms": (r[-1][0] + r[-1][1] - r[0][0]) / 1e6,
            "busy_ms": _busy_ns(r) / 1e6,
            "by_scope_ms": {k: v / 1e6 for k, v in sorted(by.items())},
        })
    per_module = defaultdict(int)
    for _s, d, m, _op in evs:
        per_module[m] += d
    busy = _busy_ns(evs)
    return {
        "events": len(evs),
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else None,
        "module_ms": {m: v / 1e6 for m, v in sorted(
            per_module.items(), key=lambda kv: -kv[1])[:12]},
        "module": module,
        "mapped_ops": len(smap),
        "executions": execs,
    }


if __name__ == "__main__":
    trace, hlo = sys.argv[1], sys.argv[2]
    mod = sys.argv[3] if len(sys.argv) > 3 else "jit_fused"
    with open(hlo) as f:
        print(json.dumps(split(trace, f.read(), mod), indent=1))
