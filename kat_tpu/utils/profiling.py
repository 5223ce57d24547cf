"""Structured tracing: jax.profiler integration.

The reference's observability is per-stage wall-clock prints
(boost::timer::auto_cpu_timer, SURVEY §5) — kept in utils/timer.py.  This
module adds the device layer: set KAT_TPU_PROFILE=/some/dir to capture
a full jax.profiler trace (XLA ops, device transfers, host callbacks) around
any CLI run, viewable in TensorBoard/Perfetto; `annotate` adds named trace
spans around framework phases.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_trace():
    """Profile the enclosed block when KAT_TPU_PROFILE is set."""
    trace_dir = os.environ.get("KAT_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    import jax

    # Python-call tracing would add an event per interpreted call (tens of
    # MB for one hist run); device ops and TraceAnnotation spans remain.
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    jax.profiler.start_trace(trace_dir, profiler_options=opts)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {trace_dir}")


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
