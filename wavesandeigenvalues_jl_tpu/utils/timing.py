"""Structured per-phase timing and device-trace hooks.

The reference's only observability is ProgressMeter bars and wall-clock
prints inside the perturbation module (SURVEY.md §5).  This framework
replaces that with:

* ``phase("name")`` — a context manager that accumulates wall time per
  phase into a process-global registry (nested phases get dotted paths)
  and, when a JAX profiler trace is active, also emits a
  ``jax.profiler.TraceAnnotation`` so the phase shows up on the xprof /
  TensorBoard timeline next to the device ops it launched.
* ``report()`` — the accumulated table; ``reset()`` clears it.
* ``start_device_trace(logdir)`` / ``stop_device_trace()`` — thin wrappers
  around ``jax.profiler`` for capturing device traces of a solve.

Timing is opt-in and ~300 ns per phase when idle — cheap enough to leave
in library code (assembly, solver iterations, quadrature batches).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

_lock = threading.Lock()
_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_stack = threading.local()


@contextmanager
def phase(name: str):
    """Accumulate wall time under ``name`` (dotted path when nested), and
    annotate the device trace when one is being captured."""
    parts = getattr(_stack, "parts", None)
    if parts is None:
        parts = _stack.parts = []
    parts.append(name)
    path = ".".join(parts)
    ann = None
    try:
        import jax.profiler
        ann = jax.profiler.TraceAnnotation(path)
        ann.__enter__()
    except Exception:
        ann = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        parts.pop()
        with _lock:
            _times[path] += dt
            _counts[path] += 1


def report(reset_after: bool = False) -> Dict[str, Dict[str, float]]:
    """{phase_path: {total_s, calls, mean_s}} accumulated so far."""
    with _lock:
        out = {k: {"total_s": _times[k], "calls": _counts[k],
                   "mean_s": _times[k] / max(_counts[k], 1)}
               for k in sorted(_times)}
        if reset_after:
            _times.clear()
            _counts.clear()
    return out


def reset():
    with _lock:
        _times.clear()
        _counts.clear()


def format_report() -> str:
    rows = report()
    if not rows:
        return "(no phases recorded)"
    w = max(len(k) for k in rows)
    lines = [f"{'phase':<{w}}  {'total [s]':>10}  {'calls':>6}  {'mean [ms]':>10}"]
    for k, v in rows.items():
        lines.append(f"{k:<{w}}  {v['total_s']:>10.4f}  {v['calls']:>6d}  "
                     f"{v['mean_s']*1e3:>10.3f}")
    return "\n".join(lines)


_trace_active: Optional[str] = None


def start_device_trace(logdir: str):
    """Begin capturing a device trace (xprof/TensorBoard format)."""
    global _trace_active
    import jax.profiler
    jax.profiler.start_trace(logdir)
    _trace_active = logdir
    return logdir


def stop_device_trace():
    global _trace_active
    import jax.profiler
    jax.profiler.stop_trace()
    logdir, _trace_active = _trace_active, None
    return logdir


__all__ = ["phase", "report", "reset", "format_report",
           "start_device_trace", "stop_device_trace"]
