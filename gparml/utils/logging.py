"""Structured per-iteration metrics (reference: SCG ``display`` prints +
returned f-history, optional bound/time log file — SURVEY.md §5
"Metrics / logging / observability").

The optimizers run fully jit'd, so per-iteration values arrive as arrays
after the fact; ``write_history`` persists them as JSONL or CSV. For live
output, ``scg.SCGOptions(display=True)`` uses jax.debug.print from inside the
compiled loop.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional

import numpy as np


def write_history(
    path: str,
    history,
    fmt: Optional[str] = None,
    extra: Optional[Dict] = None,
) -> None:
    """Persist a per-iteration history as JSONL or CSV.

    ``history`` is either a nan-padded (T,) bound array or a dict of named
    (T,) columns (e.g. an SCG trace: bound, gnorm2, lambda, alpha, accepted).
    Rows where the bound is nan (loop already converged) are dropped.
    ``fmt`` defaults from the file extension (.jsonl / .csv)."""
    if not isinstance(history, dict):
        history = {"bound": history}
    cols = {k: np.asarray(v) for k, v in history.items()}
    valid = np.isfinite(cols.get("bound", next(iter(cols.values()))))
    if fmt is None:
        fmt = "csv" if path.endswith(".csv") else "jsonl"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _py(v):
        return bool(v) if v.dtype == np.bool_ else float(v)

    rows = [
        {"iteration": int(i), **{k: _py(v[i]) for k, v in cols.items()},
         **(extra or {})}
        for i in np.nonzero(valid)[0]
    ]
    if fmt == "csv":
        with open(path, "w", newline="") as f:
            if rows:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
    else:
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


# Stack of LIVE iteration_timer instances. A plain module-global stamp list
# let two sequential/nested timed fits interleave (and __enter__ cleared a
# concurrent timer's stamps). The io_callback fires on a JAX
# runtime thread, not the thread that entered the context, so a
# threading.local would never see the registration; a global stack with
# innermost-wins routing is correct for the supported pattern (one timed fit
# at a time; nested timers each keep their own stamps, the inner one
# receiving stamps while live). Two timed fits on concurrent THREADS remain
# unsupported (stamps would route to whichever timer is innermost).
_ACTIVE_TIMERS: list = []


def stamp_iteration(i) -> None:
    """Host-side sink for the optimizer's opt-in per-iteration timing
    callback (`SCGOptions.trace_timing`). Called from inside the compiled
    loop via an ordered io_callback, so stamps arrive in iteration order.
    Routed to the innermost live iteration_timer; dropped when none."""
    try:
        # snapshot-index rather than truthiness-then-[-1]: this runs on the
        # JAX runtime thread, racing a main-thread __exit__ remove()
        _ACTIVE_TIMERS[-1].stamps.append((int(i), time.perf_counter()))
    except IndexError:
        pass


class iteration_timer:
    """Collect REAL per-iteration wall times from a fit whose optimizer ran
    with ``trace_timing=True`` (SURVEY.md §5 metrics row: the reference
    prints true per-iteration timings; the fused loop needs an io_callback
    to observe them). Usage::

        with logging.iteration_timer() as it:
            result = fit(..., scg_options=SCGOptions(trace_timing=True))
        wall = it.wall_seconds()   # {iteration: seconds}

    The optimizer stamps once at loop entry (iteration -1, post-compile) and
    once per executed iteration; deltas between consecutive stamps are the
    per-iteration wall times, free of compile time. Stamps are scoped to
    THIS instance, so back-to-back timed fits (e.g. fit then infer_latents)
    each report their own iterations — PROVIDED the caller host-syncs the
    fit's outputs inside the block (read any result value, as cli.py does):
    with async dispatch, a fit whose callbacks are still in flight when the
    block exits would route its remaining stamps to whatever timer is live
    next."""

    def __init__(self):
        self.stamps: list = []

    def __enter__(self):
        self.stamps = []
        _ACTIVE_TIMERS.append(self)
        return self

    def __exit__(self, *exc):
        if self in _ACTIVE_TIMERS:
            _ACTIVE_TIMERS.remove(self)
        return False

    def wall_seconds(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        prev_t = None
        for i, t in self.stamps:
            if prev_t is not None and i >= 0:
                out[i] = t - prev_t
            prev_t = t
        return out


class Timer:
    """Wall-clock section timer for fit loops and benchmark harnesses (the
    reference wraps MapReduce passes in time.time() deltas)."""

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self._start: Dict[str, float] = {}

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.sections[name] = self.sections.get(name, 0.0) + dt
        return dt

    def summary(self) -> Dict[str, float]:
        return dict(self.sections)


def trace(log_dir: str):
    """Context manager: jax.profiler trace (Perfetto/XProf) around a block.

    Usage::
        with logging.trace('/tmp/trace'):
            fit(...)
    """
    import jax

    return jax.profiler.trace(log_dir)
