"""Span tracer of the port: a host-side ring buffer of trace events.
Counterpart: ``singa_tpu/telemetry/tracer.py``, whose events, export
and process-global slot it keeps.

* **Host-side only.** Recording an event is a tuple append into a
  bounded ``collections.deque``: no device work, no sync, no locks
  beyond the GIL, so a tracer cannot change what a captured step runs.
* **Bounded.** The ring keeps the most recent ``capacity`` events; older
  events are dropped (counted in :attr:`SpanTracer.dropped`).
* **Chrome-trace exportable.** :meth:`SpanTracer.export` writes the
  Chrome Trace Event JSON format (``{"traceEvents": [...]}``) that
  ``chrome://tracing`` and https://ui.perfetto.dev load, and that
  :func:`merge_chrome_traces` can union with a ``torch.profiler`` trace
  (the same format).  The events and lanes are the reference's, so the
  same calls export the same JSON but for ``otherData.tool``.

Timestamps are values of the tracer's ``clock`` (default
``time.perf_counter``, seconds); callers that know the interval pass
``t``/``t0``/``t1`` explicitly, the others let the tracer stamp it.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

# Process lanes in the exported trace (the reference's): training spans
# and instants on the host lane; the requests lane is the serving
# engine's, named in every export as the reference names it.
PID_HOST = 1  # training dispatch, checkpoints, watchdog and fault instants
PID_REQUESTS = 2  # per-request lifecycle; tid == rid

_Event = Tuple[str, str, str, float, float, int, Union[int, str], Optional[dict]]
#          (ph,  name, cat, t,     dur,   pid, tid,            args)


class SpanTracer:
    """Ring buffer of spans and instant events, Chrome-trace exportable.

    ``capacity`` bounds retained events (oldest dropped first); the
    default is the ``SINGA_TRACE_CAPACITY`` env var when set, else the
    pinned 65536 (one soak run showed drop accounting is the only
    signal when the ring saturates — size it to the run).  ``clock`` is
    only consulted when a caller does not supply timestamps explicitly.
    """

    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity is None:
            capacity = int(os.environ.get("SINGA_TRACE_CAPACITY", 0) or
                           SpanTracer.DEFAULT_CAPACITY)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._events: deque = deque(maxlen=self.capacity)
        self._appended = 0
        self._t0 = clock()  # export origin; ts are relative to first use

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        return self.clock()

    def span(self, name: str, t0: float, t1: float, *, pid: int = PID_HOST,
             tid: Union[int, str] = 0, cat: str = "host",
             args: Optional[dict] = None) -> None:
        """Record a complete span [t0, t1] (Chrome ``ph: "X"``)."""
        self._events.append(("X", name, cat, t0, max(0.0, t1 - t0), pid, tid, args))
        self._appended += 1

    def instant(self, name: str, *, t: Optional[float] = None,
                pid: int = PID_HOST, tid: Union[int, str] = 0,
                cat: str = "host", args: Optional[dict] = None) -> None:
        """Record a zero-duration instant event (Chrome ``ph: "i"``)."""
        if t is None:
            t = self.clock()
        self._events.append(("i", name, cat, t, 0.0, pid, tid, args))
        self._appended += 1

    def counter(self, name: str, values: Dict[str, float], *,
                t: Optional[float] = None, pid: int = PID_HOST,
                cat: str = "host") -> None:
        """Record a counter sample (Chrome ``ph: "C"``) — renders as a graph."""
        if t is None:
            t = self.clock()
        self._events.append(("C", name, cat, t, 0.0, pid, 0, dict(values)))
        self._appended += 1

    class _Timed:
        __slots__ = ("_tr", "_name", "_kw", "_t0")

        def __init__(self, tr: "SpanTracer", name: str, kw: dict):
            self._tr, self._name, self._kw = tr, name, kw

        def __enter__(self):
            self._t0 = self._tr.clock()
            return self

        def __exit__(self, *exc):
            self._tr.span(self._name, self._t0, self._tr.clock(), **self._kw)
            return False

    def timed(self, name: str, **kw) -> "SpanTracer._Timed":
        """``with tracer.timed("phase"): ...`` — span over the block."""
        return SpanTracer._Timed(self, name, kw)

    # -- introspection / export -------------------------------------------

    @property
    def n_events(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events displaced from the ring by newer ones."""
        return self._appended - len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._appended = 0

    def spans(self, name: Optional[str] = None
              ) -> List[Tuple[str, float, float]]:
        """Retained complete spans as ``(name, t0, dur_s)`` tuples,
        optionally filtered by name (the checkpoint spans' durations,
        for instance)."""
        return [(n, t, dur) for ph, n, _, t, dur, _, _, _ in self._events
                if ph == "X" and (name is None or n == name)]

    def to_chrome(self) -> dict:
        """Render the ring as a Chrome Trace Event JSON object.

        ``ts``/``dur`` are microseconds relative to tracer construction, as
        the format requires.  Metadata events name the process lanes so
        Perfetto shows "host" / "requests" instead of bare pids.
        """
        t0 = self._t0
        out: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": PID_HOST, "tid": 0,
             "ts": 0, "args": {"name": "singa_tpu host"}},
            {"ph": "M", "name": "process_name", "pid": PID_REQUESTS, "tid": 0,
             "ts": 0, "args": {"name": "serving requests"}},
        ]
        for ph, name, cat, t, dur, pid, tid, args in self._events:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": cat,
                "ts": round((t - t0) * 1e6, 3),
                "pid": pid, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args is not None:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "singa_tpu_torch.telemetry",
                "events": len(self._events),
                "dropped": self.dropped,
            },
        }

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` and return the path."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path


def merge_chrome_traces(*sources: Union[str, dict, list]) -> dict:
    """Union several Chrome traces (paths, ``{"traceEvents": ...}`` dicts, or
    bare event lists) into one loadable trace.

    This is how a host-side :class:`SpanTracer` export and a
    ``torch.profiler`` device trace (the same format) are viewed on one
    timeline.
    Events are concatenated verbatim — pids from different sources are kept
    distinct by the format itself.
    """
    events: List[dict] = []
    for src in sources:
        if isinstance(src, str):
            with open(src) as fh:
                src = json.load(fh)
        if isinstance(src, dict):
            chunk = src.get("traceEvents")
        else:
            chunk = src
        if not isinstance(chunk, list):
            raise ValueError("trace source has no traceEvents list")
        events.extend(chunk)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- process-global tracer (opt-in) ---------------------------------------
#
# Training-side instrumentation (checkpoints, watchdogs, fault plans) has
# no natural object to hang a tracer on, so a single process-global slot
# is provided.  It is None unless the user
# installs a tracer; every probe site guards on that, keeping the untraced
# path at zero cost.

_GLOBAL: Optional[SpanTracer] = None


def install(tracer: SpanTracer) -> SpanTracer:
    """Make ``tracer`` the process-global tracer (returned for chaining)."""
    global _GLOBAL
    _GLOBAL = tracer
    return tracer


def uninstall() -> Optional[SpanTracer]:
    """Remove and return the process-global tracer."""
    global _GLOBAL
    tr, _GLOBAL = _GLOBAL, None
    return tr


def current() -> Optional[SpanTracer]:
    """The installed process-global tracer, or None."""
    return _GLOBAL
