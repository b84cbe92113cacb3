"""The port's telemetry.  Counterpart: ``singa_tpu/telemetry/`` (its
tracer, registry and flight recorder).

* :class:`SpanTracer` — a bounded ring of spans and instants, exported
  as Chrome-trace JSON and mergeable with a ``torch.profiler`` trace
  (:func:`merge_chrome_traces`); ``install``/``uninstall``/``current``
  hold the process-global tracer the training side records into.
* :class:`MetricsRegistry` — labelled counters, gauges and histograms
  with Prometheus-text and JSONL exporters; ``default_registry()`` is
  the one ``Device.record_step_time`` (``train_step_time_ms``), the
  checkpoint manager and the watchdogs publish into, and
  ``Communicator``/``DistOpt.publish_metrics`` default to.
* :class:`FlightRecorder` — bounded per-request event histories and
  the postmortems ``ServingEngine.postmortem(rid)`` returns: each
  terminal's status, cause and the engine's state at the time.

The tracer's probes: ``ServingEngine(tracer=)`` / ``attach_tracer``
(each request's lifecycle on its lane, one span a step), ``Model``'s
``trace_compile`` / ``dispatch`` / ``block`` spans, each ``logging``
line as a ``log`` instant, the checkpoint spans and the fault plans'
``fault`` instants.

Host-side Python only: nothing here touches the card.  ``profiling.py``
(the cost catalog, the roofline/MFU gauges) and the ``python -m``
command line belong to a later slice (ROADMAP.md queue 1, item 12).
"""

from .tracer import (  # noqa: F401
    PID_HOST,
    PID_REQUESTS,
    SpanTracer,
    current,
    install,
    merge_chrome_traces,
    uninstall,
)
from .flight import FlightRecorder  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)

__all__ = [
    "SpanTracer", "install", "uninstall", "current", "merge_chrome_traces",
    "PID_HOST", "PID_REQUESTS",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "default_registry", "reset_default_registry", "DEFAULT_BUCKETS_MS",
    "FlightRecorder",
]
