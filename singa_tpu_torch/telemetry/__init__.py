"""The port's telemetry, training half.  Counterpart:
``singa_tpu/telemetry/`` (its tracer and registry).

* :class:`SpanTracer` — a bounded ring of spans and instants, exported
  as Chrome-trace JSON and mergeable with a ``torch.profiler`` trace
  (:func:`merge_chrome_traces`); ``install``/``uninstall``/``current``
  hold the process-global tracer the training side records into.
* :class:`MetricsRegistry` — labelled counters, gauges and histograms
  with Prometheus-text and JSONL exporters; ``default_registry()`` is
  the one ``Device.record_step_time`` (``train_step_time_ms``), the
  checkpoint manager and the watchdogs publish into, and
  ``Communicator``/``DistOpt.publish_metrics`` default to.

Host-side Python only: nothing here touches the card.  The serving half
(``flight.py``, ``ServingEngine(tracer=)``) and ``profiling.py`` belong
to later slices (ROADMAP.md queue 1, items 9 and 12).
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
]
