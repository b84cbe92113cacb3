"""Metrics registry of the port: labelled counters, gauges and
histograms with exporters.  Counterpart:
``singa_tpu/telemetry/registry.py``, whose data model, names and
exporters it keeps: the same calls give the same ``to_prometheus()`` and
``to_jsonl()`` text.

Publishers (``Device.record_step_time``, ``Communicator`` and
``DistOpt.publish_metrics``, the resilience checkpoint manager and
watchdogs) write into a registry; exporters render it as Prometheus
text exposition format or as JSONL (one sample per line).  Everything is
host-side Python, so publishing adds nothing to a step on the card.  The
registry is not thread-safe beyond the GIL's per-op atomicity.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram buckets, in milliseconds: latency-shaped, log-ish spacing
# covering sub-ms token gaps up to multi-second prefills/steps.
DEFAULT_BUCKETS_MS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
    200.0, 500.0, 1000.0, 2000.0, 5000.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus exposition-format label-value escaping."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Prometheus-style number formatting (ints without trailing .0)."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else format(f, ".10g")


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str], help: str = ""):
        self.name, self.labels, self.help = name, dict(labels), help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        self.value += amount


class Gauge:
    """Value that can go up and down (or be set directly)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str], help: str = ""):
        self.name, self.labels, self.help = name, dict(labels), help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` upper bounds)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str], help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self.name, self.labels, self.help = name, dict(labels), help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+Inf, count)."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), self.count))
        return out


class MetricsRegistry:
    """Holds metric children keyed by (name, labelset); creates on demand."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, _LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}
        self._helps: Dict[str, str] = {}

    def _get(self, cls, name: str, help: str, labels: Dict[str, str], **kw):
        kind = cls.kind
        have = self._kinds.get(name)
        if have is not None and have != kind:
            raise ValueError(
                f"metric {name!r} already registered as {have}, not {kind}")
        key = (name, _labelkey(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, labels, help=help, **kw)
            self._metrics[key] = m
            self._kinds[name] = kind
            if help:
                self._helps[name] = help
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- introspection -----------------------------------------------------

    def collect(self) -> List[object]:
        """All metric children, sorted by (name, labels) for stable output."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str, **labels):
        """Existing child or None (never creates)."""
        return self._metrics.get((name, _labelkey(labels)))

    def __len__(self) -> int:
        return len(self._metrics)

    # -- exporters ---------------------------------------------------------

    @staticmethod
    def _labelstr(labels: Dict[str, str], extra: str = "") -> str:
        # label VALUES are escaped per the exposition format (backslash,
        # double-quote, newline) — a program label like C8:"paged" must
        # not produce an unparseable line
        parts = [f'{k}="{_escape_label(v)}"'
                 for k, v in sorted(labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        seen_header = set()
        for m in self.collect():
            if m.name not in seen_header:
                seen_header.add(m.name)
                lines.append(f"# HELP {m.name} {self._helps.get(m.name, m.name)}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for le, c in m.cumulative():
                    le_s = "+Inf" if le == float("inf") else _fmt(le)
                    extra = 'le="%s"' % le_s
                    lines.append(
                        f"{m.name}_bucket{self._labelstr(m.labels, extra)} {c}")
                lines.append(f"{m.name}_sum{self._labelstr(m.labels)} {_fmt(m.sum)}")
                lines.append(f"{m.name}_count{self._labelstr(m.labels)} {m.count}")
            else:
                lines.append(f"{m.name}{self._labelstr(m.labels)} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def to_jsonl(self) -> str:
        """One JSON object per line: {name, kind, labels, ...sample fields}."""
        lines = []
        for m in self.collect():
            rec: Dict[str, object] = {
                "name": m.name, "kind": m.kind, "labels": m.labels,
            }
            if isinstance(m, Histogram):
                rec["sum"] = m.sum
                rec["count"] = m.count
                rec["buckets"] = [
                    {"le": ("+Inf" if le == float("inf") else le), "count": c}
                    for le, c in m.cumulative()
                ]
            else:
                rec["value"] = m.value
            lines.append(json.dumps(rec))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_prometheus())
        return path

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_jsonl())
        return path


# -- process-default registry ---------------------------------------------
#
# Library probe sites (Device step timing, the checkpoint manager and the
# watchdogs) publish here so they need no plumbing; `default_registry()`
# always exists, and recording into it is a dict lookup + float add.

_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Replace the default registry with a fresh one (tests)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry()
    return _DEFAULT
