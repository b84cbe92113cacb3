"""The port's telemetry, training half (singa_tpu_torch.telemetry:
the span tracer and the metrics registry), against the JAX package's on
the CPU, case for case with the tracer and registry units of
``tests/test_telemetry.py`` and its training-side probes: the same calls
give the same ``to_chrome()`` (the clock pinned; only ``otherData.tool``
names the package), ``to_prometheus()`` and ``to_jsonl()`` text;
``merge_chrome_traces`` joins the two packages' exports;
``Device.record_step_time`` feeds ``train_step_time_ms``; the
communicator's and DistOpt's ``publish_metrics`` set the reference's
gauges (the world-2 case runs in ``tests/test_torch_resilience.py``)."""

import json

import numpy as np
import pytest
import torch

from singa_tpu import telemetry as jtel
from singa_tpu_torch import telemetry as ttel
from singa_tpu_torch.telemetry import registry as tregistry
from singa_tpu_torch.telemetry import tracer as ttracer

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _record(mod):
    """The same tracer calls on either package's SpanTracer."""
    clk = Clock()
    tr = mod.SpanTracer(capacity=16, clock=clk)
    clk.t = 1.0
    tr.span("work", 1.0, 1.25, tid=7, args={"k": 3})
    tr.instant("tick", t=1.1, tid=7)
    tr.instant("fault", pid=mod.PID_HOST, cat="fault",
               args={"fault": "nan_grads:step3"})
    tr.counter("depth", {"queued": 2.0}, t=1.2)
    with tr.timed("phase", cat="train", args={"step": 2}):
        clk.t += 0.5
    tr.span("rid", 1.3, 1.9, pid=mod.PID_REQUESTS, tid=4)
    return tr


def test_chrome_export_equals_jax(tmp_path):
    port, jax_side = _record(ttel), _record(jtel)
    got, want = port.to_chrome(), jax_side.to_chrome()
    assert got["otherData"].pop("tool") == "singa_tpu_torch.telemetry"
    want["otherData"].pop("tool")
    assert got == want
    doc = json.load(open(port.export(str(tmp_path / "trace.json"))))
    assert doc["traceEvents"] == want["traceEvents"]
    assert port.spans("work") == jax_side.spans("work") == \
        [("work", 1.0, 0.25)]


def test_tracer_ring_and_drop_accounting():
    for mod in (ttel, jtel):
        tr = mod.SpanTracer(capacity=4, clock=Clock())
        for i in range(10):
            tr.instant(f"e{i}")
        assert (tr.n_events, tr.dropped) == (4, 6)
        tr.clear()
        assert tr.n_events == 0 and tr.dropped == 0
    with pytest.raises(ValueError):
        ttel.SpanTracer(capacity=0)


def test_tracer_timed_context_manager():
    clk = Clock()
    tr = ttel.SpanTracer(clock=clk)
    with tr.timed("phase", cat="test"):
        clk.t += 0.5
    span = [e for e in tr.to_chrome()["traceEvents"]
            if e.get("ph") == "X"][0]
    assert span["name"] == "phase" and span["cat"] == "test"
    assert span["dur"] == pytest.approx(0.5e6)


def test_merge_chrome_traces_joins_both_packages(tmp_path):
    p = _record(ttel).export(str(tmp_path / "port.json"))
    j = _record(jtel).export(str(tmp_path / "jax.json"))
    merged = ttel.merge_chrome_traces(
        p, j, {"traceEvents": [{"ph": "i", "name": "b", "ts": 0}]},
        [{"ph": "i", "name": "c", "ts": 0}])
    assert merged == {"traceEvents": (
        json.load(open(p))["traceEvents"] + json.load(open(j))["traceEvents"]
        + [{"ph": "i", "name": "b", "ts": 0},
           {"ph": "i", "name": "c", "ts": 0}]), "displayTimeUnit": "ms"}
    with pytest.raises(ValueError, match="traceEvents"):
        ttel.merge_chrome_traces({"nope": 1})


def test_global_install_uninstall():
    assert ttracer.current() is None
    tr = ttracer.install(ttel.SpanTracer())
    try:
        assert ttracer.current() is tr
    finally:
        assert ttracer.uninstall() is tr
    assert ttracer.current() is None


def _fill(mod):
    """The same registry calls on either package's MetricsRegistry."""
    reg = mod.MetricsRegistry()
    c = reg.counter("reqs_total", help="requests", route="a")
    c.inc()
    c.inc(2.5)
    reg.counter("reqs_total", route='b"q\\n').inc(1e16)
    g = reg.gauge("depth")
    g.set(5)
    g.dec(2)
    g.inc(0.25)
    h = reg.histogram("lat_ms", buckets=(1.0, 10.0), route="a")
    for v in (0.5, 5.0, 50.0, 10.0):
        h.observe(v)
    d = reg.histogram("train_step_time_ms", help="step", device="cuda:0")
    for v in (3.0, 97.5, 1e4):
        d.observe(v)
    reg.gauge("comm_calls", op="all_reduce", axis="data", run="x").set(3)
    return reg


def test_registry_exporters_equal_jax(tmp_path):
    port, jax_side = _fill(ttel), _fill(jtel)
    assert port.to_prometheus() == jax_side.to_prometheus()
    assert port.to_jsonl() == jax_side.to_jsonl()
    assert len(port) == len(jax_side) == 6
    port.write_prometheus(str(tmp_path / "m.prom"))
    port.write_jsonl(str(tmp_path / "m.jsonl"))
    assert (tmp_path / "m.prom").read_text() == jax_side.to_prometheus()
    rows = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == sorted(r["name"] for r in rows)
    assert ttel.MetricsRegistry().to_jsonl() == \
        jtel.MetricsRegistry().to_jsonl() == ""


def test_registry_counter_gauge_histogram():
    reg = ttel.MetricsRegistry()
    c = reg.counter("reqs_total", route="a")
    c.inc(3)
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1)
    assert reg.counter("reqs_total", route="a") is c
    assert reg.counter("reqs_total", route="b") is not c
    h = reg.histogram("lat_ms", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    assert h.cumulative() == [(1.0, 1), (10.0, 2), (float("inf"), 3)]
    assert reg.get("missing") is None
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("reqs_total")
    with pytest.raises(ValueError, match="bucket"):
        reg.histogram("empty_ms", buckets=())


def test_default_registry_reset():
    a = tregistry.default_registry()
    assert tregistry.default_registry() is a
    b = tregistry.reset_default_registry()
    assert b is not a and tregistry.default_registry() is b and len(b) == 0


def test_device_step_time_feeds_histogram():
    from singa_tpu_torch.device import create_cpu_device
    tregistry.reset_default_registry()
    dev = create_cpu_device(seed=0)
    dev.record_step_time(12.5)
    dev.record_step_time(3.0)
    h = tregistry.default_registry().get("train_step_time_ms",
                                         device=f"{dev.lang}:{dev.id}")
    assert h is not None and h.count == 2 and h.sum == pytest.approx(15.5)
    assert dev._step_times_ms == [12.5, 3.0]
    tregistry.reset_default_registry()


def test_model_steps_at_verbosity_1_feed_the_histogram():
    """``Model.train_one_batch`` at ``SetVerbosity(1)`` times every step
    into ``train_step_time_ms``, as the reference's dispatch does."""
    from singa_tpu_torch import autograd, layer, opt
    from singa_tpu_torch.device import create_cpu_device
    from singa_tpu_torch.model import Model
    from singa_tpu_torch.tensor import Tensor

    class Net(Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(3)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            loss = autograd.softmax_cross_entropy(self.forward(x), y)
            self.optimizer(loss)
            return loss

    dev = create_cpu_device(seed=0)
    x = np.ones((4, 5), np.float32)
    m = Net()
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([Tensor(data=x, device=dev)], is_train=True)
    tregistry.reset_default_registry()
    dev.SetVerbosity(1)
    try:
        for _ in range(3):
            m.train_one_batch(x, np.zeros(4, np.int32))
    finally:
        dev.SetVerbosity(0)
    h = tregistry.default_registry().get("train_step_time_ms",
                                         device="cpp:0")
    assert h.count == 3
    tregistry.reset_default_registry()


def test_publish_metrics_sets_the_reference_gauges():
    """World 1 (the default communicator, no group): DistOpt counts its
    all-reduces (identities there) and publishes them as the JAX
    package's gauge names, idempotently; the communicator issued none."""
    from singa_tpu import opt as jopt
    from singa_tpu_torch import opt as topt
    d = topt.DistOpt(topt.SGD(lr=0.1))
    g = torch.ones((4, 8))
    d.all_reduce(g)
    d.all_reduce(g)
    reg = ttel.MetricsRegistry()
    for _ in range(2):
        assert d.publish_metrics(reg, job="t") is reg
    assert reg.get("distopt_allreduce_calls", job="t").value == 2
    assert reg.get("distopt_allreduce_bytes", job="t").value == 2 * 128
    assert len(reg) == 2
    jd = jopt.DistOpt(jopt.SGD(lr=0.1))
    jd.all_reduce(np.ones((4, 8), np.float32))
    jd.all_reduce(np.ones((4, 8), np.float32))
    jreg = jtel.MetricsRegistry()
    jd.publish_metrics(jreg, job="t")
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert d.publish_metrics() is tregistry.default_registry()
