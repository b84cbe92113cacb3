"""The request spans of the port's ServingEngine (``tracer=``,
``attach_tracer``), the training-side tracer probes (``Model``'s
``trace_compile`` / ``dispatch`` / ``block`` spans) and the log mirror
(``logging.LOG`` onto ``telemetry.tracer.current()``).

Held against the JAX package on the reference's robustness rig
(tests/test_serving_robustness.py: GPTConfig(50, 32, 2, 2, 64),
untrained, np.random.seed(0)), whose weights cross by
``from_jax_decode_params``.  Each stream runs on the JAX engine
(``admit_lanes=1, paged=True``, chunked) and on the port's with the
same requests and the same injected clock; per request, the sequence of
its lane's events (name, phase, pid, tid, cat and every argument but a
time) must be equal, and so must the set of ``req<rid>`` lifetime spans.
The preemption and ``max_queue`` stream runs at ``decode_horizon=1``,
where both engines take the same steps; at ``decode_horizon=4`` the
port runs a horizon where the reference runs one decode token after a
drained step (PERF.md, §6), so there the stream has no preemption or
deadline, and the per-request sequences, which do not depend on how
tokens are grouped into steps, are what is compared.  The JAX side of
every stream runs once per module (the ``jax_runs`` fixture).

The tracer is host code between the steps: attaching one to a warm
engine adds no graph key, no upload and no sync, and the tokens do not
move."""

import json

import numpy as np
import pytest
import torch

from singa_tpu import tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu.telemetry import SpanTracer as JaxTracer
from singa_tpu.telemetry import tracer as jtracer
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.telemetry import (PID_HOST, PID_REQUESTS, SpanTracer,
                                       tracer as ttracer)

torch.set_num_threads(1)

# the reference's device-call spans (singa_tpu/serving/engine.py)
REFERENCE_SPANS = {"unified_step", "decode_horizon", "mono_step",
                   "spec_round"}
# arguments that carry a time
TIME_ARGS = {"ttft_ms"}
PAGES = dict(paged=True, page_tokens=8, chunk_tokens=8)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def rig():
    """The reference's untrained robustness rig and the port's model
    from its decode pytree."""
    import jax

    cfg = jgpt.GPTConfig(vocab_size=50, d_model=32, n_layers=2, n_heads=2,
                         max_len=64, use_rope=False)
    np.random.seed(0)
    m = jgpt.GPT(cfg)
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32))],
              is_train=False, use_graph=False)
    m.eval()
    jgpt.ensure_decode_ready(m)
    tree = jax.tree.map(np.asarray, m.decode_params())
    tm = tgpt.GPT.from_jax_decode_params(
        tree, tgpt.GPTConfig(50, 32, 2, 2, 64, use_rope=False), device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 13, 6, 20, 40)]
    return m, tm, prompts


def _engine(rig, port, **kw):
    m, tm, _ = rig
    if port:
        return TorchEngine(tm, device="cpu", **kw)
    return JaxEngine(m, admit_lanes=1, **kw)


def _drive(eng, clk):
    while eng.queue or eng.kv.active_slots or eng.inflight_admissions:
        clk.t += 0.001
        eng.step()


def stream_lifecycle(rig, port):
    """decode_horizon=1, two slots, preemption on, ``max_queue=2``: two
    low-priority requests live; a high-priority arrival, a low-priority
    one, a third refused with the queue full and a fourth of higher
    priority that sheds the newest queued one; the two high-priority
    requests preempt both live ones, which restore later."""
    p = rig[2]
    clk = Clock()
    tr = SpanTracer() if port else JaxTracer()
    eng = _engine(rig, port, n_slots=2, decode_horizon=1, preemption=True,
                  max_queue=2, clock=clk, tracer=tr, **PAGES)
    rids = [eng.submit(p[0], 10), eng.submit(p[1], 10)]
    for _ in range(4):
        clk.t += 0.001
        eng.step()
    rids.append(eng.submit(p[2], 8, priority=1))
    rids.append(eng.submit(p[3], 6))
    rids.append(eng.submit(p[4], 6))            # queue full: refused
    rids.append(eng.submit(p[3], 6, priority=2))  # sheds the newest
    _drive(eng, clk)
    return _observed(eng, tr, rids)


def stream_horizon(rig, port):
    """decode_horizon=4, two slots: four requests, two submitted, two
    steps, two more, run to the end."""
    p = rig[2]
    clk = Clock()
    tr = SpanTracer() if port else JaxTracer()
    eng = _engine(rig, port, n_slots=2, decode_horizon=4, preemption=False,
                  clock=clk, tracer=tr, **PAGES)
    rids = [eng.submit(p[i], 12) for i in (0, 1)]
    for _ in range(2):
        clk.t += 0.001
        eng.step()
    rids += [eng.submit(p[i], 12) for i in (2, 4)]
    _drive(eng, clk)
    return _observed(eng, tr, rids)


def _observed(eng, tr, rids):
    events = tr.to_chrome()["traceEvents"]
    lanes = {r: [] for r in rids}
    for e in events:
        if e.get("pid") == PID_REQUESTS and e["ph"] != "M":
            args = {k: v for k, v in (e.get("args") or {}).items()
                    if k not in TIME_ARGS}
            lanes.setdefault(e["tid"], []).append(
                (e["name"], e["ph"], e["pid"], e["cat"], args))
    return {"lanes": lanes,
            "req_spans": sorted(e["tid"] for e in events
                                if e["ph"] == "X" and e["pid"] == PID_REQUESTS
                                and e["name"].startswith("req")),
            "serve_spans": sorted({e["name"] for e in events
                                   if e["ph"] == "X"
                                   and e["pid"] == PID_HOST}),
            "ttft": [e["args"]["ttft_ms"] for e in events
                     if e["name"] == "first_token"],
            "status": {r: eng.requests[r].status.value for r in rids},
            "tokens": {r: list(eng.requests[r].tokens) for r in rids}}


STREAMS = {"lifecycle": stream_lifecycle, "horizon": stream_horizon}


@pytest.fixture(scope="module")
def jax_runs(rig):
    return {name: s(rig, False) for name, s in STREAMS.items()}


@pytest.fixture(scope="module")
def port_runs(rig):
    return {name: s(rig, True) for name, s in STREAMS.items()}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_request_lane_events_match_jax(port_runs, jax_runs, stream):
    out, want = port_runs[stream], jax_runs[stream]
    assert out["status"] == want["status"]
    assert out["tokens"] == want["tokens"]
    assert out["lanes"] == want["lanes"]
    for r, lane in out["lanes"].items():
        names = [ev[0] for ev in lane]
        assert names[0] == "queued" and names[-2:] == ["terminal", f"req{r}"]
    assert len(out["ttft"]) == len(want["ttft"])


def test_lifecycle_stream_preempts_and_sheds(port_runs):
    """The stream the lifecycle comparison rests on has what it claims:
    preemptions, restores, a refusal and a shed."""
    out = port_runs["lifecycle"]
    r0, r1, r2, r3, r4, r5 = sorted(out["status"])
    names = {r: [ev[0] for ev in lane] for r, lane in out["lanes"].items()}
    # the two high-priority arrivals preempt both low-priority requests
    for r in (r0, r1):
        assert names[r].count("preempted") == 1
        assert names[r].count("admitted") == 2
        assert out["status"][r] == "PREEMPTED_RESTORED"
    assert out["status"][r4] == out["status"][r3] == "REJECTED"
    causes = {r: out["lanes"][r][-1][4]["cause"] for r in (r3, r4)}
    assert causes == {r3: f"admission overload: shed for higher-priority "
                          f"rid{r5}",
                      r4: "admission overload: queue full"}
    for r in (r3, r4):
        assert names[r] == ["queued", "terminal", f"req{r}"]


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_req_span_tids_match_jax(port_runs, jax_runs, stream):
    out, want = port_runs[stream], jax_runs[stream]
    assert out["req_spans"] == want["req_spans"] == sorted(out["status"])


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_device_call_spans_are_the_references(port_runs, jax_runs, stream):
    out, want = port_runs[stream], jax_runs[stream]
    assert set(out["serve_spans"]) <= REFERENCE_SPANS
    assert out["serve_spans"] == want["serve_spans"]
    assert ("decode_horizon" in out["serve_spans"]) == (stream == "horizon")


def test_mono_step_span(rig):
    """The monolithic engine's one span a step, ``mono_step``, with the
    reference's arguments."""
    _, tm, p = rig
    tr = SpanTracer()
    eng = TorchEngine(tm, device="cpu", n_slots=2, paged=False,
                      chunked=False, tracer=tr)
    rids = [eng.submit(p[i], 6) for i in (0, 1, 2)]
    eng.run()
    spans = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "X"
             and e["pid"] == PID_HOST]
    assert {e["name"] for e in spans} == {"mono_step"}
    assert all(set(e["args"]) == {"decode_slots", "admitted"}
               for e in spans)
    assert sum(e["args"]["admitted"] for e in spans) == 3
    assert sorted(e["tid"] for e in tr.to_chrome()["traceEvents"]
                  if e["name"].startswith("req")) == rids


# ---- the tracer on a warm engine -----------------------------------------

def _serve_once(eng, p):
    """The stream once on ``eng``, counted from drained mirrors (a run
    can end with a no-op horizon block in flight, which the next run's
    first step would fetch)."""
    eng._drain_horizon()
    up, sy = eng.metrics.host_uploads, eng.metrics.host_syncs
    rids = [eng.submit(p[i], 12) for i in (0, 1)]
    eng.step()
    eng.step()
    rids += [eng.submit(p[i], 12) for i in (2, 4)]
    res = eng.run()
    return ([res[r].tolist() for r in rids],
            eng.metrics.host_uploads - up, eng.metrics.host_syncs - sy)


@pytest.mark.parametrize("layout", ["pages", "slots"])
def test_attach_tracer_on_warm_engine_changes_nothing(rig, layout):
    """The same stream untraced, then traced on the same warm engine,
    then untraced again: the same tokens, graph keys, uploads and syncs;
    the trace holds every request's whole lifecycle and loads back from
    its Chrome JSON."""
    _, tm, p = rig
    kw = PAGES if layout == "pages" else dict(paged=False, chunk_tokens=8)
    eng = TorchEngine(tm, device="cpu", n_slots=2, decode_horizon=4, **kw)
    _serve_once(eng, p)     # warm: the prefix index holds the prompts
    first = _serve_once(eng, p)
    keys = list(eng.trace_log)
    tr = SpanTracer()
    eng.attach_tracer(tr)
    traced = _serve_once(eng, p)
    eng.attach_tracer(None)
    n = tr.n_events
    again = _serve_once(eng, p)
    assert first == traced == again
    assert eng.trace_log == keys
    assert tr.n_events == n                 # detached: nothing recorded
    events = json.loads(json.dumps(tr.to_chrome()))["traceEvents"]
    rids = sorted({e["tid"] for e in events
                   if e.get("pid") == PID_REQUESTS and e["ph"] != "M"})
    assert len(rids) == 4
    for r in rids:
        names = {e["name"] for e in events
                 if e.get("pid") == PID_REQUESTS and e["tid"] == r}
        assert {"queued", "admitted", "first_token", "token", "terminal",
                "prefill_chunk", f"req{r}"} <= names


def test_chrome_export_loads_back(rig, tmp_path):
    _, tm, p = rig
    tr = SpanTracer()
    eng = TorchEngine(tm, device="cpu", n_slots=2, decode_horizon=4,
                      tracer=tr, **PAGES)
    rid = eng.submit(p[0], 8)
    eng.run()
    with open(tr.export(str(tmp_path / "trace.json"))) as f:
        doc = json.load(f)
    assert doc["otherData"]["events"] == tr.n_events
    assert doc["otherData"]["dropped"] == 0
    spans = [e for e in doc["traceEvents"] if e["name"] == f"req{rid}"]
    assert len(spans) == 1 and spans[0]["args"]["status"] == "COMPLETED"
    assert spans[0]["args"]["tokens"] == 8


def test_engine_takes_the_global_tracer(rig):
    _, tm, _ = rig
    tr = ttracer.install(SpanTracer())
    try:
        eng = TorchEngine(tm, device="cpu", n_slots=1, **PAGES)
    finally:
        ttracer.uninstall()
    assert eng.tracer is tr
    eng.attach_tracer(None)
    assert eng.tracer is None
    assert TorchEngine(tm, device="cpu", n_slots=1, **PAGES).tracer is None


# ---- the training-side probes ----------------------------------------------

def _tiny_mlp(pkg):
    if pkg == "port":
        from singa_tpu_torch import autograd, device, layer, opt
        from singa_tpu_torch import tensor as ptensor
        from singa_tpu_torch.model import Model
        dev = device.create_cpu_device()
    else:
        from singa_tpu import autograd, layer, opt
        from singa_tpu import tensor as ptensor
        from singa_tpu.model import Model
        dev = None

    class TinyMLP(Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(4)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    np.random.seed(0)
    xs = [np.random.randn(n, 4).astype(np.float32) for n in (8, 8, 8, 6)]
    ys = [np.random.randint(0, 4, len(x)).astype(np.int32) for x in xs]
    wrap = ((lambda a: ptensor.from_numpy(a, dev)) if dev is not None
            else ptensor.from_numpy)
    m = TinyMLP()
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([wrap(xs[0])], is_train=True, use_graph=True)
    return m, [(wrap(x), wrap(y)) for x, y in zip(xs, ys)], dev


def _train_spans(pkg, steps, verbosity=0):
    mod = ttracer if pkg == "port" else jtracer
    tr = mod.install(SpanTracer() if pkg == "port" else JaxTracer())
    dev = None
    try:
        m, batches, dev = _tiny_mlp(pkg)
        if verbosity:
            dev.SetVerbosity(verbosity)
        for x, y in batches[:steps]:
            m.train_one_batch(x, y)
    finally:
        mod.uninstall()
        if verbosity and dev is not None:
            dev.SetVerbosity(0)
    return [e["name"] for e in tr.to_chrome()["traceEvents"]
            if e["ph"] == "X"]


@pytest.mark.parametrize("steps", [2, 3])
def test_model_dispatch_spans_match_jax(steps):
    """The reference's test_model_dispatch_emits_spans: one
    ``trace_compile`` for the step's input signature, one ``dispatch`` a
    step, on the port as on the JAX package."""
    got, want = _train_spans("port", steps), _train_spans("jax", steps)
    for name in ("trace_compile", "dispatch"):
        assert got.count(name) == want.count(name)
    assert got.count("trace_compile") == 1
    assert got.count("dispatch") == steps


def test_trace_compile_once_per_graph_key():
    """The port builds a step per input shape (a CUDA graph is captured
    for fixed shapes), so the fourth batch's 6 rows build a second one:
    a second ``trace_compile``.  The reference's step cache is keyed by
    the static arguments only (its jit retraces a new shape inside
    ``dispatch``), so this count is the port's own."""
    names = _train_spans("port", 4)
    assert names.count("trace_compile") == 2
    assert names.count("dispatch") == 4
    assert names.index("trace_compile", 1) == 4


def test_dispatch_and_block_at_verbosity_one():
    names = _train_spans("port", 2, verbosity=1)
    assert names.count("dispatch") == names.count("block") == 2
    assert names.count("trace_compile") == 1


def test_log_instants_match_jax():
    """Every log line lands as a ``log`` instant with the reference's
    arguments (level and the first 200 characters of the message)."""
    from singa_tpu import logging as jlog
    from singa_tpu_torch import logging as tlog
    got = []
    for mod, log, tr in ((ttracer, tlog, SpanTracer()),
                         (jtracer, jlog, JaxTracer())):
        mod.install(tr)
        try:
            log.LOG(log.INFO, "step %d loss %.3f", 3, 0.25)
            log.LOG(log.WARNING, "x" * 300)
            log.VLOG(5, "not shown")
            log.LOG(log.ERROR, "bad %s", ("fmt", "args"))
        finally:
            mod.uninstall()
        got.append([(e["name"], e["cat"], e["pid"], e["args"])
                    for e in tr.to_chrome()["traceEvents"]
                    if e["ph"] == "i"])
    assert got[0] == got[1]
    assert [a["level"] for *_, a in got[0]] == ["INFO", "WARNING", "ERROR"]
    assert got[0][1][3]["msg"] == "x" * 200
