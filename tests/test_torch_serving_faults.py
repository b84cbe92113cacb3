"""Fault injection in the port's ServingEngine (singa_tpu_torch.serving
.faults under ``ServingEngine(faults=)``): the allocator refusing
admissions, injected non-finite tokens, latency spikes under the step
budget and dropped callbacks, each fired fault on the tracer and in the
flight recorder, and the plans ``FaultPlan.random`` / ``split_seeds`` /
``random_fleet`` draw.

Held against the JAX package on the reference's robustness rig
(tests/test_serving_robustness.py: GPTConfig(50, 32, 2, 2, 64),
untrained, np.random.seed(0)), whose weights cross by
``from_jax_decode_params``.  The deterministic chaos cases of the
reference (tests/test_serving_robustness.py and
tests/test_telemetry.py) run on the JAX engine (``admit_lanes=1,
paged=True``, chunked) and on the port's with the same plan, stream and
injected clock; statuses, causes, the plan's events and the tokens of
the requests the faults spare must be equal.  The JAX side of every
case runs once per module (the ``jax_runs`` fixture).

An injected non-finite token is a host-side fact: the device row is
still live, so the request ends through the kill, which stops the slot
before its rows or pages reach a new owner.  The regrant test holds the
next owner's tokens to an uninterrupted run's."""

import numpy as np
import pytest
import torch

from singa_tpu import tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu.serving import faults as jfaults
from singa_tpu.telemetry import SpanTracer as JaxTracer
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import (DropCallback, ExhaustAllocator,
                                     FaultPlan, LatencySpike, NaNLogits,
                                     ReplicaLoss, ReplicaStall)
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.telemetry import PID_REQUESTS, SpanTracer

torch.set_num_threads(1)

# the reference's chaos cases run at decode_horizon=1 on two slots
CHAOS_KW = dict(n_slots=2, decode_horizon=1, paged=True, page_tokens=8,
                chunk_tokens=8)


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
    return JaxEngine(m, admit_lanes=1, preemption=False, **kw)


def _plan(port, *specs, **kw):
    """The same plan in the port's classes or the reference's."""
    mod = None if port else jfaults
    out = []
    for s in specs:
        cls = type(s) if port else getattr(mod, type(s).__name__)
        out.append(cls(*vars(s).values()))
    return (FaultPlan if port else jfaults.FaultPlan)(*out, **kw)


def _outcome(eng, plan, rids):
    return {"status": {r: eng.requests[r].status.value for r in rids},
            "cause": {r: eng.postmortem(r)["cause"] for r in rids},
            "tokens": {r: list(eng.requests[r].tokens) for r in rids},
            "events": list(plan.events),
            "postmortems": [(p["rid"], p["status"], p["cause"])
                            for p in plan.postmortems],
            "attempts": plan.attempts}


# ---- the reference's deterministic chaos cases ---------------------------

def case_alloc(rig, port):
    """tests/test_serving_robustness.py:282: admission attempts 1..3
    refused; the queue backs up, then drains COMPLETED."""
    p = rig[2]
    plan = _plan(port, ExhaustAllocator(at_admission=1, count=3))
    eng = _engine(rig, port, faults=plan, **CHAOS_KW)
    rids = [eng.submit(q, 8) for q in p[:3]]
    eng.run()
    return _outcome(eng, plan, rids)


def case_nan_drop(rig, port):
    """:298: an injected non-finite token fails its request at its
    token index; a dropped delivery loses one callback while the
    engine's record stays complete."""
    p = rig[2]
    plan = _plan(port, NaNLogits(rid=0, at_token=3),
                 DropCallback(rid=1, at_token=1))
    eng = _engine(rig, port, faults=plan, **CHAOS_KW)
    seen = {}

    def on_token(r, t):
        seen.setdefault(r, []).append(t)

    ra = eng.submit(p[0], 10, on_token=on_token)
    rb = eng.submit(p[1], 10, on_token=on_token)
    eng.run()
    return dict(_outcome(eng, plan, [ra, rb]), seen=seen,
                kills=eng.metrics.host_kill_uploads)


def case_spike(rig, port):
    """:325: a persistent injected latency against a fake clock: every
    step blows the budget; the wedged prefill ends FAILED."""
    p = rig[2]
    clk = Clock()
    plan = _plan(port, LatencySpike(at_step=0, ms=50, count=999),
                 sleep=lambda s: setattr(clk, "t", clk.t + s))
    eng = _engine(rig, port, clock=clk, faults=plan, step_budget_ms=1.0,
                  max_slow_steps=2, **dict(CHAOS_KW, chunk_tokens=4))
    rid = eng.submit(p[4], 8)
    eng.run()
    return dict(_outcome(eng, plan, [rid]),
                slow_steps=eng.metrics.snapshot()["slow_steps"],
                strikes=eng.requests[rid].slow_strikes, clock=clk.t)


def case_traced(rig, port):
    """tests/test_telemetry.py:492: the fired fault is an instant on the
    victim's lane and in its postmortem; a clean replay of the spared
    request reproduces it."""
    p = rig[2]
    tr = SpanTracer() if port else JaxTracer()
    plan = _plan(port, NaNLogits(rid=0, at_token=3))
    eng = _engine(rig, port, faults=plan, tracer=tr, **CHAOS_KW)
    ra = eng.submit(p[0], 10)
    rb = eng.submit(p[1], 10)
    eng.run()
    faults = [{k: e[k] for k in ("pid", "tid", "cat", "args")}
              for e in tr.to_chrome()["traceEvents"] if e["name"] == "fault"]
    pm = eng.postmortem(ra)
    rb2 = eng.submit(p[1], 10)
    eng.run()
    return dict(_outcome(eng, plan, [ra, rb, rb2]), faults=faults,
                pm_events=[(e["kind"], e["detail"]) for e in pm["events"]])


CASES = {"alloc": case_alloc, "nan_drop": case_nan_drop,
         "spike": case_spike, "traced": case_traced}


@pytest.fixture(scope="module")
def jax_runs(rig):
    m, _, prompts = rig
    out = {name: case(rig, False) for name, case in CASES.items()}
    out["generate"] = {i: np.asarray(m.generate(prompts[i], 10)[0])
                       for i in (0, 1, 2)}
    return out


@pytest.fixture(scope="module")
def port_runs(rig):
    return {name: case(rig, True) for name, case in CASES.items()}


@pytest.mark.chaos
def test_allocator_exhaustion_backs_up_then_serves(port_runs, jax_runs):
    out, want = port_runs["alloc"], jax_runs["alloc"]
    assert out == want
    assert out["events"] == [f"alloc_exhausted:attempt{i}"
                             for i in (1, 2, 3)]
    assert set(out["status"].values()) == {"COMPLETED"}
    for i, r in enumerate(sorted(out["tokens"])):
        np.testing.assert_array_equal(out["tokens"][r][:8],
                                      jax_runs["generate"][i][:8])
    assert out["postmortems"] == []


@pytest.mark.chaos
def test_nan_logits_and_dropped_callback(port_runs, jax_runs):
    out, want = port_runs["nan_drop"], jax_runs["nan_drop"]
    ra, rb = sorted(out["status"])
    assert {k: out[k] for k in ("status", "cause", "tokens", "events",
                                "postmortems", "seen")} == \
        {k: want[k] for k in ("status", "cause", "tokens", "events",
                              "postmortems", "seen")}
    assert out["status"] == {ra: "FAILED", rb: "COMPLETED"}
    assert out["cause"][ra] == "injected fault: nan_logits at token 3"
    assert len(out["tokens"][ra]) == 3
    np.testing.assert_array_equal(out["tokens"][rb],
                                  jax_runs["generate"][1])
    assert len(out["seen"][rb]) == 9 and len(out["tokens"][rb]) == 10
    assert out["events"] == ["nan_logits:rid0:tok3",
                             "callback_dropped:rid1:tok1"]
    # the victim's device row was live: one kill stopped it
    assert out["kills"] == 1


@pytest.mark.chaos
def test_latency_spike_trips_step_budget(port_runs, jax_runs):
    out, want = port_runs["spike"], jax_runs["spike"]
    assert out == want
    (rid,) = out["status"]
    assert out["status"][rid] == "FAILED"
    assert out["cause"][rid] == "stall watchdog: 3 steps over the 1ms budget"
    assert out["slow_steps"] > 0 and out["strikes"] == 3
    assert out["events"][:3] == [f"latency_spike:step{i}" for i in range(3)]


@pytest.mark.chaos
def test_injected_fault_lands_on_tracer_and_postmortem(port_runs, jax_runs):
    out, want = port_runs["traced"], jax_runs["traced"]
    assert out == want
    ra, rb, rb2 = sorted(out["status"])
    assert out["faults"] == [{"pid": PID_REQUESTS, "tid": ra,
                              "cat": "fault",
                              "args": {"fault": "nan_logits:rid0:tok3"}}]
    assert out["cause"][ra] == "injected fault: nan_logits at token 3"
    assert ("fault", "nan_logits:rid0:tok3") in out["pm_events"]
    assert [p[0] for p in out["postmortems"]] == [ra]
    assert out["tokens"][rb] == out["tokens"][rb2]


# ---- plans ---------------------------------------------------------------

def _specs(plan):
    return [(type(f).__name__, tuple(vars(f).values())) for f in plan.faults]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_plan_equals_reference(seed):
    got = FaultPlan.random(seed, n_requests=5, n_steps=40)
    want = jfaults.FaultPlan.random(seed, n_requests=5, n_steps=40)
    assert _specs(got) == _specs(want) and len(got.faults) == 4
    assert FaultPlan.split_seeds(seed, 3) == \
        jfaults.FaultPlan.split_seeds(seed, 3)
    fleet = FaultPlan.random_fleet(seed, 3, n_requests=4, n_steps=20,
                                   n_faults=2)
    ref = jfaults.FaultPlan.random_fleet(seed, 3, n_requests=4, n_steps=20,
                                         n_faults=2)
    assert [_specs(p) for p in fleet] == [_specs(p) for p in ref]


def test_fleet_seams_fire_as_the_reference():
    """The fleet faults are host logic only (no engine reads them): the
    same answers and events as the reference's plan."""
    runs = []
    for mod_plan, loss, stall in (
            (FaultPlan, ReplicaLoss, ReplicaStall),
            (jfaults.FaultPlan, jfaults.ReplicaLoss, jfaults.ReplicaStall)):
        plan = mod_plan(loss(replica=1, at_step=3),
                        stall(replica=0, at_step=1, steps=2))
        answers = [(plan.replica_lost(r, s), plan.replica_stalled(r, s))
                   for s in range(5) for r in (0, 1)]
        runs.append((answers, plan.events))
    assert runs[0] == runs[1]
    assert runs[0][1] == ["replica_stall:r0:step1", "replica_stall:r0:step2",
                          "replica_loss:r1:step3", "replica_loss:r1:step4"]


def test_plan_binds_the_flight_recorder_and_follows_the_tracer(rig):
    _, tm, _ = rig
    plan = FaultPlan()
    eng = TorchEngine(tm, device="cpu", faults=plan, **CHAOS_KW)
    assert plan._recorder is eng.flight and plan._tracer is None
    tr = SpanTracer()
    eng.attach_tracer(tr)
    assert plan._tracer is tr and plan._recorder is eng.flight
    eng.attach_tracer(None)
    assert plan._tracer is None


# ---- an injected NaN whose slot and pages are granted again ----------------

# the victim (index 4: 20 prompt tokens) and a neighbour live in two slots;
# the next owner (index 5: 40 prompt tokens) waits for a slot and for the
# pages, and takes the victim's slot and pages when it is evicted
REGRANT = dict(n_slots=2, paged=True, page_tokens=8, chunk_tokens=8,
               decode_horizon=4, prefix_cache=False)
VICTIM, NEIGHBOUR, NEXT = 4, 1, 5
NEW = 16


@pytest.fixture(scope="module")
def regrant_generate(rig):
    """The JAX package's greedy ``generate`` of the three requests."""
    m, _, p = rig
    return {i: np.asarray(m.generate(p[i], NEW)[0])
            for i in (VICTIM, NEIGHBOUR, NEXT)}


@pytest.mark.chaos
@pytest.mark.parametrize("layout", ["pages", "slots"])
def test_injected_nan_mid_horizon_kills_before_regrant(rig, layout,
                                                       regrant_generate):
    """An injected NaN inside a horizon block ends the victim FAILED
    with the injected cause through one kill; the kill lands before the
    next owner's first chunk, so the next owner, in the victim's slot
    (and pages), decodes the tokens of an uninterrupted run, and the
    neighbour too.  Ending it as a real NaN (no kill) would leave the
    victim's row live on the device, writing into the next owner's
    rows.  The uninterrupted port run is the control for the kill; the
    JAX package's ``generate`` holds all three against the reference."""
    _, tm, p = rig
    kw = dict(REGRANT)
    if layout == "slots":
        kw = dict(kw, paged=False)
        del kw["page_tokens"], kw["prefix_cache"]
        ref = TorchEngine(tm, device="cpu", **kw)
    else:
        ref = TorchEngine(tm, device="cpu", **kw)
        # a pool that holds the two live requests and one page more: the
        # next owner needs the victim's pages
        need = [-(-(p[i].size + NEW) // 8) for i in (VICTIM, NEIGHBOUR)]
        kw["kv_pages"] = 1 + sum(need) + 1
    want = {i: ref.submit(p[i], NEW) for i in (VICTIM, NEIGHBOUR, NEXT)}
    ref_res = ref.run()
    plan = FaultPlan(NaNLogits(rid=0, at_token=5))
    eng = TorchEngine(tm, device="cpu", faults=plan, **kw)
    rv = eng.submit(p[VICTIM], NEW)
    rn = eng.submit(p[NEIGHBOUR], NEW)
    rx = eng.submit(p[NEXT], NEW)
    slot = pages = None
    while eng.requests[rv].status.value != "FAILED":
        eng.step()
        for s_, r in enumerate(eng._slot_req):
            if r is not None and r.rid == rv:
                slot = s_
                pages = (set(eng.kv.table_row(s_).tolist()) - {0}
                         if eng.paged else set())
    blocks = eng.metrics.snapshot()["horizon_blocks"]
    while eng._lane is None or eng._lane.req.rid != rx:
        eng.step()
    taken = (set(eng.kv.table_row(eng._lane.slot).tolist()) & pages
             if eng.paged else set())
    res = eng.run()
    assert blocks > 0               # the fault fired in a horizon block
    assert eng.requests[rv].status.value == "FAILED"
    assert eng.postmortem(rv)["cause"] == \
        "injected fault: nan_logits at token 5"
    assert len(eng.requests[rv].tokens) == 5
    assert eng.metrics.host_kill_uploads == 1
    assert plan.events == ["nan_logits:rid0:tok5"]
    assert [p_["rid"] for p_ in plan.postmortems] == [rv]
    # the next owner went where the victim was
    assert eng.requests[rx].status.value == "COMPLETED"
    assert eng.postmortem(rx)["events"][1]["detail"].startswith(
        f"slot={slot}")
    if eng.paged:
        assert len(taken) == len(pages) == need[0]
    np.testing.assert_array_equal(res[rx], ref_res[want[NEXT]])
    np.testing.assert_array_equal(res[rn], ref_res[want[NEIGHBOUR]])
    assert eng.requests[rv].tokens == list(ref_res[want[VICTIM]][:5])
    np.testing.assert_array_equal(res[rx], regrant_generate[NEXT])
    np.testing.assert_array_equal(res[rn], regrant_generate[NEIGHBOUR])
    assert eng.requests[rv].tokens == list(regrant_generate[VICTIM][:5])
