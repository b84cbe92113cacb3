"""Admission control in the port's ServingEngine (singa_tpu_torch.serving):
deadlines (queued, in prefill and live, a live slot stopped by the
kill), the bounded queue's shedding, the step-budget watchdog,
evacuate/adopt, the flight recorder's postmortems, the metrics'
robustness accounting and its publication, and callbacks that raise,
on pages (float32 and int8) and on slots.

Held against the JAX package on the reference's robustness rig
(tests/test_serving_robustness.py: GPTConfig(50, 32, 2, 2, 64), untrained,
np.random.seed(0)), whose weights cross by ``from_jax_decode_params``.
Each flow runs on the port and on the JAX engine with the same stream,
the same arguments and the same schedule of a fake metrics clock; the
tokens, statuses, causes, flight records (timestamps aside) and
robustness figures must be equal.  The JAX side of every flow runs once
per module (the ``jax_runs`` fixture), on the slot layout: what a flow
observes does not depend on the layout, which the port's runs on pages
show (on int8 pages too: this rig's greedy tokens are the float
engine's, as tests/test_torch_serving_lifecycle.py finds)."""

import numpy as np
import pytest
import torch

from singa_tpu import tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import EngineStalledError as JaxStalled
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu.telemetry import MetricsRegistry as JaxRegistry
from singa_tpu.telemetry.flight import FlightRecorder as JaxFlight
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import EngineStalledError
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.telemetry import (FlightRecorder, MetricsRegistry,
                                       SpanTracer)

torch.set_num_threads(1)

BASE = dict(chunk_tokens=8, decode_horizon=4)
LAYOUTS = {"pages": dict(paged=True, page_tokens=8),
           "pages_int8": dict(paged=True, page_tokens=8, kv_dtype="int8"),
           "slots": dict(paged=False)}


class Clock:
    """The metrics clock the flows advance by hand; with ``jump`` set,
    every read moves it on by ``jump`` seconds."""

    def __init__(self):
        self.t = 0.0
        self.jump = 0.0

    def __call__(self):
        self.t += self.jump
        return self.t


@pytest.fixture(scope="module")
def rig():
    """The reference's untrained robustness rig, the port's model from
    its decode pytree, and the flows' prompts."""
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


def _engines(rig, layout, **kw):
    """A factory of engines over the rig: ``make(clock)`` gives the
    JAX engine (``layout`` None: slots) or the port's."""
    m, tm, _ = rig

    def make(clock=None):
        if layout is None:
            return JaxEngine(m, admit_lanes=1, preemption=False,
                             clock=clock, **dict(LAYOUTS["slots"], **kw))
        return TorchEngine(tm, device="cpu", clock=clock,
                           **dict(LAYOUTS[layout], **kw))

    return make


# the page and slot state a flight record snapshots (compared where the
# layouts are the same)
LAYOUT_STATE = ("kv_bytes_live", "page_utilization")


def _outcome(eng, rids):
    """What a flow observes of its requests: tokens, statuses, and the
    flight records without timestamps (and without the layout's state
    on pages)."""
    return {"tokens": {r: list(eng.requests[r].tokens) for r in rids},
            "status": {r: eng.requests[r].status.value for r in rids},
            "records": {r: _record(eng.postmortem(r), eng.paged)
                        for r in rids}}


def _record(pm, paged=False):
    if pm is None:
        return None
    pm = {k: v for k, v in pm.items() if k != "t_close"
          and not (paged and k in LAYOUT_STATE)}
    pm["events"] = [(e["kind"], e["detail"]) for e in pm["events"]]
    return pm


SNAP_KEYS = ("submitted", "completed", "total_tokens", "rejected_count",
             "failed_count", "evicted_deadline_count", "cancelled_count",
             "preempted_restored_count", "preemption_count",
             "restore_count", "slow_steps", "callback_errors",
             "goodput_tokens", "deadline_requests", "deadline_miss_rate")
# read only where the flow's clock moves by hand alone
TIME_KEYS = ("ttft_p50_ms", "itl_p50_ms", "queue_wait_p50_ms",
             "goodput_tokens_per_s")


def _snap(eng, timing=False):
    snap = eng.metrics.snapshot()
    out = {k: snap[k] for k in SNAP_KEYS + (TIME_KEYS if timing else ())}
    out["host_kill_uploads"] = eng.metrics.host_kill_uploads
    return out


# ---- the flows -----------------------------------------------------------
# Each part drives an engine, the port's or the JAX one, the same way and
# returns what it observed.  A run is parts in order on one engine (one
# JAX engine compiles its steps once for all its parts).

def part_deadline_live(eng, clk, make):
    """Two greedy requests in steady-state horizons, one with a 50 ms
    deadline; the clock moves 1 s; a third request with a far deadline
    waits for a slot, which the sweep frees by evicting the overdue one
    live."""
    p = eng._flow_prompts
    ra = eng.submit(p[0], 24)
    rb = eng.submit(p[1], 20, deadline_ms=50.0)
    for _ in range(5):                  # both live, two horizons issued
        eng.step()
    clk.t += 1.0
    rn = eng.submit(p[5], 16, deadline_ms=1e6)
    eng.run()
    return dict(_outcome(eng, [ra, rb, rn]), snap=_snap(eng, timing=True),
                active=[bool(a) for a in np.asarray(
                    eng._dstate["active"])])


class _Boom(Exception):
    pass


def part_callbacks(eng, clk, make):
    """A request whose ``on_token`` raises at every token, one whose
    ``on_done`` raises, one with both callbacks sound."""
    p = eng._flow_prompts
    seen = []
    errors = eng.metrics.callback_errors

    def bad_token(rid, tok):
        raise _Boom("consumer gone")

    def bad_done(rid, status):
        raise _Boom("consumer gone")

    r0 = eng.submit(p[0], 10, on_token=bad_token)
    r1 = eng.submit(p[1], 10, on_done=bad_done)
    r2 = eng.submit(p[2], 10, on_token=lambda r, t: seen.append(t),
                    on_done=lambda r, s: seen.append(s))
    eng.run()
    return dict(_outcome(eng, [r0, r1, r2]), seen=seen,
                errors=eng.metrics.callback_errors - errors)


def part_deadline_queued_prefill(eng, clk, make):
    """One slot: a request overdue while queued behind a live one, then
    one overdue in prefill (the 40-token prompt, after the first of its
    five chunks), then a request served after both."""
    p = eng._flow_prompts
    ra = eng.submit(p[0], 6)
    rq = eng.submit(p[1], 6, deadline_ms=50.0)
    eng.step()
    clk.t += 1.0
    eng.run()
    rp = eng.submit(p[5], 6, deadline_ms=50.0)
    eng.step()
    lane_after_one = eng.inflight_admissions
    clk.t += 1.0
    eng.step()
    rz = eng.submit(p[2], 6)
    eng.run()
    return dict(_outcome(eng, [ra, rq, rp, rz]),
                snap=_snap(eng, timing=True), lane_after_one=lane_after_one)


def part_watchdog(eng, clk, make):
    """The 40-token prompt admitted in five chunks on a clock that moves
    10 ms at every read against a 1 ms budget: each step strikes the
    admission, which ends FAILED at its fourth strike; the clock stops
    and the next request is served."""
    p = eng._flow_prompts
    slow = eng.metrics.slow_steps
    clk.jump = 0.01
    rw = eng.submit(p[5], 8)
    steps = 0
    while eng.requests[rw].status.value in ("QUEUED", "RUNNING") \
            and steps < 10:
        eng.step()
        steps += 1
    clk.jump = 0.0
    rz = eng.submit(p[0], 12)
    eng.run()
    return dict(_outcome(eng, [rw, rz]), steps=steps,
                strikes=eng.requests[rw].slow_strikes,
                slow_steps=eng.metrics.slow_steps - slow)


def part_shed(eng, clk, make):
    """The reference's test_bounded_queue_sheds_lowest_priority: one
    slot, ``max_queue=2``; the third arrival is refused and a
    higher-priority fourth sheds the newest low-priority one."""
    p = eng._flow_prompts
    done = {}

    def cb(r, s):
        done.setdefault(r, s)

    a = eng.submit(p[0], 4, on_done=cb)
    b = eng.submit(p[1], 4, on_done=cb)
    c = eng.submit(p[0], 4, on_done=cb)        # queue full: refused
    d = eng.submit(p[1], 4, priority=1, on_done=cb)  # sheds b
    queued = [r.rid for r in eng.queue]
    eng.run()
    return dict(_outcome(eng, [a, b, c, d]), snap=_snap(eng), done=done,
                queued=queued)


def part_postmortems(eng, clk, make):
    """The reference's test_every_noncompleted_terminal_has_a_postmortem
    _cause flow: one slot, ``max_queue=2``, a request with a 50 ms
    deadline, an overflowing arrival, the clock moved 1 s; ``drain``."""
    p = eng._flow_prompts
    ra = eng.submit(p[0], 6)
    rb = eng.submit(p[1], 6, deadline_ms=50.0)
    rc = eng.submit(p[2], 6)
    for _ in range(3):
        eng.step()
    clk.t += 1.0
    eng.drain()
    return dict(_outcome(eng, [ra, rb, rc]), snap=_snap(eng, timing=True),
                registry=eng.publish_metrics(eng._flow_registry()))


def part_evacuate(a, clk, make):
    """Engine A: two requests live, one in prefill, one queued, then
    ``evacuate()``; engine B adopts each stranded request and runs to
    the end."""
    p = a._flow_prompts
    rids = [a.submit(p[i], 12) for i in (0, 1, 4, 3)]
    for _ in range(4):
        a.step()
    where = {"lane": a.inflight_admissions, "queued": len(a.queue),
             "live": int(a._active.sum())}
    stranded = a.evacuate()
    b = make()
    new = [b.adopt(r) for r in stranded]
    b.run()
    return {"stranded": [r.rid for r in stranded], "where": where,
            "emitted": [list(r.tokens) for r in stranded],
            "records": {r: _record(a.postmortem(r)) for r in rids},
            "b": _outcome(b, new), "b_snap": _snap(b),
            "free": (a.kv.free_slots, b.kv.free_slots, len(a.queue))}


def part_stall(eng, clk, make):
    """A queued request under a wedged ``step``: ``run()`` raises after
    ``stall_limit`` steps, having closed the request's flight record."""
    rid = eng.submit(eng._flow_prompts[0], 4)
    eng.step = lambda: True
    err = None
    try:
        eng.run()
    except (EngineStalledError, JaxStalled) as e:
        err = str(e)
    return {"err": err, "record": _record(eng.postmortem(rid)),
            "status": eng.requests[rid].status.value}


RUNS = {
    "live": (dict(BASE, n_slots=2), (part_deadline_live, part_callbacks)),
    # the reference's queue flows run at decode_horizon=1
    "one_slot": (dict(n_slots=1, max_queue=2, decode_horizon=1,
                      chunk_tokens=8, step_budget_ms=1.0, max_slow_steps=3),
                 (part_shed, part_postmortems, part_deadline_queued_prefill,
                  part_watchdog)),
    "evacuate": (dict(BASE, n_slots=3), (part_evacuate,)),
    "stall": (dict(BASE, n_slots=2, stall_limit=5), (part_stall,)),
}
# engine arguments a run adds on pages: the live-deadline pool, whose two
# requests take 8 of the 11 usable pages while the next owner needs 7,
# so it takes the evicted request's 4 and the 3 left
PAGES_EXTRA = {"live": dict(kv_pages=12, prefix_cache=False)}


def _run(rig, name, layout):
    """Run ``name`` on the JAX engine (``layout`` None) or the port's;
    returns ``({part name: outcome}, engine)``."""
    kw, parts = RUNS[name]
    if layout and layout.startswith("pages"):
        kw = dict(kw, **PAGES_EXTRA.get(name, {}))
    factory = _engines(rig, layout, **kw)

    def make(clock=None):
        eng = factory(clock)
        eng._flow_prompts = rig[2]
        eng._flow_registry = MetricsRegistry if layout else JaxRegistry
        return eng

    clk = Clock()
    eng = make(clk)
    return {part.__name__[5:]: part(eng, clk, make) for part in parts}, eng


@pytest.fixture(scope="module")
def jax_runs(rig):
    """Every run on the JAX engine once, and ``generate`` on the prompt
    the survivors' tokens are held to."""
    m, _, prompts = rig
    out = {name: _run(rig, name, None)[0] for name in RUNS}
    out["generate"] = np.asarray(m.generate(prompts[0], 24)[0])
    return out


@pytest.fixture(scope="module")
def port_runs(rig):
    """Every run on the port, on pages and on slots."""
    return {(name, layout): _run(rig, name, layout)
            for name in RUNS for layout in LAYOUTS}


# ---- deadlines ---------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_deadline_evicts_live_slot_next_owner_matches_jax(
        port_runs, jax_runs, layout):
    """The overdue request leaves the horizon and is evicted live
    through one kill, before its slot and pages reach the waiting
    request; the survivor equals ``generate``; the next owner, the
    evicted request's tokens, the statuses, the cause and the deadline
    figures equal the JAX engine's (goodput: both completions; one miss
    in two deadline-carrying terminals)."""
    out = port_runs["live", layout][0]["deadline_live"]
    want = jax_runs["live"]["deadline_live"]
    ra, rb, rn = sorted(out["status"])
    np.testing.assert_array_equal(out["tokens"][ra], jax_runs["generate"])
    assert out["tokens"] == want["tokens"]
    assert len(out["tokens"][rb]) == 9
    assert out["status"] == want["status"] == {
        ra: "COMPLETED", rb: "EVICTED_DEADLINE", rn: "COMPLETED"}
    assert out["records"][rb]["cause"] == \
        "deadline exceeded while decoding (overdue 950.0ms)"
    assert out["records"] == {r: v for r, v in want["records"].items()} \
        if layout == "slots" else all(
            out["records"][r] == {k: v for k, v in want["records"][r].items()
                                  if k not in LAYOUT_STATE}
            for r in out["records"])
    assert out["snap"] == want["snap"]
    assert out["snap"]["deadline_requests"] == 2
    assert out["snap"]["deadline_miss_rate"] == 0.5
    assert out["snap"]["goodput_tokens"] == 24 + 16
    assert out["snap"]["host_kill_uploads"] == 1
    assert out["active"] == [False, False]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_deadline_while_queued_and_in_prefill(port_runs, jax_runs, layout):
    """Overdue in the queue, then in prefill: both end EVICTED_DEADLINE
    with the JAX engine's causes, no token and no kill; the requests
    around them equal the JAX engine's."""
    out = port_runs["one_slot", layout][0]["deadline_queued_prefill"]
    want = jax_runs["one_slot"]["deadline_queued_prefill"]
    ra, rq, rp, rz = sorted(out["status"])
    assert _same(out, want)
    assert out["lane_after_one"] == 1
    assert out["status"] == {ra: "COMPLETED", rq: "EVICTED_DEADLINE",
                             rp: "EVICTED_DEADLINE", rz: "COMPLETED"}
    assert out["records"][rq]["cause"] == \
        "deadline exceeded while queued (overdue 950.0ms)"
    assert out["records"][rp]["cause"] == \
        "deadline exceeded while in prefill (overdue 950.0ms)"
    assert out["tokens"][rq] == out["tokens"][rp] == []
    assert out["snap"]["host_kill_uploads"] == 0


def test_deadline_far_keeps_the_horizons(rig):
    """Deadlines that never fall due change nothing: the same steps,
    graph keys, uploads and tokens as a stream without them."""
    _, tm, prompts = rig
    runs = []
    for dl in (None, 1e6):
        eng = TorchEngine(tm, device="cpu", n_slots=2, **BASE)
        rids = [eng.submit(prompts[i], 12, deadline_ms=dl) for i in (0, 1)]
        res = eng.run()
        snap = eng.metrics.snapshot()
        runs.append(([res[r].tolist() for r in rids], eng.trace_log,
                     {k: snap[k] for k in ("steps", "horizon_blocks",
                                           "host_uploads", "host_syncs")},
                     snap["deadline_requests"]))
    assert runs[0][:3] == runs[1][:3]
    assert (runs[0][3], runs[1][3]) == (0, 2)


def _same(out, want):
    """``out`` (the port's) equals ``want`` (the JAX engine's on slots),
    but for the layout's state in the flight records on pages and the
    last horizon's fill: after a drained step with nothing to admit the
    port runs a horizon where the reference runs one decode token, so
    the tokens and statuses agree while the blocks fill otherwise."""
    skip = LAYOUT_STATE + ("last_horizon_occupancy",)

    def strip(o):
        o = {k: v for k, v in o.items() if k != "registry"}
        o["records"] = {r: None if v is None else {
            k: x for k, x in v.items() if k not in skip}
            for r, v in o["records"].items()}
        return o
    return strip(out) == strip(want) and all(
        set(out["records"][r] or ()) <= set(want["records"][r] or ())
        for r in out["records"])


# ---- the bounded queue -------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bounded_queue_sheds_lowest_priority(port_runs, jax_runs, layout):
    """The reference's flow: the refused and the shed request end
    REJECTED with its causes, through ``on_done``, without a token; the
    two served equal the JAX engine's."""
    out = port_runs["one_slot", layout][0]["shed"]
    want = jax_runs["one_slot"]["shed"]
    a, b, c, d = sorted(out["status"])
    assert _same(out, want)
    assert out["status"] == {a: "COMPLETED", b: "REJECTED",
                             c: "REJECTED", d: "COMPLETED"}
    assert out["done"] == out["status"]
    assert out["queued"] == [d, a]
    assert out["records"][c]["cause"] == "admission overload: queue full"
    assert out["records"][b]["cause"] == \
        f"admission overload: shed for higher-priority rid{d}"
    assert out["tokens"][b] == out["tokens"][c] == []
    assert out["snap"]["rejected_count"] == 2


# ---- the step-budget watchdog -------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_budget_watchdog_fails_wedged_admission(port_runs, jax_runs,
                                                     layout):
    """Every step over budget strikes the in-flight admission: it ends
    FAILED at its fourth strike with the JAX engine's cause; the next
    request is served as ``generate`` serves it."""
    out = port_runs["one_slot", layout][0]["watchdog"]
    want = jax_runs["one_slot"]["watchdog"]
    rw, rz = sorted(out["status"])
    assert _same(out, want)
    assert (out["steps"], out["strikes"], out["slow_steps"]) == (4, 4, 4)
    assert out["status"] == {rw: "FAILED", rz: "COMPLETED"}
    assert out["records"][rw]["cause"] == \
        "stall watchdog: 4 steps over the 1ms budget"
    np.testing.assert_array_equal(out["tokens"][rz],
                                  jax_runs["generate"][:12])


# ---- evacuate and adopt ------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_evacuate_adopt_matches_jax(port_runs, jax_runs, layout):
    """Engine A strands two live requests, one in prefill and one
    queued, in rid order, each closed REROUTED; engine B adopts them
    under fresh rids and serves every one as the JAX flow does: the
    live ones restored (PREEMPTED_RESTORED, tokens equal to
    ``generate``), the others COMPLETED."""
    out = port_runs["evacuate", layout][0]["evacuate"]
    want = jax_runs["evacuate"]["evacuate"]
    assert {k: v for k, v in out.items() if k != "b"} == \
        {k: v for k, v in want.items() if k != "b"}
    assert _same(out["b"], want["b"])
    assert out["where"] == {"lane": 1, "queued": 1, "live": 2}
    assert out["stranded"] == [0, 1, 2, 3]
    assert [len(t) for t in out["emitted"]] == [4, 2, 0, 0]
    assert all(rec["status"] == "REROUTED" and rec["cause"] ==
               "replica lost" for rec in out["records"].values())
    new = sorted(out["b"]["status"])
    assert [out["b"]["status"][r] for r in new] == [
        "PREEMPTED_RESTORED", "PREEMPTED_RESTORED", "COMPLETED",
        "COMPLETED"]
    np.testing.assert_array_equal(out["b"]["tokens"][new[0]],
                                  jax_runs["generate"][:12])
    assert out["b_snap"]["restore_count"] == 2
    assert out["free"] == (3, 3, 0)


@pytest.mark.parametrize("call, slice_no", [
    (lambda e: e.steady_state_arg_spec(), 12)],
    ids=["steady_state_arg_spec"])
def test_later_slices_raise(rig, call, slice_no):
    """The analysis pass's contract belongs to a later slice and says
    which."""
    eng = TorchEngine(rig[1], device="cpu", n_slots=1, **BASE)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no} "):
        call(eng)


def test_attach_tracer_none_detaches(rig):
    """``attach_tracer(tracer)`` records the flow's lifecycle;
    ``attach_tracer(None)`` detaches, and the engine records nothing
    more."""
    _, tm, prompts = rig
    eng = TorchEngine(tm, device="cpu", n_slots=1, **BASE)
    tr = SpanTracer()
    eng.attach_tracer(tr)
    rid = eng.submit(prompts[0], 4)
    eng.run()
    n = tr.n_events
    names = [e[0] for e in tr.spans()]
    eng.attach_tracer(None)
    assert eng.tracer is None
    eng.submit(prompts[1], 4)
    eng.run()
    assert tr.n_events == n
    assert f"req{rid}" in names


def test_evacuate_needs_the_chunked_engine(rig):
    _, tm, prompts = rig
    mono = TorchEngine(tm, device="cpu", n_slots=2, paged=False,
                       chunked=False)
    mono.submit(prompts[0], 4)
    with pytest.raises(ValueError, match="chunked"):
        mono.evacuate()


def test_adopt_bypasses_max_queue(rig):
    """An adopted request was admitted once already: a full queue takes
    it anyway."""
    _, tm, prompts = rig
    a = TorchEngine(tm, device="cpu", n_slots=1, **BASE)
    for i in (0, 1, 2):
        a.submit(prompts[i], 4)
    stranded = a.evacuate()
    b = TorchEngine(tm, device="cpu", n_slots=1, max_queue=1, **BASE)
    new = [b.adopt(r) for r in stranded]
    assert len(b.queue) == 3
    res = b.run()
    assert sorted(res) == new
    assert b.metrics.snapshot()["rejected_count"] == 0


# ---- the flight recorder and the metrics -------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_postmortems_match_jax(port_runs, jax_runs, layout):
    """The reference's test_telemetry flow: every terminal has a
    postmortem whose status, cause, events and state snapshot equal the
    JAX engine's, timestamps aside (the KV bytes and page utilization
    on slots only: pages hold other bytes)."""
    out, eng = port_runs["one_slot", layout]
    out, want = out["postmortems"], jax_runs["one_slot"]["postmortems"]
    ra, rb, rc = sorted(out["status"])
    assert out["status"] == {ra: "COMPLETED", rb: "EVICTED_DEADLINE",
                             rc: "REJECTED"}
    assert _same(out, want)
    if layout == "slots":           # decode_horizon=1: no horizon at all
        assert out["records"] == want["records"]
    for r in (ra, rb, rc):
        assert out["records"][r]["cause"], (r, out["records"][r])
    assert out["records"][ra]["tokens_emitted"] == 6
    assert "overdue" in out["records"][rb]["cause"]
    # every request of the run's four parts closed, none left live
    assert len(eng.flight) == 13 and not eng.flight.live_rids()


def test_stall_watchdog_closes_flight_records(port_runs, jax_runs):
    out = port_runs["stall", "pages"][0]["stall"]
    assert out == jax_runs["stall"]["stall"]
    assert out["status"] == "QUEUED"
    assert out["record"]["cause"].startswith("stall watchdog: no scheduler")
    assert out["record"]["events"][-1][0] == "stall"


def test_publish_matches_jax(port_runs, jax_runs):
    """``publish_metrics`` gives the JAX engine's gauge names, but the
    lane and speculative fields of later slices and the port's
    ``host_kill_uploads``, and the same values for every count, status
    and latency on the same run and clock; publishing again observes no
    sample twice."""
    out, eng = port_runs["one_slot", "slots"]
    reg = out["postmortems"]["registry"]
    ref = jax_runs["one_slot"]["postmortems"]["registry"]
    names = {m.name for m in reg.collect()}
    ref_names = {m.name for m in ref.collect()}
    later = {"serving_admit_lanes", "serving_mean_lane_occupancy",
             "serving_admission_concurrency"} | {
        n for n in ref_names if n.startswith("serving_spec_")}
    assert names - ref_names == {"serving_host_kill_uploads"}
    assert ref_names - names == later
    counts = [n for n in names & ref_names if n.endswith(
        ("_count", "_requests", "_tokens", "submitted", "completed",
         "slow_steps", "callback_errors", "deadline_miss_rate", "_ms"))]
    assert len(counts) > 20
    for m in reg.collect():
        if m.name not in counts:
            continue
        r = ref.get(m.name, **m.labels)
        assert r is not None, (m.name, m.labels)
        if m.kind == "histogram":
            assert (m.count, m.sum) == (r.count, r.sum), m.name
        else:
            assert m.value == r.value, m.name
    n_ttft = reg.get("serving_ttft_ms").count
    assert n_ttft == 3
    n_now = len(eng.metrics._ttft)
    eng.publish_metrics(reg)
    eng.publish_metrics(reg)
    assert reg.get("serving_ttft_ms").count == n_now > n_ttft


def test_flight_recorder_matches_jax():
    """The same notes and closes give the JAX recorder's records, bounds
    (per-request ring, retained records, ``dropped_records``) and
    queries."""
    recs = [FlightRecorder(per_request=3, retain=2),
            JaxFlight(per_request=3, retain=2)]
    for fr in recs:
        for rid in range(4):
            for k in range(5):
                fr.note(rid, f"k{k}", f"rid={rid}", t=rid + k / 10)
        fr.close(0, "COMPLETED", "completed", t=9.0, tokens_emitted=3)
        fr.close(1, "FAILED", "nan watchdog", t=9.5)
        fr.close(1, "CANCELLED", "late", t=9.6)       # no-op
        fr.note(1, "late", t=9.7)                     # no-op
        fr.close(2, "REJECTED", "queue full", t=10.0)
    a, b = recs
    assert a.postmortems() == b.postmortems()
    assert [r["rid"] for r in a.postmortems()] == [1, 2]
    assert a.postmortem(0) is None and a.dropped_records == 1
    assert a.postmortem(3) == b.postmortem(3)
    assert a.postmortem(3)["status"] == "LIVE"
    assert len(a.postmortem(3)["events"]) == 3
    assert a.live_rids() == b.live_rids() == [3]
    assert len(a) == len(b) == 2
    assert a.postmortem(7) is None
    with pytest.raises(ValueError):
        FlightRecorder(per_request=0)


# ---- callbacks that raise ------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_raising_callbacks_do_not_stop_the_engine(port_runs, jax_runs,
                                                  layout):
    """A raising ``on_token`` and a raising ``on_done`` are counted in
    ``callback_errors``, as the JAX engine counts them, and every
    request still completes with the JAX engine's tokens."""
    out = port_runs["live", layout][0]["callbacks"]
    want = jax_runs["live"]["callbacks"]
    assert _same(out, want)
    assert set(out["status"].values()) == {"COMPLETED"}
    assert out["errors"] == 10 + 1
    r2 = max(out["tokens"])
    assert out["seen"] == out["tokens"][r2] + ["COMPLETED"]
