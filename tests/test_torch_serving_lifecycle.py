"""The port's request lifecycle in ServingEngine (singa_tpu_torch.serving):
priority order in the queue, preemption with restore through the
ordinary chunked prefill, the kill of a live slot on the device, and
cancel, on pages (float32 and int8) and on slots.

Held against the JAX package on the reference's robustness rig
(tests/test_serving_robustness.py: GPTConfig(50, 32, 2, 2, 64), untrained,
np.random.seed(0)), whose weights cross by ``from_jax_decode_params``:
greedy tokens of preempted and restored requests identical to the JAX
package's ``generate`` (and, on int8 pages, to the JAX int8 engine run
without preemption); sampled tokens identical to the port's own engine
run without preemption.  The JAX side runs once per module (the
``jax_tokens`` fixture)."""

import numpy as np
import pytest
import torch

from singa_tpu import tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import TERMINAL_STATUSES, RequestStatus
from singa_tpu_torch.serving import ServingEngine as TorchEngine

torch.set_num_threads(1)

# the pool of the reference's preemption tests: two 24-token requests
# fill 9 of the 9 usable pages, so the third cannot be admitted
PAGES_KW = dict(n_slots=2, page_tokens=8, kv_pages=10)
LAYOUTS = {
    "pages": PAGES_KW,
    "pages_int8": dict(PAGES_KW, kv_dtype="int8"),
    "slots": dict(n_slots=2, paged=False),
}
LO, HI = 24, 20                  # budgets of the low / high requests
SAMPLED = dict(temperature=0.8, top_k=5)


@pytest.fixture(scope="module")
def rig():
    """The reference's untrained robustness rig, the port's model from
    its decode pytree, and its five prompts."""
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
               for n in (5, 9, 13, 6, 20)]
    rng = np.random.RandomState(17)
    long_prompts = [rng.randint(0, cfg.vocab_size, 20).astype(np.int32)
                    for _ in range(3)]
    return m, tm, prompts, long_prompts


@pytest.fixture(scope="module")
def jax_tokens(rig):
    """Every JAX-side oracle of the module, computed once: ``generate``
    on each (prompt, budget) the tests hold, keyed ``(set, index,
    budget)``, and the JAX int8 engine's tokens for the three requests
    of the preemption stream, run without preemption, and the JAX
    float32-page engine's statuses at the end of the step that preempted
    (the victim waiting in the queue)."""
    m, _, prompts, long_prompts = rig
    out = {}
    for key, p, n in [("p", 0, LO), ("p", 1, LO), ("p", 2, HI),
                      ("p", 1, 12), ("p", 4, 10),
                      ("l", 0, LO), ("l", 1, LO), ("l", 2, HI)]:
        src = prompts if key == "p" else long_prompts
        out[key, p, n] = np.asarray(m.generate(src[p], n)[0])
    eng = JaxEngine(m, paged=True, admit_lanes=1, preemption=False,
                    kv_dtype="int8", **PAGES_KW)
    rids = [eng.submit(prompts[0], LO), eng.submit(prompts[1], LO),
            eng.submit(prompts[2], HI)]
    res = eng.run()
    out["int8_engine"] = [np.asarray(res[r]) for r in rids]
    eng = JaxEngine(m, paged=True, admit_lanes=1, preemption=True,
                    **PAGES_KW)
    rids = [eng.submit(prompts[0], LO), eng.submit(prompts[1], LO)]
    for _ in range(2):
        eng.step()
    rids.append(eng.submit(prompts[2], HI, priority=1))
    for _ in range(8):
        eng.step()
        if eng.requests[rids[1]].preemptions:
            break
    status = eng.statuses()
    out["status_preempted"] = [status[r] for r in rids]
    return out


def _preempt_stream(eng, prompts, lo_kw=(), hi_kw=()):
    """Two low-priority requests admitted and decoding, then a
    high-priority arrival that cannot be admitted beside them; every
    (re-)admission driven out, then the tail run on its own.  Returns
    ``(rids, res, tail_uploads, on_done, waiting)``, ``waiting`` the
    statuses (in submission order) at the end of the step that
    preempted."""
    done = {}

    def cb(rid, status):
        done[rid] = status

    lo_kw, hi_kw = list(lo_kw) or [{}, {}], dict(hi_kw)
    rids = [eng.submit(p, LO, on_done=cb, **kw)
            for p, kw in zip(prompts[:2], lo_kw)]
    for _ in range(2):          # one admission a step: both go live
        eng.step()
    assert all(eng.requests[r].tokens for r in rids)
    rids.append(eng.submit(prompts[2], HI, priority=1, on_done=cb,
                           **hi_kw))
    waiting = None
    while eng.queue or eng._lane is not None:
        eng.step()
        if waiting is None and any(eng.requests[r].preemptions
                                   for r in rids):
            status = eng.statuses()
            waiting = [status[r] for r in rids]
    up0 = eng.metrics.host_uploads
    res = eng.run()
    return rids, res, eng.metrics.host_uploads - up0, done, waiting


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_preempt_restore_greedy_matches_jax_generate(rig, jax_tokens,
                                                     layout):
    """Page pressure (pages) or slot scarcity (slots): the high-priority
    arrival preempts the newer low-priority request, which restores
    through the ordinary chunked prefill and finishes with the tokens of
    the JAX package's ``generate``; no step label an uninterrupted run
    does not use, one kill upload, and nothing uploaded once the last
    re-admission committed."""
    _, tm, prompts, _ = rig
    eng = TorchEngine(tm, device="cpu", preemption=True, **LAYOUTS[layout])
    rids, res, tail_uploads, done, waiting = _preempt_stream(eng, prompts)
    for r, (i, n) in zip(rids, [(0, LO), (1, LO), (2, HI)]):
        np.testing.assert_array_equal(res[r], jax_tokens["p", i, n],
                                      err_msg=f"request {i}")
    if layout == "pages_int8":
        for r, want in zip(rids, jax_tokens["int8_engine"]):
            np.testing.assert_array_equal(res[r], want)
    # a preempted request reads QUEUED while it waits, as the JAX one
    assert waiting[1] == "QUEUED"
    assert waiting == jax_tokens["status_preempted"]
    snap = eng.metrics.snapshot()
    assert snap["preemption_count"] == snap["restore_count"] == 1
    assert snap["host_kill_uploads"] == 1
    assert snap["preempted_restored_count"] == 1
    assert tail_uploads == 0
    # the victim is the newest low-priority request
    assert eng.statuses() == {rids[0]: "COMPLETED",
                              rids[1]: "PREEMPTED_RESTORED",
                              rids[2]: "COMPLETED"}
    assert done == eng.statuses()
    assert eng.requests[rids[1]].preemptions == 1
    assert eng.requests[rids[1]].done
    assert set(done.values()) <= {s.value for s in TERMINAL_STATUSES}
    # one queue-wait sample a request: the restore adds none
    assert len(eng.metrics._queue_wait) == 3
    assert len(eng.metrics._ttft) == 3
    plain = TorchEngine(tm, device="cpu", **LAYOUTS[layout])
    for p, n in zip(prompts[:3], (LO, LO, HI)):
        plain.submit(p, n)
    plain.run()
    assert set(eng.trace_log) <= set(plain.trace_log)
    assert eng.kv.free_slots == eng.kv.n_slots
    assert not eng._dstate["active"].any()


@pytest.mark.parametrize("layout", ["pages", "slots"])
def test_sampled_restore_matches_uninterrupted(rig, jax_tokens, layout):
    """A sampled victim's restore starts both generators where its old
    slot's stood, so every request's draws equal an uninterrupted
    engine's, draw for draw."""
    _, tm, prompts, _ = rig
    lo_kw = [dict(SAMPLED, seed=3), dict(SAMPLED, seed=4)]
    hi_kw = dict(SAMPLED, seed=9)
    eng = TorchEngine(tm, device="cpu", preemption=True, **LAYOUTS[layout])
    rids, res, tail_uploads, _, _ = _preempt_stream(eng, prompts, lo_kw,
                                                 hi_kw)
    assert eng.metrics.preemptions == 1 and tail_uploads == 0
    assert eng.requests[rids[1]].status is RequestStatus.PREEMPTED_RESTORED
    # uninterrupted: a slot for each request, no preemption
    ref_kw = dict(LAYOUTS[layout], n_slots=3)
    ref_kw.pop("kv_pages", None)
    ref = TorchEngine(tm, device="cpu", **ref_kw)
    rr = [ref.submit(p, n, **kw) for p, n, kw in
          zip(prompts[:3], (LO, LO, HI), lo_kw + [hi_kw])]
    rres = ref.run()
    assert ref.metrics.preemptions == 0
    for a, b in zip(rids, rr):
        np.testing.assert_array_equal(res[a], rres[b])
    # the victim sampled: its tokens are not the greedy ones
    assert not np.array_equal(res[rids[1]], jax_tokens["p", 1, LO])


def test_restore_rides_prefix_index(rig, jax_tokens):
    """Slot scarcity on a roomy page pool: the victim's restore maps its
    two full prompt pages (16 of its 20 prompt tokens) from the prefix
    index, and every output still equals ``generate``."""
    _, tm, _, long_prompts = rig
    eng = TorchEngine(tm, device="cpu", preemption=True, n_slots=2,
                      page_tokens=8, kv_pages=32)
    rids, res, _, _, _ = _preempt_stream(eng, long_prompts)
    assert eng.metrics.preemptions == 1
    assert eng.kv.prefix_hit_tokens >= 16
    assert eng.metrics.snapshot()["prefix_cache_hit_rate"] > 0
    for r, (i, n) in zip(rids, [(0, LO), (1, LO), (2, HI)]):
        np.testing.assert_array_equal(res[r], jax_tokens["l", i, n])


@pytest.mark.parametrize("layout", ["pages", "slots"])
def test_cancel_queued_prefill_live(rig, jax_tokens, layout):
    """``cancel`` in each of a request's three places ends it CANCELLED;
    the live slot is stopped on the device (one kill upload) and emits
    nothing more; the survivor equals ``generate``; the freed slot's
    next owner (sampled) equals a fresh engine's run of it."""
    _, tm, prompts, _ = rig
    kw = dict(n_slots=2, chunk_tokens=8, decode_horizon=4,
              paged=layout == "pages")
    eng = TorchEngine(tm, device="cpu", **kw)
    seen = {}

    def on_token(rid, tok):
        seen.setdefault(rid, []).append(tok)

    r0 = eng.submit(prompts[0], 40, on_token=on_token)   # live at cancel
    r1 = eng.submit(prompts[1], 12)
    for _ in range(3):                                   # both live
        eng.step()
    # (1) queued
    rq = eng.submit(prompts[3], 8)
    assert eng.cancel(rq, cause="user closed the tab") is True
    assert eng.requests[rq].status is RequestStatus.CANCELLED
    assert rq not in [r.rid for r in eng.queue]
    # (2) live: stopped on the host now, on the device before next step
    assert eng.cancel(r0) is True
    assert eng.requests[r0].status is RequestStatus.CANCELLED
    n0 = len(eng.requests[r0].tokens)
    assert n0 and len(seen[r0]) == n0
    slot0 = [s for s in range(2) if eng._slot_req[s] is None]
    assert len(slot0) == 1 and eng._dstate["active"][slot0[0]]
    assert eng.cancel(r0) is False and eng.cancel(10 ** 9) is False
    eng.step()
    assert not eng._dstate["active"][slot0[0]]
    # (3) mid-prefill: a 13-token prompt takes two chunks of 8
    rp = eng.submit(prompts[2], 8)
    while eng._lane is None or eng._lane.req.rid != rp:
        eng.step()
    assert eng.cancel(rp) is True
    assert eng.requests[rp].status is RequestStatus.CANCELLED
    assert eng._lane is None
    # the freed slot's next owner
    rn = eng.submit(prompts[4], 10, seed=5, **SAMPLED)
    res = eng.run()
    assert len(eng.requests[r0].tokens) == n0 and len(seen[r0]) == n0
    assert set(res) == {r1, rn}
    np.testing.assert_array_equal(res[r1], jax_tokens["p", 1, 12])
    fresh = TorchEngine(tm, device="cpu", **kw)
    rf = fresh.submit(prompts[4], 10, seed=5, **SAMPLED)
    np.testing.assert_array_equal(res[rn], fresh.run()[rf])
    snap = eng.metrics.snapshot()
    assert snap["cancelled_count"] == 3
    assert snap["host_kill_uploads"] == 1
    assert eng.cancel(r1) is False                       # terminal
    assert eng.kv.free_slots == 2
    if layout == "pages":
        assert eng.kv.used_pages == len(eng.kv._prefix)  # index only


def test_cancel_live_greedy_next_owner_matches_jax(rig, jax_tokens):
    """The slot and pages a cancel frees, taken at once by a greedy
    request whose prompt spans the positions the killed slot would
    decode next: its tokens equal ``generate``, so the killed slot wrote
    nothing into what it gave up."""
    _, tm, prompts, long_prompts = rig
    eng = TorchEngine(tm, device="cpu", n_slots=1, page_tokens=8,
                      kv_pages=7, chunk_tokens=8, decode_horizon=4,
                      prefix_cache=False)
    r0 = eng.submit(prompts[0], 30)
    for _ in range(2):          # commit at 5, one horizon: position 9
        eng.step()
    r1 = eng.submit(long_prompts[0], LO)    # three chunks over 0..19
    assert eng.cancel(r0)
    res = eng.run()
    assert set(res) == {r1}
    np.testing.assert_array_equal(res[r1], jax_tokens["l", 0, LO])


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "mono"])
def test_priority_order_and_default_fifo(rig, chunked):
    """Queue order is higher priority first, FIFO by rid within one, on
    both engines; all-default priorities admit in submission order; a
    higher-priority arrival waits (no preemption by default)."""
    _, tm, prompts, _ = rig
    kw = (dict(n_slots=1, chunk_tokens=8, paged=False) if chunked
          else dict(n_slots=1, chunked=False, paged=False))
    order = []

    def on_token(rid, tok):
        if rid not in order:
            order.append(rid)

    eng = TorchEngine(tm, device="cpu", **kw)
    first = eng.submit(prompts[0], 6, on_token=on_token)
    eng.step()
    prio = [0, 2, 1, 2, 0]
    rids = [eng.submit(prompts[i], 4, priority=p, on_token=on_token)
            for i, p in enumerate(prio)]
    want = [rids[i] for i in sorted(range(5), key=lambda i: (-prio[i], i))]
    assert [r.rid for r in eng.queue] == want
    assert [r.priority for r in eng.queue] == sorted(prio, reverse=True)
    assert eng.requests[first].status is RequestStatus.RUNNING
    eng.run()
    assert order == [first] + want
    assert eng.metrics.preemptions == 0
    # all-default priorities: the FIFO schedule of submission
    order.clear()
    eng = TorchEngine(tm, device="cpu", **kw)
    rids = [eng.submit(p, 4, on_token=on_token) for p in prompts]
    eng.step()
    rids.append(eng.submit(prompts[0], 3, on_token=on_token))
    assert [r.rid for r in eng.queue] == rids[1:]
    eng.run()
    assert order == rids
    assert all(s == "COMPLETED" for s in eng.statuses().values())
