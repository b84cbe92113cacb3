"""The port's serving slice as a whole (singa_tpu_torch.serving,
ServingEngine paged + chunked, one admission lane) against the JAX
ServingEngine(paged=True, admit_lanes=1) on the same trained tiny GPT:
greedy tokens per request identical on a staggered stream, plus the
port's own contracts (prefix sharing, slot reuse, zero-upload steady
state, one fetch per horizon, seeded sampling, out-of-slice arguments,
no silent CPU).  Quantized serving is held in
tests/test_torch_quantized_serving.py, the slot-layout and monolithic
engines in tests/test_torch_slot_serving.py."""

import numpy as np
import pytest
import torch

from singa_tpu import opt, tensor
from singa_tpu.models import gpt
from singa_tpu.serving import ServingEngine
from singa_tpu_torch import resolve_device
from singa_tpu_torch.layer import Linear as TLinear
from singa_tpu_torch.model import Model as TModel
from singa_tpu_torch.tensor import Tensor as TTensor
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import FaultPlan, PagedKVCache, SlotKVCache
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.telemetry import SpanTracer

torch.set_num_threads(1)

ENGINE_KW = dict(n_slots=3, page_tokens=8, chunk_tokens=8, decode_horizon=4)
LENGTHS = [5, 17, 9, 30, 3, 12]
BUDGETS = [8, 6, 10, 5, 7, 9]


def _stream(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab
    return x


@pytest.fixture(scope="module")
def served():
    """The lightly trained tiny GPT of tests/test_paged_serving.py (its
    greedy continuations are prompt-sensitive), plus the port's model
    built from its decode pytree."""
    import conftest
    import jax

    np.random.seed(0)
    cfg = gpt.GPTConfig.tiny()
    m = gpt.GPT(cfg)
    m.set_optimizer(opt.Adam(lr=3e-3))
    data = _stream(cfg.vocab_size, 8 * 32 * 8 + 1)
    B, T = 8, 32
    with conftest.xla_cache_paused():
        m.compile([tensor.from_numpy(data[:B * T].reshape(B, T))],
                  is_train=True, use_graph=True)
        for epoch in range(4):
            for s in range(8):
                seg = data[s * B * T:(s + 1) * B * T + 1]
                m.train_one_batch(
                    tensor.from_numpy(seg[:-1].reshape(B, T)),
                    tensor.from_numpy(seg[1:].reshape(B, T)))
    m.eval()
    gpt.ensure_decode_ready(m)
    tree = jax.tree.map(np.asarray, m.decode_params())
    tm = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                         device="cpu")
    return m, tm, cfg


def _prompts(cfg):
    return [_stream(cfg.vocab_size, n, seed=11 + i)
            for i, n in enumerate(LENGTHS)]


def _staggered(eng, prompts, stops):
    """Staggered arrivals: queueing, mid-flight admission, slot reuse."""
    def sub(i):
        return eng.submit(prompts[i], BUDGETS[i], stop_tokens=stops[i])

    rids = [sub(0), sub(1)]
    eng.step()
    eng.step()
    rids += [sub(2), sub(3), sub(4)]
    eng.step()
    rids.append(sub(5))
    res = eng.run()
    assert len(res) == 6
    return [res[r] for r in rids]


def test_staggered_stream_matches_jax_engine(served):
    m, tm, cfg = served
    prompts = _prompts(cfg)
    stops = [()] * 6
    # request 2 stops at its own third greedy token
    free = _staggered(TorchEngine(tm, device="cpu", **ENGINE_KW), prompts,
                      stops)
    stops[2] = (int(free[2][2]),)
    ref = _staggered(ServingEngine(m, paged=True, admit_lanes=1,
                                   **ENGINE_KW), prompts, stops)
    out = _staggered(TorchEngine(tm, device="cpu", **ENGINE_KW), prompts,
                     stops)
    for i, (a, b) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    # the stop token ended request 2 early, in both engines
    assert len(out[2]) < BUDGETS[2] and out[2][-1] == stops[2][0]


def test_prefix_sharing_warm_equals_cold(served):
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **ENGINE_KW)
    p = _stream(cfg.vocab_size, 21, seed=5)
    rid_cold = eng.submit(p, 8)
    cold = eng.run()[rid_cold]
    assert eng.kv.prefix_hit_rate == 0.0
    rid_warm = eng.submit(p, 8)
    warm = eng.run()[rid_warm]
    np.testing.assert_array_equal(warm, cold)
    assert eng.kv.prefix_hit_rate > 0
    assert eng.metrics.snapshot()["prefix_cache_hit_rate"] > 0
    # a diverging suffix shares only the common full pages
    q = p.copy()
    q[12] = (q[12] + 1) % cfg.vocab_size
    rid_div = eng.submit(q, 8)
    div = eng.run()[rid_div]
    fresh = TorchEngine(tm, device="cpu", **ENGINE_KW)
    r = fresh.submit(q, 8)
    np.testing.assert_array_equal(div, fresh.run()[r])


def test_slot_reuse_after_eviction_leaks_nothing(served):
    _, tm, cfg = served
    prompts = _prompts(cfg)
    alone = []
    for i in (3, 1, 4):
        eng = TorchEngine(tm, device="cpu", prefix_cache=False, **ENGINE_KW)
        r = eng.submit(prompts[i], BUDGETS[i])
        alone.append(eng.run()[r])
    kw = dict(ENGINE_KW, n_slots=1)
    eng = TorchEngine(tm, device="cpu", prefix_cache=False, **kw)
    rids = [eng.submit(prompts[i], BUDGETS[i]) for i in (3, 1, 4)]
    res = eng.run()
    for r, a in zip(rids, alone):
        np.testing.assert_array_equal(res[r], a)
    assert eng.kv.used_pages == 0 and eng.kv.free_slots == 1


def test_steady_state_uploads_nothing_and_fetches_once_per_horizon(served):
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **ENGINE_KW)
    for i in range(3):
        eng.submit(_stream(cfg.vocab_size, 6 + i, seed=40 + i), 30)
    while eng.queue or eng._lane is not None:
        eng.step()
    before = eng.metrics.snapshot()
    res = eng.run()
    after = eng.metrics.snapshot()
    assert len(res) == 3
    assert after["host_uploads"] == before["host_uploads"]
    blocks = after["horizon_blocks"] - before["horizon_blocks"]
    tokens = after["total_tokens"] - before["total_tokens"]
    assert blocks > 0
    assert after["host_syncs"] - before["host_syncs"] == blocks
    # steady-state uploads per token are exactly zero
    assert (after["host_uploads"] - before["host_uploads"]) / tokens == 0


def test_sampled_requests_repeat_with_their_seed(served):
    _, tm, cfg = served

    def run(seed):
        eng = TorchEngine(tm, device="cpu", **ENGINE_KW)
        rids = [eng.submit(_stream(cfg.vocab_size, 9, seed=7), 12,
                           temperature=1.5, top_k=8, seed=seed),
                eng.submit(_stream(cfg.vocab_size, 4, seed=8), 12)]
        res = eng.run()
        return [res[r] for r in rids]

    a, b, c = run(3), run(3), run(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[1], c[1])      # the greedy neighbour
    assert not np.array_equal(a[0], c[0])


def test_nonfinite_logits_fail_the_request(served):
    _, tm, cfg = served
    bad = tgpt.GPT.from_jax_decode_params(
        {**_tree_of(tm), "head": {"W": np.full((32, 64), np.nan, np.float32),
                                  "b": np.zeros(64, np.float32)}},
        tgpt.GPTConfig.tiny(), device="cpu")
    eng = TorchEngine(bad, device="cpu", **ENGINE_KW)
    rid = eng.submit(_stream(cfg.vocab_size, 5), 4)
    assert eng.run() == {}
    assert eng.requests[rid].status.value == "FAILED"
    assert eng.kv.used_pages == 0 and eng.kv.free_slots == 3


def _tree_of(tm):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.numpy()
    return conv(tm.decode_params())


@pytest.mark.parametrize("kw", [
    dict(paged=False, tp_degree=2), dict(admit_lanes=2),
    dict(speculative=True), dict(tp_degree=2), dict(prefill_only=True)])
def test_out_of_slice_arguments_raise(served, kw):
    _, tm, _ = served
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        TorchEngine(tm, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(tracer=SpanTracer()), dict(faults=FaultPlan())],
    ids=["tracer", "faults"])
def test_tracer_and_faults_arguments_serve(served, kw):
    """A tracer and an empty fault plan are taken by the chunked engine,
    which serves the stream with the tokens of an engine without them."""
    _, tm, cfg = served
    runs = []
    for extra in ({}, kw):
        eng = TorchEngine(tm, device="cpu", **dict(ENGINE_KW, **extra))
        rids = [eng.submit(_stream(cfg.vocab_size, n, seed=i), 4)
                for i, n in enumerate((5, 9, 3))]
        res = eng.run()
        runs.append([res[r].tolist() for r in rids])
    assert runs[0] == runs[1]
    assert eng.tracer is kw.get("tracer")
    if "faults" in kw:
        assert kw["faults"].events == [] and kw["faults"].attempts == 3


def test_faults_need_the_chunked_engine(served):
    _, tm, _ = served
    with pytest.raises(ValueError, match="fault injection requires the "
                                         "chunked engine"):
        TorchEngine(tm, device="cpu", paged=False, chunked=False,
                    faults=FaultPlan())


@pytest.mark.parametrize("kw", [dict(max_queue=4), dict(step_budget_ms=5.0)],
                         ids=["max_queue", "step_budget_ms"])
def test_admission_control_arguments_serve(served, kw):
    """The admission controls are taken by the chunked engine, which
    still serves a stream under them: a queue of 4 refuses nothing here,
    and a 5 ms budget on a clock that never moves strikes nothing."""
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", clock=lambda: 0.0,
                      **dict(ENGINE_KW, **kw))
    rids = [eng.submit(_stream(cfg.vocab_size, n, seed=i), 4)
            for i, n in enumerate((5, 9, 3))]
    res = eng.run()
    assert [len(res[r]) for r in rids] == [4, 4, 4]
    snap = eng.metrics.snapshot()
    assert snap["rejected_count"] == 0 and snap["slow_steps"] == 0
    assert eng.max_queue == kw.get("max_queue")


@pytest.mark.parametrize("kw, on", [
    (dict(preemption=True), True),
    (dict(paged=False, chunked=False, preemption=True), False)],
    ids=["chunked", "mono"])
def test_preemption_flag(served, kw, on):
    """``preemption=True`` is taken by the chunked engine and ignored by
    the monolithic one, as the reference's ``bool(preemption) and
    self.chunked``; either engine still serves."""
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **dict(ENGINE_KW, **kw))
    assert eng.preemption is on
    rid = eng.submit(_stream(cfg.vocab_size, 5), 4)
    assert len(eng.run()[rid]) == 4


def test_paged_monolithic_raises(served):
    _, tm, _ = served
    with pytest.raises(ValueError, match="requires the chunked engine"):
        TorchEngine(tm, device="cpu", paged=True, chunked=False)


def test_out_of_slice_submit_arguments_raise(served):
    """``submit(deadline_ms=)`` as the reference validates it: a deadline
    must be positive, and the monolithic engine, which has no eviction
    path, refuses one naming the chunked engine."""
    _, tm, cfg = served
    p = _stream(cfg.vocab_size, 4)
    eng = TorchEngine(tm, device="cpu", **ENGINE_KW)
    for bad in (0.0, -5.0):
        with pytest.raises(ValueError, match="deadline_ms must be > 0"):
            eng.submit(p, 4, deadline_ms=bad)
    mono = TorchEngine(tm, device="cpu", n_slots=2, paged=False,
                       chunked=False)
    with pytest.raises(ValueError, match="chunked"):
        mono.submit(p, 4, deadline_ms=50.0)
    assert not eng.requests and not mono.requests
    rid = eng.submit(p, 4, deadline_ms=1e6)
    assert len(eng.run()[rid]) == 4


def test_submit_priority_is_queued_in_order(served):
    """``submit(priority=)`` is accepted and ordered: higher first, FIFO
    within a priority."""
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **ENGINE_KW)
    p = _stream(cfg.vocab_size, 4)
    rids = [eng.submit(p, 4, priority=k) for k in (0, 1, 1, 0)]
    assert [r.rid for r in eng.queue] == [rids[1], rids[2], rids[0],
                                         rids[3]]
    assert [eng.requests[r].priority for r in rids] == [0, 1, 1, 0]
    assert set(eng.run()) == set(rids)


class _Plain(TModel):
    def __init__(self):
        super().__init__()
        self.fc = TLinear(2)

    def forward(self, x):
        return self.fc(x)


def test_no_silent_cpu(monkeypatch, served):
    _, tm, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(tm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPT(tgpt.GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(1, 2, 2, 8, 16, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotKVCache(1, 2, 2, 64, 16)
    # the training path's entry points: a Tensor, a model's compile with
    # host inputs and no device named
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTensor(data=np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _Plain().compile([np.zeros((1, 4), np.float32)])
    assert resolve_device("cpu") == torch.device("cpu")
