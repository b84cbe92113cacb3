"""The port's serving steps as the card captures them, held on the CPU:
the unified step with every per-request value a device tensor against
the JAX ServingEngine (admit_lanes=1), greedy tokens identical on pages
and on slots (a clamped last chunk, slot reuse, a 1-slot engine); the
graph keys a mixed stream records, at most 2 a sampling mode (the
reference pins its programs at tests/test_serving.py:324 and :552);
one upload an admission step, the temperature carried exactly through
the packed int32 array; ``generate``'s loop entries (one reused across
prompts, lengths and temperatures; at most GEN_CACHE_MAX); nothing
captured on the CPU.

The capture protocol itself (first call eager, second captures, later
calls replay, the state check, the generators a graph registers) runs
here against a stand-in for ``torch.cuda.CUDAGraph`` whose replay calls
the step again on the arguments it was captured with (``fake_graphs``).
The sampling scheme (engine-owned generators, every slot drawing every
iteration of a sampled step) gives each sampled request of a mixed
stream the tokens it gets when it is served alone, bit for bit.

The JAX model trains once per module (a module-scoped fixture)."""

import jax
import numpy as np
import pytest
import torch

from singa_tpu import opt, tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu_torch import _graphs
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.serving.engine import _ADM_SCALARS, MAX_STOP_TOKENS

torch.set_num_threads(1)

PAGED_KW = dict(n_slots=3, chunk_tokens=8, decode_horizon=4, page_tokens=8)
SLOT_KW = dict(n_slots=3, chunk_tokens=8, decode_horizon=4, paged=False)
MONO_KW = dict(n_slots=3, chunked=False, paged=False)
LAYOUTS = {"paged": PAGED_KW, "slot": SLOT_KW}


def _stream(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab
    return x


@pytest.fixture(scope="module")
def served():
    """The lightly trained tiny GPT of tests/test_torch_serving.py, and
    the port's model built from its decode pytree."""
    import conftest

    np.random.seed(0)
    cfg = jgpt.GPTConfig.tiny()
    m = jgpt.GPT(cfg)
    m.set_optimizer(opt.Adam(lr=3e-3))
    data = _stream(cfg.vocab_size, 8 * 32 * 8 + 1)
    B, T = 8, 32
    with conftest.xla_cache_paused():
        m.compile([tensor.from_numpy(data[:B * T].reshape(B, T))],
                  is_train=True, use_graph=True)
        for _ in range(4):
            for s in range(8):
                seg = data[s * B * T:(s + 1) * B * T + 1]
                m.train_one_batch(
                    tensor.from_numpy(seg[:-1].reshape(B, T)),
                    tensor.from_numpy(seg[1:].reshape(B, T)))
    m.eval()
    jgpt.ensure_decode_ready(m)
    tree = jax.tree.map(np.asarray, m.decode_params())
    tm = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                         device="cpu")
    return m, tm, tree, cfg


# ---- a stand-in for the card's graphs ------------------------------------

class _FakeCUDAGraph:
    """Replays by running the step again on the arguments it was
    captured with, writing its outputs into the first replay's tensors
    (a graph's outputs are its own buffers)."""

    def __init__(self, fn, args, generators):
        self.fn, self.args, self.generators = fn, args, list(generators)
        self.entry = None

    def replay(self):
        self.entry.outputs = _into(self.entry.outputs,
                                   self.fn(*self.args))


def _into(buf, new):
    if buf is None:
        return new
    if isinstance(buf, torch.Tensor):
        return buf.copy_(new)
    return type(buf)(_into(b, n) for b, n in zip(buf, new))


@pytest.fixture
def fake_graphs(monkeypatch):
    """Steps on the CPU take the capture path, with
    :class:`_FakeCUDAGraph` for the CUDA graph and no side stream; the
    capture runs nothing (as on the card).  Yields the list of the
    graphs made."""
    made = []

    def eager(self, device, fn, *args):
        return fn(*args)

    def capture(self, key, device, fn, args, state_fn, inputs=(),
                generators=()):
        state = state_fn()
        g = _FakeCUDAGraph(fn, args, generators)
        entry = _graphs.Graph(g, list(inputs), None, state, {})
        g.entry = entry
        self.graphs[key] = entry
        self.captures[key[0]] = self.captures.get(key[0], 0) + 1
        made.append((key, g))
        return entry

    monkeypatch.setattr(_graphs, "captures_on", lambda device: True)
    monkeypatch.setattr(_graphs.GraphCache, "eager", eager)
    monkeypatch.setattr(_graphs.GraphCache, "capture", capture)
    yield made


def _engine(tm, kw):
    return TorchEngine(tm, device="cpu", **kw)


# ---- the unified step against the JAX engine -----------------------------

# (prompt lengths, new tokens, engine arguments): staggered arrivals on 3
# slots; a 50-token prompt whose last 24-token chunk is clamped to
# [40, 64); three requests through one slot (reuse)
CASES = {
    "staggered": ([5, 17, 9, 30, 3, 12], [8, 6, 10, 5, 7, 9], {}),
    "clamped_chunk": ([50, 30, 5], [8, 12, 6], dict(chunk_tokens=24)),
    "one_slot": ([30, 17, 3], [5, 6, 7], dict(n_slots=1)),
}


def _run_case(eng, cfg, lengths, budgets):
    prompts = [_stream(cfg.vocab_size, n, seed=11 + i)
               for i, n in enumerate(lengths)]
    rids = [eng.submit(prompts[i], budgets[i]) for i in range(2)]
    eng.step()
    eng.step()
    rids += [eng.submit(p, n) for p, n in zip(prompts[2:], budgets[2:])]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def jax_cases(served):
    m, _, _, cfg = served
    return {(layout, case): _run_case(
        JaxEngine(m, admit_lanes=1, **dict(LAYOUTS[layout], **kw)), cfg,
        lengths, budgets)
        for layout in LAYOUTS
        for case, (lengths, budgets, kw) in CASES.items()}


@pytest.mark.parametrize("captured", [False, True],
                         ids=["eager", "captured"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unified_step_with_device_arguments_matches_jax(
        served, jax_cases, request, layout, case, captured):
    _, tm, _, cfg = served
    if captured:
        request.getfixturevalue("fake_graphs")
    lengths, budgets, kw = CASES[case]
    eng = _engine(tm, dict(LAYOUTS[layout], **kw))
    got = _run_case(eng, cfg, lengths, budgets)
    for i, (a, b) in enumerate(zip(got, jax_cases[layout, case])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    if captured:
        assert eng.graph_captures.get("unified") == 1
        assert eng.graph_replays["unified"] > 0
    else:
        assert eng.graph_captures == {} and eng.graph_replays == {}


# ---- the graph pin --------------------------------------------------------

def _mixed_stream(eng, cfg, n=20):
    """20 requests of mixed prompt lengths, half of them sampled with
    mixed top-k, arriving staggered."""
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, cfg.max_len - 13, size=n)
    rids = []
    for i, n_p in enumerate(lengths):
        kw = dict(temperature=0.8 + 0.1 * (i % 3), top_k=i % 4,
                  seed=40 + i) if i % 2 else {}
        rids.append(eng.submit(_stream(cfg.vocab_size, int(n_p),
                                       seed=100 + i), 8, **kw))
        if i % 3 == 0:
            eng.step()
    res = eng.run()
    assert len(res) == n
    return [res[r] for r in rids]


PIN_KW = {"paged": PAGED_KW, "slot": SLOT_KW,
          "int8": dict(PAGED_KW, kv_dtype="int8", weight_dtype="int8"),
          "slot_horizon1": dict(SLOT_KW, decode_horizon=1),
          "mono": MONO_KW}
PIN_LABELS = {"paged": {"unified:C8:paged", "horizon:K4:paged"},
              "slot": {"unified:C8", "horizon:K4"},
              "int8": {"unified:C8:paged:kv8:w8", "horizon:K4:paged:kv8:w8"},
              "slot_horizon1": {"unified:C8", "horizon:K1"},
              "mono": {"decode"}}


@pytest.mark.parametrize("engine", list(PIN_KW))
def test_mixed_stream_records_at_most_two_graphs_a_sampling_mode(
        served, engine):
    """The counterpart of the reference's program pins: any mix of prompt
    lengths records the same few keys, at most 2 a sampling mode (1 for
    the monolithic decode step), and the CPU captures none of them."""
    _, tm, _, cfg = served
    eng = _engine(tm, PIN_KW[engine])
    _mixed_stream(eng, cfg)
    want = PIN_LABELS[engine]
    log = eng.trace_log
    assert len(log) == len(set(log)) >= 2
    assert set(log) <= want | {k + ":sampled" for k in want}
    sampled = [k for k in log if k.endswith(":sampled")]
    assert 1 <= len(sampled) <= len(want)
    assert 1 <= len(log) - len(sampled) <= len(want) <= 2
    assert eng.graph_captures == {} and eng.graph_replays == {}


@pytest.mark.parametrize("engine", ["paged", "slot", "int8", "mono"])
def test_captured_stream_equals_eager_and_registers_its_generators(
        served, fake_graphs, engine):
    """Through the capture protocol: at most one capture a key (on its
    second call), every later call a replay; the sampled graphs register every
    slot's generator (and the unified step the admission's), the greedy
    ones none; tokens equal the eager engine's, greedy and sampled."""
    _, tm, _, cfg = served
    kw = PIN_KW[engine]
    eng = _engine(tm, kw)
    got = _mixed_stream(eng, cfg)
    keys = [k for k, _ in fake_graphs]
    assert len(keys) == len(set(keys)) >= 1
    assert {label for _, label in keys} <= set(eng.trace_log)
    assert sum(eng.graph_captures.values()) == len(keys)
    assert sum(eng.graph_replays.values()) > 2 * len(keys)
    for (kind, label), g in fake_graphs:
        want = []
        if label.endswith(":sampled"):
            want = eng._slot_gens + ([eng._adm_gen] if kind == "unified"
                                     else [])
        assert [id(x) for x in g.generators] == [id(x) for x in want]
    ref = _mixed_stream(_engine(tm, dict(kw, _capture=False)), cfg)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_a_moved_state_tensor_captures_again(served, fake_graphs):
    """The storage of the state is checked before a replay: a cache
    tensor rebound since the capture makes the key capture again."""
    _, tm, _, cfg = served
    eng = _engine(tm, SLOT_KW)
    p = _stream(cfg.vocab_size, 30, seed=3)
    want = tm.generate(p, 12)[0]
    rid = eng.submit(p, 12)
    for _ in range(3):                       # eager, capture, replay
        eng.step()
    assert eng.graph_captures == {"unified": 1}
    k = eng.kv.caches[0][0]
    k.data = k.data.clone()                  # same values, new storage
    res = eng.run()
    assert eng.graph_captures["unified"] == 2
    np.testing.assert_array_equal(res[rid], want)


# ---- sampling: a request's draws whatever its neighbours -----------------

@pytest.mark.parametrize("engine", ["paged", "slot", "slot_horizon1",
                                    "mono"])
def test_engine_owned_generators_draw_as_each_request_alone(served, engine):
    """Engine-owned generators, every slot drawing every iteration and
    re-seeded as a request is committed, give each sampled request of a
    mixed stream the k-th draw of its own seed for its k-th token: served
    alone, one after the other through one engine, every sampled request
    gives the tokens it gave in the stream."""
    _, tm, _, cfg = served
    kw = PIN_KW[engine]
    stream = _mixed_stream(_engine(tm, kw), cfg)
    lengths = np.random.RandomState(1).randint(1, cfg.max_len - 13, size=20)
    eng = _engine(tm, kw)
    for i in range(1, 20, 2):                       # the sampled requests
        rid = eng.submit(_stream(cfg.vocab_size, int(lengths[i]),
                                 seed=100 + i), 8,
                         temperature=0.8 + 0.1 * (i % 3), top_k=i % 4,
                         seed=40 + i)
        np.testing.assert_array_equal(eng.run()[rid], stream[i],
                                      err_msg=f"request {i}")


# ---- the admission's one upload -----------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_admission_uploads_once_and_carries_the_temperature_exactly(
        served, layout):
    _, tm, _, cfg = served
    eng = _engine(tm, LAYOUTS[layout])
    t = 0.7123456789                        # not a float32 value
    p = _stream(cfg.vocab_size, 5, seed=9)
    rid = eng.submit(p, 6, temperature=t, top_k=3, seed=5,
                     stop_tokens=(7, 2))
    before = eng.metrics.snapshot()["host_uploads"]
    eng.step()                              # the whole prompt: one chunk
    assert eng.metrics.snapshot()["host_uploads"] - before == 1
    sc = eng._adm_buf[-len(_ADM_SCALARS):]
    got = dict(zip(_ADM_SCALARS, sc.tolist()))
    assert float(sc[4:5].view(torch.float32)) == float(np.float32(t))
    C = eng.chunk_tokens
    assert got["slot"] == 0 and got["woff"] == 0 and got["p_last"] == 4
    assert got["p_len"] == 5 and got["top_k"] == 3 and got["commit"] == 1
    assert got["limit"] == 5 + 6 - 1
    stops = eng._adm_buf[-len(_ADM_SCALARS) - MAX_STOP_TOKENS:
                         -len(_ADM_SCALARS)]
    assert stops.tolist()[:3] == [2, 7, -1]
    np.testing.assert_array_equal(eng._adm_buf[:5].numpy(), p)
    assert eng._adm_buf[5:C].abs().sum() == 0
    # the commit wrote the admitted slot's device state exactly
    st = eng._dstate
    assert st["temp"][0].item() == float(np.float32(t))
    assert st["topk"][0].item() == 3 and st["limit"][0].item() == 10
    assert st["pos"][0].item() == 5
    assert bool(st["active"][0]) == (eng.requests[rid].tokens[0]
                                     not in (7, 2))
    eng.run()


# ---- generate's loop entries ---------------------------------------------

def test_generate_reuses_one_entry_across_prompts_lengths_temperatures(
        served):
    m, _, tree, cfg = served
    tm = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                         device="cpu")
    V = cfg.vocab_size
    calls = [(np.stack([_stream(V, n, seed=s), _stream(V, n, seed=s + 50)]),
              k, kw)
             for n, s, k, kw in (
                 (11, 3, 9, {}), (30, 4, 20, {}),
                 (5, 5, 14, dict(temperature=0.7, top_k=5, seed=2)),
                 (19, 6, 7, dict(temperature=1.3, seed=3)),
                 (8, 7, 12, {}))]
    got = [tm.generate(p, k, **kw) for p, k, kw in calls]
    assert sorted(tm._gen_entries) == [("generate", 2, "float32", False),
                                       ("generate", 2, "float32", True)]
    for (p, k, kw), toks in zip(calls, got):
        fresh = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                                device="cpu")
        np.testing.assert_array_equal(toks, fresh.generate(p, k, **kw))
        if not kw:
            np.testing.assert_array_equal(toks, m.generate(p, k))
    assert tm.graph_captures == {} and tm.graph_replays == {}


def test_generate_keeps_at_most_gen_cache_max_entries(served):
    _, _, tree, cfg = served
    tm = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                         device="cpu")
    p = _stream(cfg.vocab_size, 6, seed=1)
    for B in range(1, tgpt.GEN_CACHE_MAX + 4):
        tm.generate(np.stack([p] * B), 3)
        assert len(tm._gen_entries) == min(B, tgpt.GEN_CACHE_MAX)
    assert [k[1] for k in tm._gen_entries] == list(
        range(4, tgpt.GEN_CACHE_MAX + 4))
    before = dict(tm._gen_entries)
    tm.generate(np.stack([p] * 5), 3)          # a hit: moved to the end
    assert list(tm._gen_entries)[-1][1] == 5
    assert all(tm._gen_entries[k] is e for k, e in before.items())


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_k=4,
                                                seed=6)],
                         ids=["greedy", "sampled"])
def test_generate_captured_loop_equals_eager(served, fake_graphs, sampling):
    """Through the capture protocol: the entry's first step eager, its
    second captured (the entry's generator registered when sampling),
    the rest replays, across calls of other lengths; tokens equal the
    eager loop's."""
    _, _, tree, cfg = served
    tm = tgpt.GPT.from_jax_decode_params(tree, tgpt.GPTConfig.tiny(),
                                         device="cpu")
    prompts = [_stream(cfg.vocab_size, n, seed=n)[None] for n in (9, 21, 4)]
    got = [tm.generate(p, 10, **sampling) for p in prompts]
    assert tm.graph_captures == {"generate": 1}
    assert tm.graph_replays == {"generate": 8 + 9 + 9}
    (key, g), = fake_graphs
    e = tm._gen_entries[key]
    assert [id(x) for x in g.generators] == ([id(e.gen)] if sampling
                                             else [])
    for p, toks in zip(prompts, got):
        np.testing.assert_array_equal(
            toks, tm.generate(p, 10, _capture=False, **sampling))
