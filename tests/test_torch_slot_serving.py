"""The port's slot-layout serving (singa_tpu_torch.serving.SlotKVCache,
the slot blocks of singa_tpu_torch.models.gpt, and ServingEngine with
paged=False: the chunked engine with one admission lane, its int8 slot
cache, and the monolithic engine, chunked=False) against the JAX
package's, on the same weights and seeded numpy inputs.

Tolerances: hidden states and float caches atol 1e-5; int8 planes and
scales bit-identical, except one int8 step where the unrounded value
lies within 1e-5 (relative) of a rounding boundary (rows written from
hidden states that agree to float noise); greedy engine tokens
identical.  The engines are held on the lightly trained tiny GPT of
tests/test_torch_serving.py (float) and the reference's quantized rig,
GPTConfig(50, 128, 2, 4, 64) (int8), and against the port's own paged
engine and GPT.generate.

The JAX engines compile once per module (module-scoped fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import opt, tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu.serving import SlotKVCache as JaxSlotKVCache
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.serving import ServingEngine as TorchEngine
from singa_tpu_torch.serving import SlotKVCache

torch.set_num_threads(1)

SLOT_KW = dict(n_slots=3, chunk_tokens=8, decode_horizon=4, paged=False)
MONO_KW = dict(n_slots=3, chunked=False, paged=False)
PAGED_KW = dict(n_slots=3, chunk_tokens=8, decode_horizon=4, page_tokens=8)
LENGTHS = [5, 17, 9, 30, 3, 12]
BUDGETS = [8, 6, 10, 5, 7, 9]
QKW = dict(n_slots=2, chunk_tokens=8, paged=False, kv_dtype="int8",
           weight_dtype="int8")


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


@pytest.fixture(scope="module")
def stream_stops(served):
    """Request 2 stops at its own third greedy token (port slot engine's
    free run)."""
    _, tm, cfg = served
    free = _staggered(TorchEngine(tm, device="cpu", **SLOT_KW),
                      _prompts(cfg), [()] * 6)
    stops = [()] * 6
    stops[2] = (int(free[2][2]),)
    return free, stops


@pytest.fixture(scope="module")
def jax_streams(served, stream_stops):
    """The JAX slot engine's and monolithic engine's greedy tokens on the
    staggered stream."""
    m, _, cfg = served
    _, stops = stream_stops
    return {name: _staggered(JaxEngine(m, admit_lanes=1, **kw),
                             _prompts(cfg), stops)
            for name, kw in (("slot", SLOT_KW), ("mono", MONO_KW))}


# ---- SlotKVCache --------------------------------------------------------

def test_slot_kv_cache_alloc_release():
    kv = SlotKVCache(n_layers=2, n_slots=3, n_heads=2, max_len=8, d_head=4,
                     device="cpu")
    ref = JaxSlotKVCache(n_layers=2, n_slots=3, n_heads=2, max_len=8,
                         d_head=4, dtype=jnp.float32)
    assert kv.nbytes() == ref.nbytes() == 2 * 2 * 3 * 2 * 8 * 4 * 4
    assert [kv.alloc(), kv.alloc(), kv.alloc()] == [0, 1, 2]
    assert kv.alloc() is None and kv.occupancy == 1.0
    assert kv.live_bytes() == kv.nbytes() and kv.page_utilization() == 1.0
    kv.release(1)
    assert kv.free_slots == 1 and kv.alloc() == 1
    with pytest.raises(ValueError):
        kv.release(7)
    kv.release(0)
    with pytest.raises(ValueError):
        kv.release(0)                         # double free
    assert kv.active_slots == 2
    assert kv.live_bytes() == 2 * kv.nbytes() // 3
    with pytest.raises(ValueError):
        SlotKVCache(2, 0, 2, 8, 4, device="cpu")


def test_slot_kv_cache_alloc_order_matches_jax():
    """Lowest free slot first after out-of-order releases, step for step
    with the reference's allocator (the bit-match tests replay exact
    schedules)."""
    kv = SlotKVCache(n_layers=1, n_slots=4, n_heads=2, max_len=8, d_head=4,
                     device="cpu")
    ref = JaxSlotKVCache(n_layers=1, n_slots=4, n_heads=2, max_len=8,
                         d_head=4, dtype=jnp.float32)
    for op in ("a", "a", "a", "a", 2, 0, "a", 3, "a", "a", 1, 0, "a"):
        if op == "a":
            assert kv.alloc() == ref.alloc()
        else:
            kv.release(op)
            ref.release(op)
        assert (kv.free_slots, kv.active_slots, kv.occupancy) == \
            (ref.free_slots, ref.active_slots, ref.occupancy)
    assert kv._free == ref._free == [1]


def test_slot_kv_cache_layouts():
    kw = dict(n_layers=2, n_slots=3, n_heads=4, max_len=16, d_head=32,
              device="cpu")
    q8 = SlotKVCache(kv_dtype="int8", **kw)
    assert q8.quantized and len(q8.caches[0]) == 4
    assert q8.caches[0][0].shape == (3, 4, 16, 32)
    assert q8.caches[0][2].shape == (3, 4, 16)
    assert q8.caches[0][0].dtype == torch.int8
    assert q8.caches[0][2].dtype == torch.bfloat16
    b16 = SlotKVCache(dtype=torch.bfloat16, **kw)
    assert not b16.quantized and len(b16.caches[0]) == 2
    assert q8.nbytes() / b16.nbytes() == (32 + 2) / (2 * 32)
    ref = JaxSlotKVCache(2, 3, 4, 16, 32, kv_dtype=jnp.int8)
    assert q8.nbytes() == ref.nbytes()


# ---- the slot blocks -----------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["pos", "rope"])
def rig(request):
    """The reference's quantized-serving rig (d_head 32), random weights:
    the JAX model and the port's model from the same weights."""
    cfg = jgpt.GPTConfig(vocab_size=50, d_model=128, n_layers=2, n_heads=4,
                         max_len=64, use_rope=request.param)
    np.random.seed(0)
    m = jgpt.GPT(cfg)
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32))],
              is_train=False, use_graph=False)
    m.eval()
    tree = jax.tree.map(np.asarray, m.decode_params())
    tm = tgpt.GPT.from_jax_decode_params(
        tree, tgpt.GPTConfig(50, 128, 2, 4, 64, use_rope=request.param),
        device="cpu")
    return cfg, m, tm


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _caches(cfg, seed, quant):
    """One layer's random slot cache (3 slots): float, or int8 rows with
    bf16-representable scales."""
    rng = np.random.RandomState(seed)
    H, dh, L = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.max_len
    if not quant:
        return tuple(rng.randn(3, H, L, dh).astype(np.float32)
                     for _ in range(2))
    sc = [torch.from_numpy(rng.uniform(0.005, 0.03, (3, H, L)).astype(
        np.float32)).to(torch.bfloat16).float().numpy() for _ in range(2)]
    return (rng.randint(-127, 128, (3, H, L, dh)).astype(np.int8),
            rng.randint(-127, 128, (3, H, L, dh)).astype(np.int8), *sc)


def _jcaches(c):
    out = [jnp.asarray(a) for a in c]
    return tuple(out[:2] + [a.astype(jnp.bfloat16) for a in out[2:]])


def _tcaches(c):
    out = [torch.from_numpy(a.copy()) for a in c]
    return tuple(out[:2] + [a.to(torch.bfloat16) for a in out[2:]])


def _unrounded(tbp, h, H, cfg, positions, decode):
    """The K and V rows of a block before quantization, from the port's
    float math: (rows, H, dh)."""
    q, k, v = tgpt._qkv(tbp, h, H)
    if cfg.use_rope:
        k = (tgpt._rope_rows(k, positions, cfg.rope_base) if decode
             else tgpt.apply_rope(k, positions=positions, base=cfg.rope_base))
    if decode:
        return k[:, :, 0], v[:, :, 0]
    return k[0].transpose(0, 1), v[0].transpose(0, 1)


def _assert_int8_agree(mine, ref, unrounded, scales, written):
    """``mine`` and ``ref`` (S, H, L, dh) equal, except one int8 step at
    a written (slot, position) whose unrounded value lies within 1e-5
    (relative) of a rounding boundary.  ``written`` maps (slot, pos) to
    the row index of ``unrounded`` / ``scales``."""
    mine = mine.numpy().astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    for s, hh, p, d in np.argwhere(mine != ref):
        assert abs(mine[s, hh, p, d] - ref[s, hh, p, d]) == 1
        row = written.get((int(s), int(p)))
        assert row is not None, f"({s}, {hh}, {p}, {d}) outside the write"
        u = float(unrounded[row, hh, d] / scales[row, hh])
        assert abs(u - np.floor(u) - 0.5) <= 1e-5 * max(1.0, abs(u))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_chunk_prefill_block_matches_jax(rig, quant):
    cfg, m, tm = rig
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    C, off, slot = 16, 8, 1
    h = np.random.RandomState(7).randn(1, C, D).astype(np.float32)
    positions = off + np.arange(C)
    wd = "int8" if quant else None
    c = _caches(cfg, 8, quant)
    jc, tc = _jcaches(c), _tcaches(c)
    qkw = lambda cc: (dict(k_scale=cc[2], v_scale=cc[3]) if quant  # noqa
                      else {})
    jout = jgpt._block_chunk_prefill(
        m.decode_params(weight_dtype=wd)["blocks"][0], jnp.asarray(h),
        jc[0], jc[1], slot, off, jnp.asarray(positions), H, scale,
        cfg.use_rope, cfg.rope_base, **qkw(jc))
    tbp = tm.decode_params(weight_dtype=wd)["blocks"][0]
    launches = fa.launches
    tout = tgpt._block_chunk_prefill(
        tbp, torch.from_numpy(h), tc[0], tc[1], slot, off,
        torch.from_numpy(positions), H, scale, cfg.use_rope, cfg.rope_base,
        **qkw(tc))
    assert fa.launches == launches
    assert all(a is b for a, b in zip(tout[1:], tc))      # in place
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-5)
    if not quant:
        for mine, ref in zip(tout[1:], jout[1:]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       atol=1e-5)
        return
    for mine, ref in zip(tout[3:], jout[3:]):
        np.testing.assert_array_equal(_np(mine), _np(ref))
    written = {(slot, int(p)): i for i, p in enumerate(positions)}
    ku, vu = _unrounded(tbp, torch.from_numpy(h), H, cfg,
                        torch.from_numpy(positions), False)
    for mine, ref, un, sc in ((tc[0], jout[1], ku, tc[2]),
                              (tc[1], jout[2], vu, tc[3])):
        scales = sc[slot, :, off:off + C].float().numpy().T     # (C, H)
        _assert_int8_agree(mine, ref, un.numpy(), scales, written)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_slots_block_matches_jax(rig, quant):
    cfg, m, tm = rig
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    h = np.random.RandomState(9).randn(3, 1, D).astype(np.float32)
    pos = np.array([27, 0, cfg.max_len - 1], np.int32)
    wd = "int8" if quant else None
    c = _caches(cfg, 10, quant)
    jc, tc = _jcaches(c), _tcaches(c)
    qkw = lambda cc: (dict(k_scale=cc[2], v_scale=cc[3]) if quant  # noqa
                      else {})
    jout = jgpt._block_decode_slots(
        m.decode_params(weight_dtype=wd)["blocks"][1], jnp.asarray(h),
        jc[0], jc[1], jnp.asarray(pos), H, scale, cfg.use_rope,
        cfg.rope_base, **qkw(jc))
    tbp = tm.decode_params(weight_dtype=wd)["blocks"][1]
    tout = tgpt._block_decode_slots(
        tbp, torch.from_numpy(h), tc[0], tc[1], torch.from_numpy(pos), H,
        scale, cfg.use_rope, cfg.rope_base, **qkw(tc))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-5)
    if not quant:
        for mine, ref in zip(tout[1:], jout[1:]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       atol=1e-5)
        return
    for mine, ref in zip(tout[3:], jout[3:]):
        np.testing.assert_array_equal(_np(mine), _np(ref))
    written = {(s, int(p)): s for s, p in enumerate(pos)}
    ku, vu = _unrounded(tbp, torch.from_numpy(h), H, cfg,
                        torch.from_numpy(pos), True)
    for mine, ref, un, sc in ((tc[0], jout[1], ku, tc[2]),
                              (tc[1], jout[2], vu, tc[3])):
        scales = np.stack([sc[s, :, p].float().numpy()
                           for s, p in enumerate(pos)])          # (S, H)
        _assert_int8_agree(mine, ref, un.numpy(), scales, written)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_slots_iterations_match_jax(rig, quant):
    """decode_slots_iteration: greedy tokens, positions and the active
    mask agree iteration by iteration; an inactive slot parks its write
    at L - 1 of its own row, so the active slots' written rows agree."""
    cfg, m, tm = rig
    H, D, S = cfg.n_heads, cfg.d_model, 3
    wd = "int8" if quant else None
    layers = [_caches(cfg, 20 + i, quant) for i in range(cfg.n_layers)]
    tok = np.array([5, 17, 0], np.int32)
    pos = np.array([27, 40, 9], np.int32)
    active = np.array([True, True, False])
    limits = np.array([31, 60, 63], np.int32)
    stops = np.full((S, 8), -1, np.int32)
    stops[1, 0] = 49                      # a stop no greedy token hits
    kw = dict(H=H, scale=1.0 / np.sqrt(D // H), rope=cfg.use_rope,
              base=cfg.rope_base)
    jstate = (tuple(_jcaches(c) for c in layers), jnp.asarray(tok),
              jnp.asarray(pos), jnp.asarray(active))
    tcaches = tuple(_tcaches(c) for c in layers)
    tstate = (torch.from_numpy(tok), torch.from_numpy(pos),
              torch.from_numpy(active))
    keys = jnp.zeros((S, 2), jnp.uint32)
    jparams = m.decode_params(weight_dtype=wd)
    tparams = tm.decode_params(weight_dtype=wd)
    zf, zi = np.zeros(S, np.float32), np.zeros(S, np.int32)
    for it in range(6):
        jc, jt, jpos, jact, keys = jgpt.decode_slots_iteration(
            jparams, jstate[0], *jstate[1:], jnp.asarray(zf),
            jnp.asarray(zi), keys, jnp.asarray(limits), jnp.asarray(stops),
            **kw)
        jstate = (jc, jt, jpos, jact)
        tc, tt, tpos, tact = tgpt.decode_slots_iteration(
            tparams, tcaches, *tstate, torch.from_numpy(zf),
            torch.from_numpy(zi), None, torch.from_numpy(limits),
            torch.from_numpy(stops), **kw)
        assert tc is tcaches
        tstate = (tt, tpos, tact)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"iteration {it}")
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert not tstate[2].numpy()[0]                # slot 0 hit its limit
    if not quant:
        for (k, v), (jk, jv) in zip(tcaches, jstate[0]):
            for s in range(2):
                cols = slice(pos[s], int(tstate[1][s]))
                np.testing.assert_allclose(k.numpy()[s, :, cols],
                                           np.asarray(jk)[s, :, cols],
                                           atol=1e-5)
                np.testing.assert_allclose(v.numpy()[s, :, cols],
                                           np.asarray(jv)[s, :, cols],
                                           atol=1e-5)


# ---- the engines ---------------------------------------------------------

@pytest.mark.parametrize("which", ["slot", "mono"])
def test_staggered_stream_matches_jax_engines(served, stream_stops,
                                              jax_streams, which):
    """The port's slot chunked engine and its monolithic engine give the
    JAX slot engine's and JAX monolithic engine's greedy tokens, request
    by request (request 2 stops early on its stop token)."""
    _, tm, cfg = served
    _, stops = stream_stops
    kw = SLOT_KW if which == "slot" else MONO_KW
    launches = fa.launches
    out = _staggered(TorchEngine(tm, device="cpu", **kw), _prompts(cfg),
                     stops)
    assert fa.launches == launches                 # CPU: plain versions
    for ref in jax_streams.values():
        for i, (a, b) in enumerate(zip(ref, out)):
            np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    assert len(out[2]) == 3 and out[2][-1] == stops[2][0]


def test_slot_equals_paged_equals_generate(served, stream_stops):
    _, tm, cfg = served
    free, _ = stream_stops
    paged = _staggered(TorchEngine(tm, device="cpu", **PAGED_KW),
                       _prompts(cfg), [()] * 6)
    for i, (p, n) in enumerate(zip(_prompts(cfg), BUDGETS)):
        want = tm.generate(p, n)[0]
        np.testing.assert_array_equal(free[i], want, err_msg=f"slot {i}")
        np.testing.assert_array_equal(paged[i], want, err_msg=f"paged {i}")


def test_mid_horizon_stop(served):
    """A stop token that lands inside a horizon ends its request there
    (the device drops the slot from its mask mid-horizon and the host
    replays the same predicate); the neighbour decodes on unharmed."""
    _, tm, cfg = served
    a, b = _stream(cfg.vocab_size, 6, seed=1), _stream(cfg.vocab_size, 9,
                                                       seed=2)
    free_a, free_b = tm.generate(a, 30)[0], tm.generate(b, 30)[0]
    j = next(j for j in range(5, 30)
             if j % 8 not in (0, 7) and free_a[j] not in free_a[:j])
    eng = TorchEngine(tm, device="cpu", **dict(SLOT_KW, decode_horizon=8))
    ra = eng.submit(a, 30, stop_tokens=(int(free_a[j]),))
    rb = eng.submit(b, 30)
    res = eng.run()
    np.testing.assert_array_equal(res[ra], free_a[:j + 1])
    np.testing.assert_array_equal(res[rb], free_b)
    assert eng.metrics.snapshot()["horizon_blocks"] > 0


@pytest.mark.parametrize("kw", [SLOT_KW, MONO_KW], ids=["slot", "mono"])
def test_slot_reuse_after_eviction_leaks_nothing(served, kw):
    """One slot: a long request leaves stale K/V past the next prompt's
    end; every request still equals its own generate()."""
    _, tm, cfg = served
    prompts = _prompts(cfg)
    eng = TorchEngine(tm, device="cpu", **dict(kw, n_slots=1))
    rids = [eng.submit(prompts[i], BUDGETS[i]) for i in (3, 1, 4)]
    res = eng.run()
    for r, i in zip(rids, (3, 1, 4)):
        np.testing.assert_array_equal(res[r],
                                      tm.generate(prompts[i], BUDGETS[i])[0])
    assert eng.kv.free_slots == 1 and eng.kv.live_bytes() == 0


def test_slot_steady_state_uploads_nothing_and_fetches_once_per_horizon(
        served):
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **SLOT_KW)
    for i in range(3):
        eng.submit(_stream(cfg.vocab_size, 6 + i, seed=40 + i), 30)
    while eng.queue or eng._lane is not None:
        eng.step()
    assert eng.kv.active_slots == 3           # every prompt admitted
    before = eng.metrics.snapshot()
    res = eng.run()
    after = eng.metrics.snapshot()
    assert len(res) == 3
    assert after["host_uploads"] == before["host_uploads"]
    blocks = after["horizon_blocks"] - before["horizon_blocks"]
    assert blocks > 0
    assert after["host_syncs"] - before["host_syncs"] == blocks


def test_monolithic_one_sync_per_step_and_per_admission(served):
    _, tm, cfg = served
    eng = TorchEngine(tm, device="cpu", **dict(MONO_KW, n_slots=2))
    for i in range(3):
        eng.submit(_stream(cfg.vocab_size, 5 + 9 * i, seed=60 + i), 6)
    assert eng.decode_horizon == 1
    while eng.queue or eng.kv.active_slots:
        before = eng.metrics.snapshot()
        queued, free = len(eng.queue), eng.kv.free_slots
        eng.step()
        after = eng.metrics.snapshot()
        admitted = min(queued, free)
        syncs = after["host_syncs"] - before["host_syncs"]
        uploads = after["host_uploads"] - before["host_uploads"]
        assert syncs == admitted + 1 and uploads == admitted + 5
    assert len(eng.results()) == 3
    assert eng.metrics.snapshot()["horizon_blocks"] == 0


def test_monolithic_sampling_matches_the_chunked_engine(served):
    """The monolithic engine's sampled requests draw from their own
    generators in the order the slot chunked engine draws, so both give
    the same tokens."""
    _, tm, cfg = served
    prompts = [_stream(cfg.vocab_size, n, seed=71 + n) for n in (11, 26, 6)]
    outs = []
    for kw in (dict(SLOT_KW, chunk_tokens=4), MONO_KW):
        eng = TorchEngine(tm, device="cpu", **kw)
        rids = [eng.submit(p, 7, temperature=0.8, top_k=5, seed=3 + i)
                for i, p in enumerate(prompts)]
        res = eng.run()
        outs.append([res[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_bucket", [16, 32])
def test_monolithic_min_bucket_sets_the_prefill_width(served, min_bucket):
    """A 6-token prompt is prefilled padded to ``min_bucket``: its slot
    row holds K/V up to the bucket's end and nothing past it; the token
    is the same."""
    _, tm, cfg = served
    p = _stream(cfg.vocab_size, 6, seed=81)
    eng = TorchEngine(tm, device="cpu", **dict(MONO_KW, min_bucket=min_bucket))
    rid = eng.submit(p, 1)
    np.testing.assert_array_equal(eng.run()[rid], tm.generate(p, 1)[0])
    k = eng.kv.caches[0][0][0]                           # slot 0 (H, L, dh)
    assert k[:, min_bucket - 1].abs().sum() > 0
    assert k[:, min_bucket:].abs().sum() == 0


# ---- the int8 slot engine ------------------------------------------------

def _rig_prompts(vocab):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in (5, 9, 13, 6, 20)]


@pytest.fixture(scope="module")
def jax_int8_tokens(rig):
    cfg, m, _ = rig
    eng = JaxEngine(m, admit_lanes=1, **QKW)
    rids = [eng.submit(p, 10) for p in _rig_prompts(cfg.vocab_size)]
    res = eng.run()
    return [res[r].tolist() for r in rids]


def test_int8_slot_engine_matches_jax(rig, jax_int8_tokens):
    cfg, _, tm = rig
    eng = TorchEngine(tm, device="cpu", **QKW)
    assert eng.kv.quantized and isinstance(eng.kv, SlotKVCache)
    assert eng.params["head"]["W"].dtype == torch.int8
    rids = [eng.submit(p, 10) for p in _rig_prompts(cfg.vocab_size)]
    res = eng.run()
    assert [res[r].tolist() for r in rids] == jax_int8_tokens


def test_int8_slot_engine_same_seed_and_exact_bytes(rig):
    cfg, _, tm = rig
    prompts = _rig_prompts(cfg.vocab_size)

    def run():
        eng = TorchEngine(tm, device="cpu", **QKW)
        rids = [eng.submit(p, 9, temperature=0.9 * (i % 2), top_k=6,
                           seed=i) for i, p in enumerate(prompts[:3])]
        res = eng.run()
        return eng, [res[r] for r in rids]

    eng, a = run()
    _, b = run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    dh = cfg.d_model // cfg.n_heads
    b16 = TorchEngine(tm, device="cpu",
                      **dict(QKW, kv_dtype="bfloat16", weight_dtype=None))
    assert eng.kv.nbytes() / b16.kv.nbytes() == (dh + 2) / (2 * dh)
    assert eng.metrics.snapshot()["kv_bytes_committed"] == eng.kv.nbytes()
