"""Quantized serving of the port (int8 KV pages, per-channel int8
weights; singa_tpu_torch.precision, the quantization helpers and the
quantized decode blocks of singa_tpu_torch.models.gpt, the int8 and
bfloat16-page plain paged decode, PagedKVCache's 4-leaf pool and the
engine's kv_dtype / weight_dtype / scale_dtype) against the JAX package
on the reference's rig, GPTConfig(50, 128, 2, 4, 64), with and without
RoPE, from the same seeded weights and numpy inputs.

Tolerances: int8 planes and scales bit-identical where the inputs are
identical; hidden states atol 1e-5; pages written from hidden states
that agree to float noise may differ by one int8 step only where the
unrounded value lies within 1e-5 (relative) of a rounding boundary;
greedy engine tokens identical.  The port's own contracts are the
reference's: the committed drift tolerances against the float engine
(tests/test_quantized_serving.py), same-seed determinism, the exact
(d_head + 2) / (2 d_head) byte ratio, zero steady-state uploads.

The JAX engines compile their programs once per module (module-scoped
fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import precision as jprecision
from singa_tpu import tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu_torch import opt as topt
from singa_tpu_torch import precision as tprecision
from singa_tpu_torch.layer import apply_rope
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.ops import paged_attention as pa_mod
from singa_tpu_torch.serving import PagedKVCache
from singa_tpu_torch.serving import ServingEngine as TorchEngine

torch.set_num_threads(1)

# the reference's committed drift tolerances
LOGIT_MAE_TOL = 0.05
LOGIT_MAX_TOL = 0.25
LOG_PPL_TOL = 0.02

PAGE = 8
QKW = dict(n_slots=2, page_tokens=PAGE, kv_dtype="int8",
           weight_dtype="int8", prefix_cache=False)
BKW = dict(n_slots=2, page_tokens=PAGE, kv_dtype="bfloat16",
           prefix_cache=False)


def _prompts(vocab):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in (5, 9, 13, 6, 20)]


@pytest.fixture(scope="module", params=[False, True], ids=["pos", "rope"])
def rig(request):
    """The reference's quantized-serving rig (d_head 32), its JAX model
    and the port's model on the CPU from the same weights."""
    cfg = jgpt.GPTConfig(vocab_size=50, d_model=128, n_layers=2, n_heads=4,
                         max_len=64, use_rope=request.param)
    np.random.seed(0)
    m = jgpt.GPT(cfg)
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32))],
              is_train=False, use_graph=False)
    m.eval()
    tree = jax.tree.map(np.asarray, m.decode_params())
    tcfg = tgpt.GPTConfig(50, 128, 2, 4, 64, use_rope=request.param)
    tm = tgpt.GPT.from_jax_decode_params(tree, tcfg, device="cpu")
    return cfg, m, tm


@pytest.fixture(scope="module")
def port_engines(rig):
    """The port's shared int8 and bf16-storage engines (each test drains
    what it submits)."""
    _, _, tm = rig
    return (TorchEngine(tm, device="cpu", **QKW),
            TorchEngine(tm, device="cpu", **BKW))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _bf16_round(a):
    """float32 numpy values rounded to bfloat16 (and back), so both
    frameworks start from the same bf16 numbers."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ---- the quantization helpers -----------------------------------------

@pytest.mark.parametrize("sd", ["bfloat16", "float32"])
def test_quantize_rows_matches_jax(sd):
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 4, 7, 32) * rng.uniform(0.01, 5, (3, 4, 7, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                               # the 1e-8 amax floor
    jq, js = jgpt._quantize_rows(jnp.asarray(x), jnp.dtype(sd))
    tq, ts = tgpt._quantize_rows(torch.from_numpy(x), getattr(torch, sd))
    assert tq.dtype == torch.int8 and ts.dtype == getattr(torch, sd)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("sd", ["bfloat16", "float32"])
def test_quantize_channels_matches_jax(sd):
    rng = np.random.RandomState(4)
    W = (0.02 * rng.randn(48, 96) * rng.uniform(0.1, 3, (1, 96))
         ).astype(np.float32)
    W[:, 5] = 0.0
    jq, js = jgpt._quantize_channels(jnp.asarray(W), jnp.dtype(sd))
    tq, ts = tgpt._quantize_channels(torch.from_numpy(W), getattr(torch, sd))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


def test_decode_params_int8_matches_jax_and_is_memoized(rig):
    cfg, m, tm = rig
    want = dict(_leaves(m.decode_params(weight_dtype="int8")))
    tree = tm.decode_params(weight_dtype="int8")
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    assert sum(name.endswith(".Ws") for name in got) == 6 * 2 + 1
    for name, a in want.items():
        assert str(got[name].dtype).endswith(str(a.dtype)), name
        np.testing.assert_array_equal(_np(got[name]), _np(a), err_msg=name)
    assert tm.decode_params(weight_dtype="int8") is tree
    assert tm.decode_params("int8", torch.float32) is not tree
    # embeddings and LayerNorms stay float and shared with the model
    assert tree["tok"].data_ptr() == tm.tok.W.data.data_ptr()


def test_int8_engine_serves_weights_after_training_and_set_states():
    """The memoised int8 tree follows the model's weights: an int8 engine
    built after a training step, or after ``set_states``, holds a fresh
    ``_quantize_channels`` of the new Linear weights."""
    cfg = tgpt.GPTConfig(50, 64, 2, 4, 64)
    tm = tgpt.GPT(cfg, device="cpu")
    tm.set_optimizer(topt.Adam(lr=1e-2))
    x = np.random.RandomState(2).randint(0, 50, (2, 16)).astype(np.int32)
    tm.compile([x], is_train=True)

    def check(eng):
        for lay, p in ((tm.head, eng.params["head"]),
                       (tm.blocks[1].attn.Wq, eng.params["blocks"][1]["q"]),
                       (tm.blocks[0].fc2, eng.params["blocks"][0]["f2"])):
            wq, ws = tgpt._quantize_channels(lay.W.data)
            assert torch.equal(p["W"], wq) and torch.equal(p["Ws"], ws)

    first = TorchEngine(tm, device="cpu", **QKW).params
    check(TorchEngine(tm, device="cpu", **QKW))
    # weights unchanged: the memo stands
    assert tm.decode_params("int8")["head"]["W"] is first["head"]["W"]
    tm.train_one_batch(x, np.roll(x, -1, axis=1))
    trained = TorchEngine(tm, device="cpu", **QKW)
    check(trained)
    assert not torch.equal(trained.params["head"]["W"], first["head"]["W"])
    tm.set_states({k: 0.5 * t.numpy() for k, t in tm.get_states().items()})
    restored = TorchEngine(tm, device="cpu", **QKW)
    check(restored)
    assert not torch.equal(restored.params["head"]["Ws"],
                           trained.params["head"]["Ws"])


# ---- the plain paged decode, int8 and bf16 pages ----------------------

def _paged_case(variant, stale):
    S, H, d, P, Ps, N = (5, 3, 32, 4, 6, 31) if stale else \
        (3, 2, 16, 8, 4, 10)
    rng = np.random.RandomState(5 if stale else 6)
    q = rng.randn(S, H, d).astype(np.float32)
    if stale:
        table = rng.randint(0, N, size=(S, Ps)).astype(np.int32)
        pos = np.array([0, 5, 23, 11, 16], np.int32)
    else:
        table = np.array([[3, 7, 1, 0], [2, 0, 0, 0], [9, 4, 5, 8]],
                         np.int32)                  # NULL tails
        pos = np.array([17, 3, 30], np.int32)       # mid-page frontiers
    if variant == "bf16_pages":
        kp = _bf16_round(rng.randn(N, H, P, d).astype(np.float32))
        vp = _bf16_round(rng.randn(N, H, P, d).astype(np.float32))
        return q, kp, vp, table, pos, None, None
    kp = rng.randint(-127, 128, (N, H, P, d)).astype(np.int8)
    vp = rng.randint(-127, 128, (N, H, P, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (N, H, P)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (N, H, P)).astype(np.float32)
    if variant == "int8_bf16_scales":
        ks, vs = _bf16_round(ks), _bf16_round(vs)
    return q, kp, vp, table, pos, ks, vs


@pytest.mark.parametrize("stale", [False, True],
                         ids=["serving_table", "random_stale_table"])
@pytest.mark.parametrize("variant", ["int8_bf16_scales", "int8_f32_scales",
                                     "bf16_pages"])
def test_plain_paged_decode_matches_jax_kernel(variant, stale):
    q, kp, vp, table, pos, ks, vs = _paged_case(variant, stale)
    low = jnp.bfloat16 if variant != "int8_f32_scales" else jnp.float32
    tlow = torch.bfloat16 if variant != "int8_f32_scales" else torch.float32
    if variant == "bf16_pages":
        jkw, tkw = {}, {}
        jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (kp, vp))
        tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kp, vp))
    else:
        jkw = dict(k_scales=jnp.asarray(ks).astype(low),
                   v_scales=jnp.asarray(vs).astype(low))
        tkw = dict(k_scales=torch.from_numpy(ks).to(tlow),
                   v_scales=torch.from_numpy(vs).to(tlow))
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    ref = np.asarray(jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(table),
                               jnp.asarray(pos), interpret=True, **jkw))
    before = (pa_mod.launches, pa_mod.launches_q8)
    got = pa_mod.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos), **tkw)
    assert (pa_mod.launches, pa_mod.launches_q8) == before   # CPU: no kernel
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# ---- the quantized decode blocks --------------------------------------

def _pools(cfg, seed, quant=True):
    """Random int8 page pools with random bf16 scales for one layer."""
    rng = np.random.RandomState(seed)
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    N = 1 + 3 * (cfg.max_len // PAGE)
    kp = rng.randint(-127, 128, (N, H, PAGE, dh)).astype(np.int8)
    vp = rng.randint(-127, 128, (N, H, PAGE, dh)).astype(np.int8)
    ks = _bf16_round(rng.uniform(0.005, 0.03, (N, H, PAGE)).astype(
        np.float32))
    vs = _bf16_round(rng.uniform(0.005, 0.03, (N, H, PAGE)).astype(
        np.float32))
    return kp, vp, ks, vs


def _jpools(pools):
    kp, vp, ks, vs = pools
    return (jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(ks).astype(jnp.bfloat16),
            jnp.asarray(vs).astype(jnp.bfloat16))


def _tpools(pools):
    kp, vp, ks, vs = pools
    return (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
            torch.from_numpy(ks).to(torch.bfloat16),
            torch.from_numpy(vs).to(torch.bfloat16))


def _table(cfg):
    Ps = cfg.max_len // PAGE
    table = np.zeros((3, Ps), np.int32)
    table[0, :4] = [3, 7, 1, 9]                    # NULL tail
    table[1, :] = np.arange(10, 10 + Ps)
    table[2, :3] = [2, 19, 4]
    return table


def _unrounded_kv(bp, h, H, rope, positions, base, decode):
    """The K and V rows of a block before quantization, (rows, H, dh),
    from the port's own float math."""
    x = tgpt._ln(h, bp["ln1"])
    k = tgpt._heads(tgpt._lin(x, bp["k"]), H)
    v = tgpt._heads(tgpt._lin(x, bp["v"]), H)
    if rope:
        k = (tgpt._rope_rows(k, positions, base) if decode
             else apply_rope(k, positions=positions, base=base))
    if decode:
        return k[:, :, 0], v[:, :, 0]
    return k[0].transpose(0, 1), v[0].transpose(0, 1)


def _assert_int8_pools_agree(mine, ref, unrounded, scales, where):
    """Equal, except one int8 step where the unrounded value lies within
    1e-5 (relative) of a rounding boundary."""
    mine, ref = mine.numpy().astype(np.int32), np.asarray(ref).astype(
        np.int32)
    bad = np.argwhere(mine != ref)
    for idx in bad:
        idx = tuple(idx)
        assert abs(mine[idx] - ref[idx]) == 1, idx
        row = where(idx)
        assert row is not None, f"entry {idx} differs outside the write"
        u = float(unrounded[row][idx[-1]] / scales[row])
        frac = u - np.floor(u)
        assert abs(frac - 0.5) <= 1e-5 * max(1.0, abs(u)), (idx, u)


def test_quantized_prefill_block_matches_jax(rig):
    cfg, m, tm = rig
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    rng = np.random.RandomState(7)
    C, off = 16, 8
    h = rng.randn(1, C, D).astype(np.float32)
    pools = _pools(cfg, 8)
    row = _table(cfg)[0]
    positions = off + np.arange(C)
    jbp = m.decode_params(weight_dtype="int8")["blocks"][0]
    tbp = tm.decode_params(weight_dtype="int8")["blocks"][0]
    jh, jk, jv, jks, jvs = jgpt._block_chunk_prefill_paged(
        jbp, jnp.asarray(h), *_jpools(pools)[:2], jnp.asarray(row),
        jnp.asarray(positions), H, scale, cfg.use_rope, cfg.rope_base,
        k_scale=_jpools(pools)[2], v_scale=_jpools(pools)[3])
    tk, tv, tks, tvs = _tpools(pools)
    th, tk2, tv2, tks2, tvs2 = tgpt._block_chunk_prefill_paged(
        tbp, torch.from_numpy(h), tk, tv, torch.from_numpy(row),
        torch.from_numpy(positions), H, scale, cfg.use_rope, cfg.rope_base,
        k_scale=tks, v_scale=tvs)
    assert tk2 is tk and tks2 is tks                 # updated in place
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_array_equal(_np(tks), _np(jks))
    np.testing.assert_array_equal(_np(tvs), _np(jvs))
    phys, offs = row[positions // PAGE], positions % PAGE
    slot_of = {(int(p), int(o)): i for i, (p, o) in enumerate(zip(phys,
                                                                  offs))}
    ku, vu = _unrounded_kv(tbp, torch.from_numpy(h), H, cfg.use_rope,
                           torch.from_numpy(positions), cfg.rope_base, False)
    for mine, ref, un, sc in ((tk, jk, ku, tks), (tv, jv, vu, tvs)):
        def where(idx):
            i = slot_of.get((idx[0], idx[2]))
            return None if i is None else (i, idx[1])
        scales = {(i, hh): float(sc[p, hh, o]) for (p, o), i in
                  slot_of.items() for hh in range(H)}
        _assert_int8_pools_agree(mine, ref, un.numpy(), scales, where)


def test_quantized_decode_block_matches_jax(rig):
    cfg, m, tm = rig
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    rng = np.random.RandomState(9)
    h = rng.randn(3, 1, D).astype(np.float32)
    pools = _pools(cfg, 10)
    table = _table(cfg)
    dpos = np.array([27, 40, cfg.max_len - 1], np.int32)
    active = np.array([True, True, False])
    jbp = m.decode_params(weight_dtype="int8")["blocks"][1]
    tbp = tm.decode_params(weight_dtype="int8")["blocks"][1]
    jp = _jpools(pools)
    jh, jk, jv, jks, jvs = jgpt._block_decode_slots_paged(
        jbp, jnp.asarray(h), jp[0], jp[1], jnp.asarray(table),
        jnp.asarray(dpos), jnp.asarray(active), H, scale, cfg.use_rope,
        cfg.rope_base, k_scale=jp[2], v_scale=jp[3])
    tk, tv, tks, tvs = _tpools(pools)
    th = tgpt._block_decode_slots_paged(
        tbp, torch.from_numpy(h), tk, tv, torch.from_numpy(table),
        torch.from_numpy(dpos), torch.from_numpy(active), H, scale,
        cfg.use_rope, cfg.rope_base, k_scale=tks, v_scale=tvs)[0]
    # the inactive slot's row is garbage by contract (stale table row)
    np.testing.assert_allclose(th.numpy()[:2], np.asarray(jh)[:2], atol=1e-5)
    written = {(int(table[s, dpos[s] // PAGE]), int(dpos[s] % PAGE)): s
               for s in range(2)}
    ku, vu = _unrounded_kv(tbp, torch.from_numpy(h), H, cfg.use_rope,
                           torch.from_numpy(dpos), cfg.rope_base, True)
    for (pg, o), s in written.items():
        for mine, ref in ((tks, jks), (tvs, jvs)):
            np.testing.assert_array_equal(_np(mine[pg, :, o]),
                                          _np(ref[pg, :, o]))
    for mine, ref, un, sc in ((tk, jk, ku, tks), (tv, jv, vu, tvs)):
        def where(idx):
            s = written.get((idx[0], idx[2]))
            return None if s is None else (s, idx[1])
        scales = {(s, hh): float(sc[pg, hh, o])
                  for (pg, o), s in written.items() for hh in range(H)}
        # page 0 holds the inactive slot's parked write: garbage
        live, ref = mine.clone(), np.asarray(ref).copy()
        live[0], ref[0] = 0, 0
        _assert_int8_pools_agree(live, ref, un.numpy(), scales, where)


def test_quantized_decode_iterations_match_jax(rig):
    """decode_slots_iteration_paged over 4-leaf layers: greedy tokens,
    positions and the active mask agree iteration by iteration."""
    cfg, m, tm = rig
    H, D = cfg.n_heads, cfg.d_model
    S = 3
    table = _table(cfg)
    layers = [_pools(cfg, 20 + i) for i in range(cfg.n_layers)]
    tok = np.array([5, 17, 0], np.int32)
    pos = np.array([27, 40, 9], np.int32)
    active = np.array([True, True, False])
    limits = np.array([31, 60, 63], np.int32)
    stops = np.full((S, 8), -1, np.int32)
    kw = dict(H=H, scale=1.0 / np.sqrt(D // H), rope=cfg.use_rope,
              base=cfg.rope_base, max_len=cfg.max_len)
    jstate = (tuple(_jpools(p) for p in layers), jnp.asarray(tok),
              jnp.asarray(pos), jnp.asarray(active))
    tpages = tuple(_tpools(p) for p in layers)
    tstate = (torch.from_numpy(tok), torch.from_numpy(pos),
              torch.from_numpy(active))
    keys = jnp.zeros((S, 2), jnp.uint32)
    jparams = m.decode_params(weight_dtype="int8")
    tparams = tm.decode_params(weight_dtype="int8")
    zf, zi = np.zeros(S, np.float32), np.zeros(S, np.int32)
    for it in range(6):
        jpg, jt, jpos, jact, keys = jgpt.decode_slots_iteration_paged(
            jparams, jstate[0], jnp.asarray(table), *jstate[1:],
            jnp.asarray(zf), jnp.asarray(zi), keys, jnp.asarray(limits),
            jnp.asarray(stops), **kw)
        jstate = (jpg, jt, jpos, jact)
        _, tt, tpos, tact = tgpt.decode_slots_iteration_paged(
            tparams, tpages, torch.from_numpy(table), *tstate,
            torch.from_numpy(zf), torch.from_numpy(zi), None,
            torch.from_numpy(limits), torch.from_numpy(stops), **kw)
        tstate = (tt, tpos, tact)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"iteration {it}")
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert not tstate[2].numpy()[0]                # slot 0 hit its limit


# ---- the engines --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens(rig):
    """Greedy tokens of the JAX int8 and bf16-storage engines (one
    admission lane) on the rig's prompts."""
    cfg, m, _ = rig
    out = {}
    for name, kw in (("int8", QKW), ("bf16", BKW)):
        eng = JaxEngine(m, paged=True, admit_lanes=1, **kw)
        rids = [eng.submit(p, 10) for p in _prompts(cfg.vocab_size)]
        res = eng.run()
        out[name] = [res[r].tolist() for r in rids]
    return out


@pytest.mark.parametrize("which", ["int8", "bf16"])
def test_engine_greedy_tokens_match_jax(rig, port_engines, jax_tokens,
                                        which):
    cfg, _, _ = rig
    eng = port_engines[0 if which == "int8" else 1]
    launches = pa_mod.launches_q8
    rids = [eng.submit(p, 10) for p in _prompts(cfg.vocab_size)]
    res = eng.run()
    assert [res[r].tolist() for r in rids] == jax_tokens[which]
    assert pa_mod.launches_q8 == launches          # CPU: no kernel
    if which == "int8":
        assert eng.kv.quantized and len(eng.kv.caches[0]) == 4
        assert eng.kv.caches[0][0].dtype == torch.int8
        assert eng.kv.caches[0][2].dtype == torch.bfloat16
        assert eng.params["head"]["W"].dtype == torch.int8
    else:
        assert not eng.kv.quantized and len(eng.kv.caches[0]) == 2
        assert eng.kv.caches[0][0].dtype == torch.bfloat16
        assert eng.params["head"]["W"].dtype == torch.float32


def test_same_seed_determinism(rig, port_engines):
    """Same seed, same tokens — greedy and sampled, on the reused engine
    and on a freshly built one (which quantizes nothing anew: the
    model's quantized tree is memoised)."""
    cfg, _, tm = rig
    prompts = _prompts(cfg.vocab_size)
    outs = []
    for eng in (port_engines[0], TorchEngine(tm, device="cpu", **QKW)):
        rids = [eng.submit(prompts[0], 12),
                eng.submit(prompts[1], 12, temperature=0.8, top_k=5,
                           seed=7)]
        res = eng.run()
        outs.append([res[r].tolist() for r in rids])
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == 12


def _prefill_logits(tm, tokens, quant):
    """Teacher-forced logits of one prompt through the port's paged
    prefill blocks (one chunk over fresh pages), float or int8 params
    and pages."""
    cfg = tm.config
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    params = tm.decode_params(weight_dtype="int8" if quant else None)
    T = len(tokens)
    n = -(-T // PAGE) + 1
    shape = (n, H, PAGE, dh)
    layers = []
    for _ in range(cfg.n_layers):
        if quant:
            layers.append((torch.zeros(shape, dtype=torch.int8),
                           torch.zeros(shape, dtype=torch.int8),
                           torch.zeros(shape[:3], dtype=torch.bfloat16),
                           torch.zeros(shape[:3], dtype=torch.bfloat16)))
        else:
            layers.append((torch.zeros(shape), torch.zeros(shape)))
    row = torch.arange(1, n, dtype=torch.int32)
    positions = torch.arange(T)
    h = tgpt._embed(params, torch.from_numpy(tokens)[None], positions,
                    cfg.use_rope)
    for bp, kv in zip(params["blocks"], layers):
        kp, vp, ks, vs = tgpt._layer_kv(kv)
        h = tgpt._block_chunk_prefill_paged(
            bp, h, kp, vp, row, positions, H, 1.0 / np.sqrt(dh),
            cfg.use_rope, cfg.rope_base, k_scale=ks, v_scale=vs)[0]
    return tgpt._logits(params, h)[0].double().numpy()


def test_drift_within_committed_tolerance(rig):
    """int8 params and pages against the port's own float ones, through
    the prefill blocks: logit MAE, max and log-perplexity drift under
    the reference's committed tolerances."""
    cfg, _, tm = rig
    prompt = np.random.RandomState(11).randint(
        0, cfg.vocab_size, 24).astype(np.int32)
    lf = _prefill_logits(tm, prompt, quant=False)
    lq = _prefill_logits(tm, prompt, quant=True)
    assert np.abs(lq - lf).mean() <= LOGIT_MAE_TOL
    assert np.abs(lq - lf).max() <= LOGIT_MAX_TOL
    assert 0 < np.abs(lq - lf).max()              # it did quantize

    def log_ppl(logits):
        mx = logits.max(-1, keepdims=True)
        lp = logits - mx - np.log(np.exp(logits - mx).sum(-1, keepdims=True))
        return -lp[np.arange(len(prompt) - 1), prompt[1:]].mean()

    assert abs(log_ppl(lq) - log_ppl(lf)) <= LOG_PPL_TOL


def _admit_all(eng, subs):
    """Submit, drive every admission out, return the live bytes then,
    and drain."""
    rids = [eng.submit(p, n) for p, n in subs]
    while eng.queue or eng._lane is not None:
        eng.step()
    live = eng.kv.live_bytes()
    res = eng.run()
    assert set(rids) <= set(res)
    return live


def test_byte_ratio_is_exact(rig, port_engines):
    """(d_head + 2) / (2 d_head) against the bf16 pool, for nbytes and for
    live bytes at the same occupancy; (d_head + 2) / (4 d_head) against
    float32."""
    cfg, _, _ = rig
    dh = cfg.d_model // cfg.n_heads
    want = (dh + 2) / (2 * dh)
    q8, b16 = port_engines
    assert q8.kv.nbytes() / b16.kv.nbytes() == want
    subs = [(p, 8) for p in _prompts(cfg.vocab_size)[:2]]
    assert _admit_all(q8, subs) / _admit_all(b16, subs) == want
    kw = dict(n_layers=2, n_slots=4, n_heads=4, page_tokens=PAGE, d_head=dh,
              max_len=64, device="cpu")
    assert PagedKVCache(kv_dtype="int8", **kw).nbytes() \
        / PagedKVCache(**kw).nbytes() == (dh + 2) / (4 * dh)
    assert PagedKVCache(kv_dtype="int8", scale_dtype=torch.float32,
                        **kw).nbytes() / PagedKVCache(**kw).nbytes() \
        == (dh + 4) / (4 * dh)
    assert q8.metrics.snapshot()["kv_bytes_committed"] == q8.kv.nbytes()


def test_warm_shared_prefix_repeat_equals_cold(rig):
    """Prefix-shared pages share their scales: a warm repeat maps the
    cold run's int8 pages and scales and gives the same tokens; a
    diverging suffix gets fresh pages and the tokens of a fresh
    engine."""
    cfg, _, tm = rig
    eng = TorchEngine(tm, device="cpu", **dict(QKW, prefix_cache=True))
    p = np.random.RandomState(12).randint(0, cfg.vocab_size,
                                          21).astype(np.int32)
    rid = eng.submit(p, 8)
    cold = eng.run()[rid]
    rid = eng.submit(p, 8)
    warm = eng.run()[rid]
    np.testing.assert_array_equal(warm, cold)
    assert eng.kv.prefix_hit_rate > 0
    q = p.copy()
    q[12] = (q[12] + 1) % cfg.vocab_size
    rid = eng.submit(q, 8)
    div = eng.run()[rid]
    fresh = TorchEngine(tm, device="cpu", **QKW)
    r = fresh.submit(q, 8)
    np.testing.assert_array_equal(div, fresh.run()[r])


def test_steady_state_uploads_nothing(rig, port_engines):
    cfg, _, _ = rig
    eng = port_engines[0]
    for i in range(2):
        eng.submit(_prompts(cfg.vocab_size)[i], 30)
    while eng.queue or eng._lane is not None:
        eng.step()
    before = eng.metrics.snapshot()
    res = eng.run()
    after = eng.metrics.snapshot()
    assert len(res) >= 2
    assert after["host_uploads"] == before["host_uploads"]
    blocks = after["horizon_blocks"] - before["horizon_blocks"]
    assert blocks > 0
    assert after["host_syncs"] - before["host_syncs"] == blocks


# ---- construction gates and the policy ----------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(kv_dtype="float8_e4m3fn"), "fp8.*'cpu'"),
    (dict(weight_dtype="float8_e5m2"), "fp8.*'cpu'"),
    (dict(kv_dtype="float16"), "not a supported quantization dtype"),
    (dict(kv_dtype="int8", scale_dtype="float16"), "scale_dtype"),
    (dict(kv_dtype="int8", chunked=False), "chunked"),
    (dict(weight_dtype="int8", chunked=False), "chunked"),
], ids=["fp8_kv", "fp8_weights", "float16_kv", "float16_scales",
        "int8_kv_monolithic", "int8_weights_monolithic"])
def test_construction_gates(rig, kw, match):
    _, _, tm = rig
    with pytest.raises(ValueError, match=match):
        TorchEngine(tm, device="cpu", n_slots=2, page_tokens=PAGE, **kw)


def test_precision_policy_matches_reference_fields():
    assert tprecision.QUANT_DTYPES == jprecision.QUANT_DTYPES
    assert tprecision.FP8_DTYPES == jprecision.FP8_DTYPES
    assert tprecision.validate_quant_dtype(None) is None
    assert tprecision.validate_quant_dtype("int8") is torch.int8
    for bad in ("float8_e4m3fn", "float8_e5m2"):
        with pytest.raises(ValueError, match="'cuda'"):
            tprecision.validate_quant_dtype(bad, backend="cuda")
        with pytest.raises(ValueError, match="backend"):
            jprecision.validate_quant_dtype(bad, backend="cpu")
    pol = tprecision.Policy(kv_dtype="int8", weight_dtype="int8")
    ref = jprecision.Policy(jnp.float32, kv_dtype="int8",
                            weight_dtype="int8")
    assert pol.quantized and ref.quantized
    assert tprecision.dtype_name(pol.scale_dtype) == ref.scale_dtype.name
    assert not tprecision.Policy().quantized
    # mixed compute is the mixed-precision slice's: the fields as JAX's
    mixed = tprecision.Policy(torch.bfloat16, kv_dtype="int8")
    jmixed = jprecision.Policy(jnp.bfloat16, kv_dtype="int8")
    assert (mixed.mixed, mixed.quantized, repr(mixed)) == \
        (jmixed.mixed, jmixed.quantized, repr(jmixed))
    with pytest.raises(ValueError, match="scale_dtype"):
        tprecision.Policy(kv_dtype="int8", scale_dtype=torch.float16)
