"""The port's mixed-precision slice (singa_tpu_torch.precision, the policy
paths of opt, model and models.gpt, the engines' 16-bit caches, and the
16-bit operands of the flash and paged-decode plain versions) against the
JAX package on the same seeded numpy inputs, on the CPU.

Tolerances, with the reason for each:

* the loss-scale schedule, the policies' fields and ``repr``: exact;
* the reference's test MLP (tests/test_precision.py:28) under bf16 and
  fp16: the first step's loss bit-equal and its float32 masters within
  ``lr`` times one unit in the last place of the compute dtype at the
  gradient's magnitude (a bf16 gradient is a sum rounded to 8 bits, and
  the two frameworks' sums round differently in the last bit); over 20
  steps the trajectories drift apart as any bf16 pair does, so the last
  loss is held to 2 % of JAX's, the reference's own bf16-against-fp32
  bound (``test_bf16_tracks_fp32_mlp``); observed on this CPU: 1.3e-2
  eager, 1.8e-2 graph, at most, over the 20 losses;
* the fp16 overflow step: every parameter and optimizer state
  bit-identical, the scale as JAX's, exactly;
* GPT tiny under bf16, 3 Adam steps against JAX in graph mode: losses
  relative 1e-3; every float32 master within twice Adam's 3-step bound
  of JAX's and 97 % of them within 1e-4 (Adam's normalised step turns a
  bf16-noise gradient into a move of up to lr either way; see the test);
  ``decode_params()`` leaf for leaf: bf16, bit-equal to JAX's;
* bf16 and fp16 greedy tokens of ``generate`` and the paged, slot and
  monolithic engines: identical to JAX's ``generate`` under the same
  policy; ``kv_dtype="int8"`` under bf16 and fp16: identical to the JAX
  engine's tokens;
* the flash and paged-decode plain versions on 16-bit operands against
  the JAX kernels in interpret mode: within one unit in the last place
  of the output dtype at ``max(|x|, 2^-6)`` (both compute in float32 and
  round once; a float32 difference flips at most the last bit), lse
  and the float32 partials at 1e-5 relative.

The two flash repairs each have a test that fails on the parent tree:
``delta`` formed in float32 (the bf16 gradients against ``jax.vjp``),
and the split route's ``o`` in q's dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import precision as jprecision
from singa_tpu import tensor as jtensor
from singa_tpu.model import Model as JModel
from singa_tpu.models import gpt as jgpt
from singa_tpu.ops.paged_attention import paged_decode_attention as jpaged
from singa_tpu.ops.pallas_kernels import flash_attention as jflash
from singa_tpu.serving import ServingEngine as JEngine
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch import precision as tprecision
from singa_tpu_torch.model import Model as TModel
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.serving import ServingEngine
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

LOWP = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 8),
        "float16": (torch.float16, jnp.float16, 11)}
ULP_FLOOR = 2.0 ** -6


def _ulps(got, ref, bits):
    """Largest |got - ref| in units in the last place (``bits`` of
    significand) at max(|got|, |ref|, ULP_FLOOR)."""
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(r)), ULP_FLOOR))
    return float((np.abs(g - r) / np.ldexp(1.0, e - bits)).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- the policies -------------------------------------------------------

def test_dynamic_loss_scale_matches_jax_step_for_step():
    """Growth after the interval, backoff on overflow, the 1.0 floor and
    the overflow flag consumed by ``update``, against the JAX object."""
    j = jprecision.DynamicLossScale(initial=4.0, growth_factor=2.0,
                                    backoff_factor=0.25, growth_interval=3)
    t = tprecision.DynamicLossScale(initial=4.0, growth_factor=2.0,
                                    backoff_factor=0.25, growth_interval=3)
    assert [x.name for x in t.state_tensors()] == \
        [x.name for x in j.state_tensors()]
    overflow = [False, False, False, True, False, True, True, True, False,
                False, False, False]
    for i, inf in enumerate(overflow):
        j.record(jnp.asarray(inf))
        t.record(torch.tensor(inf))
        j.record(jnp.asarray(False))            # a later finite apply
        t.record(torch.tensor(False))
        assert bool(t.found_inf.data) == bool(j.found_inf.data) == inf
        j.update()
        t.update()
        assert float(t.scale.data) == float(j.scale.data), i
        assert int(t.good_steps.data) == int(j.good_steps.data), i
        assert not bool(t.found_inf.data) and not bool(j.found_inf.data)
        assert t.scale.data.dtype == torch.float32
    assert float(t.scale.data) == 2.0        # the floor, then one growth


def test_dynamic_loss_scale_update_votes_through_a_reducer():
    """``update(reducer=)`` backs off when the reduced overflow flag is
    set, as the JAX object's: the reducer here adds a second rank's flag
    (overflowed at steps 1 and 3), this rank's overflows at step 2."""
    j = jprecision.DynamicLossScale(initial=8.0, growth_interval=2)
    t = tprecision.DynamicLossScale(initial=8.0, growth_interval=2)
    other = [False, True, False, True, False, False]
    mine = [False, False, True, False, False, False]
    for i, (o, m) in enumerate(zip(other, mine)):
        j.record(jnp.asarray(m))
        t.record(torch.tensor(m))
        j.update(lambda v, o=o: v + float(o))
        t.update(lambda v, o=o: v + float(o))
        assert float(t.scale.data) == float(j.scale.data), i
        assert int(t.good_steps.data) == int(j.good_steps.data), i
        assert not bool(t.found_inf.data)
    assert float(t.scale.data) == 2.0   # three backoffs to the floor, a growth


@pytest.mark.parametrize("spec", ["float32", "bfloat16", "float16", None])
def test_get_policy_and_fields_match_jax(spec):
    j, t = jprecision.get_policy(spec), tprecision.get_policy(spec)
    if spec is None:
        assert t is None and j is None
        return
    assert repr(t) == repr(j)
    assert (t.mixed, t.active, t.name, t.quantized) == \
        (j.mixed, j.active, j.name, j.quantized)
    assert (t.loss_scale is None) == (j.loss_scale is None)
    assert tprecision.get_policy(t) is t
    g = tprecision.with_update_guard(spec)
    jg = jprecision.with_update_guard(spec)
    assert repr(g) == repr(jg)
    assert float(g.loss_scale.scale.data) == float(jg.loss_scale.scale.data)
    assert g.loss_scale.backoff_factor == jg.loss_scale.backoff_factor


def test_policy_object_and_bad_names():
    p = tprecision.Policy(torch.bfloat16, kv_dtype="int8",
                          scale_dtype="float32")
    jp = jprecision.Policy(jnp.bfloat16, kv_dtype="int8",
                           scale_dtype="float32")
    assert repr(p) == repr(jp) and p.active and p.quantized
    for bad in ("float64", "bf16"):
        with pytest.raises(ValueError):
            tprecision.get_policy(bad)
    with pytest.raises(ValueError):
        tgpt.GPT(tgpt.GPTConfig.tiny(precision="half"), device="cpu")


def test_master_swap_keeps_the_same_float32_leaf():
    """``begin_step`` gives each float32 parameter a compute-dtype leaf
    that requires grad; ``end_step`` puts back the very same float32
    leaf; integer state and non-parameters are untouched."""
    pol = tprecision.get_policy("bfloat16")
    w = Tensor(data=torch.ones(3, 2), device="cpu", stores_grad=True)
    buf = Tensor(data=torch.ones(3), device="cpu", requires_grad=False)
    leaf = w.data

    class Opt:
        _masters = None

    opt = Opt()
    token = pol.begin_step([w, buf], opt)
    assert w.data.dtype == torch.bfloat16 and w.data.requires_grad
    assert w.data.is_leaf and opt._masters == {id(w): leaf}
    assert buf.data.dtype == torch.float32
    pol.end_step(token, opt)
    assert w.data is leaf and opt._masters == {}
    x = torch.ones(2, dtype=torch.float32)
    assert pol.cast_input(x).dtype == torch.bfloat16
    assert pol.cast_input(x.int()).dtype == torch.int32
    assert pol.cast_output(x.bfloat16()).dtype == torch.float32


# ---- the reference's MLP ------------------------------------------------

def _blobs(n=256, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    y = rng.randint(0, classes, n)
    x = centers[y] + rng.randn(n, dim)
    return x.astype(np.float32), y.astype(np.int32)


class JMLP(JModel):
    """tests/test_precision.py's MLP."""

    def __init__(self):
        super().__init__()
        self.fc1 = jlayer.Linear(32)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = jautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


class TMLP(TModel):
    def __init__(self):
        super().__init__()
        self.fc1 = tlayer.Linear(32)
        self.relu = tlayer.ReLU()
        self.fc2 = tlayer.Linear(4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = tautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


LR = 0.1


def _mlp_pair(precision, use_graph, steps, policy=None):
    """Both MLPs from the JAX model's initial weights, ``steps`` steps of
    SGD(0.1, momentum 0.9) on the blobs; returns both models, both loss
    lists and the data."""
    np.random.seed(7)
    x_np, y_np = _blobs()
    jm = JMLP()
    jm.set_optimizer(jopt.SGD(lr=LR, momentum=0.9))
    jx, jy = jtensor.from_numpy(x_np), jtensor.from_numpy(y_np)
    jm.compile([jx], is_train=True, use_graph=use_graph,
               precision=policy[0] if policy else precision)
    init = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
    tm = TMLP()
    tm.set_optimizer(topt.SGD(lr=LR, momentum=0.9))
    tm.compile([Tensor(data=x_np, device="cpu", requires_grad=False)],
               is_train=True, use_graph=use_graph,
               precision=policy[1] if policy else precision)
    tm.set_states(init)
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(jm.train_one_batch(jx, jy)[1].data))
        tl.append(float(tm.train_one_batch(x_np, y_np)[1].data))
    return jm, tm, jl, tl, (x_np, y_np)


@pytest.mark.parametrize("precision,use_graph", [
    ("bfloat16", False), ("bfloat16", True), ("float16", True)],
    ids=["bfloat16-eager", "bfloat16-graph", "float16-graph"])
def test_mlp_first_step_matches_jax(precision, use_graph):
    jm, tm, jl, tl, _ = _mlp_pair(precision, use_graph, 1)
    bits = LOWP[precision][2]
    assert tl[0] == pytest.approx(jl[0], rel=1e-6)
    for name, t in tm.get_states().items():
        assert t.data.dtype == torch.float32, name
        want = np.asarray(jm.get_states()[name].data)
        # one unit of the compute dtype at the gradient's magnitude, per
        # unit of learning rate
        step = np.abs(want - t.numpy()).max()
        grad_mag = np.abs(want).max() / LR + 1.0
        assert step <= LR * np.ldexp(1.0, int(np.frexp(grad_mag)[1])
                                     - bits), name


@pytest.mark.parametrize("use_graph", [False, True], ids=["eager", "graph"])
def test_bf16_mlp_20_steps_tracks_jax(use_graph):
    jm, tm, jl, tl, _ = _mlp_pair("bfloat16", use_graph, 20)
    assert tl[-1] < tl[0] * 0.5
    assert abs(tl[-1] - jl[-1]) / jl[-1] < 0.02
    for name, t in tm.get_states().items():
        assert t.data.dtype == torch.float32, name
        assert t.data.is_leaf and t.data.requires_grad
    _, tm32, _, t32, _ = _mlp_pair("float32", use_graph, 20)
    assert abs(tl[-1] - t32[-1]) / t32[-1] < 0.02


def test_fp16_overflow_step_is_an_exact_noop_and_scale_grows():
    """Three normal fp16 steps, then a batch scaled by 1e8: every
    parameter and momentum bit-identical, the scale halved as JAX's;
    then with a growth interval of 2 the scale doubles after two good
    steps, as JAX's."""
    pols = (jprecision.Policy(jnp.float16, loss_scale=jprecision.
                              DynamicLossScale(growth_interval=2)),
            tprecision.Policy(torch.float16, loss_scale=tprecision.
                              DynamicLossScale(growth_interval=2)))
    jm, tm, jl, tl, (x_np, y_np) = _mlp_pair("float16", True, 3, pols)
    tls, jls = pols[1].loss_scale, pols[0].loss_scale
    assert float(tls.scale.data) == float(jls.scale.data) == 2.0 ** 16
    before = {n: t.data.clone() for n, t in tm.get_states().items()}
    # the counter advances on a skipped step, as the reference's does
    opt_before = {t.name: t.data.clone()
                  for t in tm.optimizer.state_tensors()
                  if not t.name.startswith("loss") and t.name != "opt_step"}
    big = x_np * 1e8
    jm.train_one_batch(jtensor.from_numpy(big), jtensor.from_numpy(y_np))
    tm.train_one_batch(big, y_np)
    assert tm.optimizer.step_counter.item() == \
        int(jm.optimizer.step_counter.data) == 4
    for n, t in tm.get_states().items():
        assert torch.equal(t.data, before[n]), n
    for t in tm.optimizer.state_tensors():
        if t.name in opt_before:
            assert torch.equal(t.data, opt_before[t.name]), t.name
    assert float(tls.scale.data) == float(jls.scale.data) == 2.0 ** 15
    assert int(tls.good_steps.data) == 0
    for _ in range(2):
        jm.train_one_batch(jtensor.from_numpy(x_np), jtensor.from_numpy(y_np))
        tm.train_one_batch(x_np, y_np)
    assert float(tls.scale.data) == float(jls.scale.data) == 2.0 ** 16
    states = tm.optimizer.get_states()
    assert {"loss_scale", "loss_scale_good_steps",
            "loss_scale_found_inf"} <= set(states)
    assert float(states["loss_scale"]) == 2.0 ** 16


def test_loss_scaled_apply_needs_the_rounds_verdict():
    """Under a loss scale the overflow verdict is ``_backward``'s, one for
    the round and recorded into the scale once: ``apply`` alone raises,
    and an overflowed round sets ``found_inf`` before any update runs."""
    o = topt.SGD(lr=0.1)
    pol = tprecision.get_policy("float16")
    o.attach_precision_policy(pol)
    p = Tensor(data=np.ones((2, 2), np.float32), device="cpu",
               requires_grad=True, stores_grad=True)
    with pytest.raises(RuntimeError, match="overflow verdict"):
        o.apply(p, Tensor(data=np.ones((2, 2), np.float16), device="cpu"))
    tautograd.training = True
    try:
        x = Tensor(data=np.full((1, 2), 6e4, np.float16), device="cpu")
        loss = tautograd.reduce_mean(
            tautograd.matmul(x, tautograd.cast(p, torch.float16)))
        pairs = o._backward(loss)
    finally:
        tautograd.training = False
    assert pairs and not bool(o._round_finite)
    assert bool(pol.loss_scale.found_inf.data)


# ---- GPT tiny under bf16 ------------------------------------------------

GPT_LR, GPT_STEPS, B, T = 1e-3, 3, 2, 16


def _stream(vocab, n, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab if rng.rand() > 0.1 \
            else rng.randint(vocab)
    return x


@pytest.fixture(scope="module", params=["flash", "naive"])
def trained_bf16(request):
    """JAX and port GPT tiny under bf16 from the same weights, 3 Adam
    steps each on the same batches (JAX in graph mode; its flash runs
    the Pallas kernels in interpret mode)."""
    import conftest

    flash = request.param == "flash"
    np.random.seed(0)
    cfg = jgpt.GPTConfig.tiny(use_flash=flash, precision="bfloat16")
    data = _stream(cfg.vocab_size, GPT_STEPS * B * T + 1, seed=5)
    batches = [(data[s * B * T:(s + 1) * B * T].reshape(B, T),
                data[s * B * T + 1:(s + 1) * B * T + 1].reshape(B, T))
               for s in range(GPT_STEPS)]
    m = jgpt.GPT(cfg)
    m.set_optimizer(jopt.Adam(lr=GPT_LR))
    with conftest.xla_cache_paused():
        m.compile([jtensor.from_numpy(batches[0][0])], is_train=True,
                  use_graph=True)
        start = jax.tree.map(np.asarray, m.get_states())
        j_loss = [float(m.train_one_batch(jtensor.from_numpy(x),
                                          jtensor.from_numpy(y))[1].numpy())
                  for x, y in batches]
    m.eval()
    tm = tgpt.GPT.from_jax_states(
        start, tgpt.GPTConfig.tiny(use_flash=flash, precision="bfloat16"),
        device="cpu")
    tm.set_optimizer(topt.Adam(lr=GPT_LR))
    tm.compile([batches[0][0]], is_train=True, use_graph=True)
    t_loss = [tm.train_one_batch(x, y)[1].item() for x, y in batches]
    tm.eval()
    return dict(m=m, tm=tm, j_loss=j_loss, t_loss=t_loss, cfg=cfg)


def _adam_max_move(steps, b1=0.9, b2=0.999):
    """The most bias-corrected Adam moves one entry in ``steps`` steps
    (tests/test_torch_gpt_train.py): about lr a step."""
    total = 0.0
    for t in range(1, steps + 1):
        age = t - np.arange(1, t + 1)
        w = (1 - b1) * b1 ** age / (1 - b1 ** t)
        u = (1 - b2) * b2 ** age / (1 - b2 ** t)
        total += np.sqrt((w * w / u).sum())
    return GPT_LR * total


def test_gpt_bf16_train_matches_jax(trained_bf16):
    """Losses within 1e-3 (observed 5.6e-4 at step 0: XLA keeps excess
    precision across a fused bf16 chain, the port rounds every op).  The
    float32 masters: Adam's normalised step turns a gradient at bf16
    noise level into a move of up to lr of either sign, so an entry may
    differ by up to twice Adam's bound (both sides within it); at least
    97 % of the entries agree within 1e-4 (observed 98.6 %); the key
    biases, whose exact gradient is zero, are left out of the count."""
    t = trained_bf16
    np.testing.assert_allclose(t["t_loss"], t["j_loss"], rtol=1e-3)
    js = t["m"].get_states()
    bound = 2 * _adam_max_move(GPT_STEPS) + 1e-6
    close = total = 0
    for name, x in t["tm"].get_states().items():
        assert x.data.dtype == torch.float32, name
        diff = np.abs(x.numpy() - np.asarray(js[name].data))
        assert diff.max() <= bound, name
        if not name.endswith("Wk.b"):
            close += int((diff <= 1e-4).sum())
            total += diff.size
    assert close / total >= 0.97


def test_gpt_bf16_decode_params_leaf_for_leaf(trained_bf16):
    """From the same float32 masters, every decode leaf is bf16 and
    bit-equal to JAX's."""
    m, tm = trained_bf16["m"], trained_bf16["tm"]
    states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    fresh = tgpt.GPT.from_jax_states(
        states, tgpt.GPTConfig.tiny(precision="bfloat16"), device="cpu")
    jtree = jax.tree_util.tree_flatten_with_path(m.decode_params())[0]
    ttree = fresh.decode_params()
    assert tm.decode_params()["tok"].dtype == torch.bfloat16
    for path, leaf in jtree:
        node = ttree
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert leaf.dtype == jnp.bfloat16 and node.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(leaf), node.float().numpy(),
                                      err_msg=str(path))


@pytest.fixture(scope="module")
def served_bf16():
    """The lightly trained tiny GPT of the serving tests (JAX, float32
    training), run under a bf16 policy on both sides."""
    import conftest

    np.random.seed(0)
    cfg = jgpt.GPTConfig.tiny()
    m = jgpt.GPT(cfg)
    m.set_optimizer(jopt.Adam(lr=3e-3))
    data = _stream(cfg.vocab_size, 8 * 32 * 4 + 1, seed=0)
    with conftest.xla_cache_paused():
        m.compile([jtensor.from_numpy(data[:8 * 32].reshape(8, 32))],
                  is_train=True, use_graph=True)
        for s in range(4):
            seg = data[s * 256:(s + 1) * 256 + 1]
            m.train_one_batch(jtensor.from_numpy(seg[:-1].reshape(8, 32)),
                              jtensor.from_numpy(seg[1:].reshape(8, 32)))
    m.eval()
    m.set_precision_policy("bfloat16")
    states = jax.tree.map(np.asarray, m.get_states())
    tm = tgpt.GPT.from_jax_states(
        states, tgpt.GPTConfig.tiny(precision="bfloat16"), device="cpu")
    prompts = [_stream(cfg.vocab_size, n, seed=30 + n) for n in (7, 12, 15)]
    return m, tm, prompts


N_NEW = 8


def test_bf16_generate_and_engines_match_jax_generate(served_bf16):
    """Greedy bf16 tokens: the port's ``generate`` and its paged, slot
    and monolithic engines against JAX's bf16 ``generate`` (reference
    tests/test_serving.py:129)."""
    m, tm, prompts = served_bf16
    want = [np.asarray(m.generate(p, N_NEW)[0]) for p in prompts]
    for p, w in zip(prompts, want):
        np.testing.assert_array_equal(tm.generate(p, N_NEW)[0], w)
    for kw in (dict(paged=True, page_tokens=8), dict(paged=False),
               dict(paged=False, chunked=False)):
        eng = ServingEngine(tm, n_slots=2, device="cpu", **kw)
        pools = eng.kv.caches[0][0]
        assert pools.dtype == torch.bfloat16, kw
        rids = [eng.submit(p, N_NEW) for p in prompts]
        res = eng.run()
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(res[rid], w, err_msg=str(kw))


def test_bf16_int8_kv_engine_matches_jax_engine(served_bf16):
    """``kv_dtype="int8"`` under bf16 on the paged layout: int8 pools and
    bf16 scales, the same greedy tokens as the JAX engine's."""
    m, tm, prompts = served_bf16
    kw = dict(n_slots=2, kv_dtype="int8", paged=True, page_tokens=8)
    jeng = JEngine(m, **kw)
    jr = [jeng.submit(p, N_NEW) for p in prompts]
    jres = jeng.run()
    eng = ServingEngine(tm, device="cpu", **kw)
    assert eng.kv.caches[0][0].dtype == torch.int8
    tr = [eng.submit(p, N_NEW) for p in prompts]
    tres = eng.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tres[b], np.asarray(jres[a]))


def test_fp16_engines_on_every_layout_match_fp16_generate(served_bf16):
    """The same weights under the float16 policy on both sides: float16
    pools and slots on every layout, greedy tokens of the port's
    ``generate`` and of its paged, slot and monolithic engines identical
    to JAX's fp16 ``generate``; int8 pages under fp16 identical to the
    JAX int8 engine's tokens."""
    m, _, prompts = served_bf16
    states = jax.tree.map(np.asarray, m.get_states())
    tm = tgpt.GPT.from_jax_states(
        states, tgpt.GPTConfig.tiny(precision="float16"), device="cpu")
    assert tm.decode_params()["tok"].dtype == torch.float16
    m.set_precision_policy("float16")
    try:
        assert m.decode_params()["tok"].dtype == jnp.float16
        want = [np.asarray(m.generate(p, N_NEW)[0]) for p in prompts]
        q8 = dict(n_slots=2, paged=True, page_tokens=8, kv_dtype="int8")
        jeng = JEngine(m, **q8)
        jr = [jeng.submit(p, N_NEW) for p in prompts]
        jres = jeng.run()
        want8 = [np.asarray(jres[r]) for r in jr]
    finally:
        m.set_precision_policy("bfloat16")
    for p, w in zip(prompts, want):
        np.testing.assert_array_equal(tm.generate(p, N_NEW)[0], w)
    for kw, wants in ((dict(paged=True, page_tokens=8), want),
                      (dict(paged=False), want),
                      (dict(paged=False, chunked=False), want),
                      (q8, want8)):
        eng = ServingEngine(tm, device="cpu", **dict(dict(n_slots=2), **kw))
        assert eng.kv.caches[0][0].dtype == (
            torch.int8 if "kv_dtype" in kw else torch.float16), kw
        rids = [eng.submit(p, N_NEW) for p in prompts]
        res = eng.run()
        for rid, w in zip(rids, wants):
            np.testing.assert_array_equal(res[rid], w, err_msg=str(kw))


# ---- the flash repairs --------------------------------------------------

def _flash_inputs(seed, B, H, Tq, S, d, dtype):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, d).astype(np.float32)
               for n in (Tq, S, S))
    do = (0.1 * rng.randn(B, H, Tq, d)).astype(np.float32)
    tdt, jdt, bits = LOWP[dtype]
    # round once to the 16-bit dtype, so both sides see the same values
    rounded = [np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
               for a in (q, k, v, do)]
    return rounded, tdt, jdt, bits


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_16bit_gradients_match_jax_vjp(dtype, causal):
    """The port's differentiable flash attention on 16-bit CPU tensors
    against ``jax.vjp`` of the Pallas kernels (interpret mode) on the
    same values: o, dq, dk, dv within one unit of the dtype.  ``delta``
    must be formed from the float32-upcast dO and O
    (pallas_kernels.py:290): rounded to 16 bits it moves the gradients
    by many units."""
    (q, k, v, do), tdt, jdt, bits = _flash_inputs(3, 1, 2, 24, 24, 16,
                                                  dtype)
    out_j, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal),
                         *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do, jdt))
    ts = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out_t = fa.flash_attention(*ts, causal=causal)
    assert out_t.dtype == tdt
    grads_t = torch.autograd.grad(out_t, ts, torch.tensor(do).to(tdt))
    assert _ulps(out_t.detach().float(), _np(out_j), bits) <= 1
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        assert gt.dtype == tdt
        assert _ulps(gt.float(), _np(gj), bits) <= 1, f"d{name}"


def test_flash_bwd_delta_is_float32():
    """``flash_attention_bwd`` hands the dq and dk/dv kernels a float32
    delta = rowsum(dO * O) of the upcast operands."""
    (q, k, v, do), tdt, _, _ = _flash_inputs(4, 1, 1, 8, 8, 16, "bfloat16")
    q3, k3, v3, do3 = (torch.tensor(x[0]).to(tdt) for x in (q, k, v, do))
    o3, lse = fa.flash_attention_fwd(q3, k3, v3, None, 0.25, "none", False)
    seen = []
    real = fa.flash_attention_bwd_dq

    def spy(*args):
        seen.append(args[5])
        return real(*args)

    fa.flash_attention_bwd_dq = spy
    try:
        fa.flash_attention_bwd(q3, k3, v3, None, o3, lse, do3, 0.25, "none",
                               False)
    finally:
        fa.flash_attention_bwd_dq = real
    assert seen[0].dtype == torch.float32
    torch.testing.assert_close(
        seen[0], (do3.double() * o3.double()).sum(-1).float(), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_split_route_returns_q_dtype(dtype):
    """The key split (partial then combine, as ``flash_attention_fwd``
    composes them) returns o in q's dtype, within one unit of the unsplit
    plain version; lse float32."""
    (q, k, v, _), tdt, _, bits = _flash_inputs(5, 1, 2, 64, 300, 32, dtype)
    q3, k3, v3 = (torch.tensor(x[0]).to(tdt) for x in (q, k, v))
    plan = fa._fwd_split_plan(2, 64, 300, False, n_sm=1 << 20)
    assert plan.n_split > 1
    o, lse = fa._fwd_split(q3, k3, v3, None, 0.2, "none", False, plan)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, None, 0.2,
                                                "none", False)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert _ulps(o.float(), ro.float(), bits) <= 1
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


# ---- the plain versions on 16-bit operands against the JAX kernels -------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_forward_16bit_matches_jax(dtype):
    """The plain forward (dense mask, every head dim class) on 16-bit
    operands against the Pallas forward in interpret mode."""
    (q, k, v, _), tdt, jdt, bits = _flash_inputs(6, 2, 2, 24, 70, 32, dtype)
    rng = np.random.RandomState(6)
    mask = np.where(rng.rand(2, 1, 24, 70) < 0.2, -1e9, 0.0).astype(
        np.float32)
    want = jflash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                  jnp.asarray(mask))
    got = fa.flash_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                             torch.tensor(mask))
    assert got.dtype == tdt
    assert _ulps(got.float(), _np(want), bits) <= 1


@pytest.mark.parametrize("pages,scales", [
    ("bfloat16", None), ("float16", None), ("int8", "bfloat16"),
    ("float32", None)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_paged_decode_16bit_query_matches_jax(dtype, pages, scales):
    """The plain paged decode with a 16-bit query over float, 16-bit or
    int8 pages against the Pallas kernel in interpret mode: the output in
    the query's dtype, within one unit of it."""
    tdt, jdt, bits = LOWP[dtype]
    rng = np.random.RandomState(8)
    S, H, d, P, Ps, N = 3, 2, 16, 8, 4, 13
    q = np.asarray(jnp.asarray(rng.randn(S, H, d), jdt).astype(jnp.float32))
    table = rng.randint(0, N, (S, Ps)).astype(np.int32)
    pos = np.array([-1, 9, 31], np.int32)
    if pages == "int8":
        kp, vp = (rng.randint(-127, 128, (N, H, P, d)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (np.asarray(jnp.asarray(0.002 + 0.03 * rng.rand(N, H, P),
                                         jnp.bfloat16).astype(jnp.float32))
                  for _ in range(2))
        jkw = dict(k_scales=jnp.asarray(ks, jnp.bfloat16),
                   v_scales=jnp.asarray(vs, jnp.bfloat16))
        tkw = dict(k_scales=torch.tensor(ks).bfloat16(),
                   v_scales=torch.tensor(vs).bfloat16())
        jk, jv, tk, tv = (jnp.asarray(kp), jnp.asarray(vp),
                          torch.tensor(kp), torch.tensor(vp))
    else:
        pj = {"bfloat16": jnp.bfloat16, "float16": jnp.float16,
              "float32": jnp.float32}[pages]
        kp, vp = (np.asarray(jnp.asarray(rng.randn(N, H, P, d), pj).astype(
            jnp.float32)) for _ in range(2))
        jk, jv = jnp.asarray(kp, pj), jnp.asarray(vp, pj)
        tk, tv = (torch.tensor(x).to(getattr(torch, pages))
                  for x in (kp, vp))
        jkw, tkw = {}, {}
    want = jpaged(jnp.asarray(q, jdt), jk, jv, jnp.asarray(table),
                  jnp.asarray(pos), interpret=True, **jkw)
    got = pa.paged_decode_attention(torch.tensor(q).to(tdt), tk, tv,
                                    torch.tensor(table), torch.tensor(pos),
                                    **tkw)
    assert got.dtype == tdt and want.dtype == jdt
    assert _ulps(got.float(), _np(want), bits) <= 1


# ---- float32 cache rows under a bf16 policy ------------------------------

MIXED_ROWS_MAG = 64.0
MIXED_ULPS = 16


@pytest.fixture(scope="module")
def bf16_blocks():
    """Layer 0's bf16 decode block of GPT tiny under the bf16 policy, JAX
    and port from the same float32 masters."""
    np.random.seed(11)
    cfg = jgpt.GPTConfig.tiny(precision="bfloat16")
    m = jgpt.GPT(cfg)
    jgpt.ensure_decode_ready(m)
    states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    tm = tgpt.GPT.from_jax_states(
        states, tgpt.GPTConfig.tiny(precision="bfloat16"), device="cpu")
    return (cfg, m.decode_params()["blocks"][0],
            tm.decode_params()["blocks"][0])


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_bf16_chunk_attends_float32_rows_unrounded(bf16_blocks, layout):
    """``kv_dtype="float32"`` under a bf16 policy: the chunk's bf16
    queries attend over the float32 cache rows as they are, as the
    reference's flash does on mixed operands (each upcast as it is read,
    ``o`` in q's dtype; models/gpt.py:655-661, :966-975); only int8 rows
    are cast to q's dtype.  The block output against JAX's
    ``_block_chunk_prefill[_paged](flash=True)`` on the same seeded bf16
    chunk and float32 rows, within ``MIXED_ULPS`` units in the last place
    of bf16.  The rows are drawn at magnitude ``MIXED_ROWS_MAG`` (64),
    where the attention term dominates the block output: rounding the
    rows to bf16 before attention (what the port did) reads 249.5 units
    on pages and 240 on slots.  The sound path reads 2 and 4: each side
    computes the bf16 q with its own matmul, which may differ by a unit,
    and against keys of that magnitude a unit of q moves the sharp
    softmax's weights by a few units of the output (up to 8 observed at
    magnitude 128), so the limit is 16."""
    cfg, jbp, tbp = bf16_blocks
    H, D = cfg.n_heads, cfg.d_model
    dh, P = D // H, 8
    scale = 1.0 / np.sqrt(dh)
    rng = np.random.RandomState(2)
    C, off = 16, 8
    h = rng.randn(1, C, D).astype(np.float32)
    positions = off + np.arange(C)
    if layout == "paged":
        Ps = cfg.max_len // P
        shape = (1 + 2 * Ps, H, P, dh)
        row = np.arange(1, 1 + Ps).astype(np.int32)
        where = (row,)
        jfn, tfn = jgpt._block_chunk_prefill_paged, \
            tgpt._block_chunk_prefill_paged
    else:
        shape = (3, H, cfg.max_len, dh)
        where = (1, off)
        jfn, tfn = jgpt._block_chunk_prefill, tgpt._block_chunk_prefill
    kc, vc = (MIXED_ROWS_MAG * rng.randn(*shape).astype(np.float32)
              for _ in range(2))
    want = jfn(jbp, jnp.asarray(h, jnp.bfloat16), jnp.asarray(kc),
               jnp.asarray(vc), *map(jnp.asarray, where),
               jnp.asarray(positions), H, scale, cfg.use_rope,
               cfg.rope_base, flash=True)
    targs = [torch.from_numpy(np.asarray(w)) if isinstance(w, np.ndarray)
             else w for w in where]
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tfn(tbp, torch.from_numpy(h).bfloat16(), tk, tv, *targs,
              torch.from_numpy(positions), H, scale, cfg.use_rope,
              cfg.rope_base)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    assert tk.dtype == torch.float32 and got[1] is tk
    assert _ulps(got[0].float(), _np(want[0]), 8) <= MIXED_ULPS
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[1]))
