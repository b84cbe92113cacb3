"""The port's autograd ops and layers (singa_tpu_torch.autograd /
singa_tpu_torch.layer, on the CPU) against the JAX package's
(singa_tpu.autograd / singa_tpu.layer): the same seeded numpy inputs,
weights copied across by name, and the same cotangent through
``autograd.backward(y, dy)`` on both sides.  Forward outputs and the
gradients of every parameter and of the input agree to atol 1e-5 in
float32 (summation order only).  The flash path of MultiHeadAttention
runs the Pallas kernels in interpret mode on the JAX side and the port's
plain forward and backward on this one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import layer as jlayer
from singa_tpu.tensor import Tensor as JTensor
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch.model import Model
from singa_tpu_torch.tensor import Tensor as TTensor

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.fixture
def training():
    """Both autograds in training mode for the test, then back off."""
    jag.training = tag.training = True
    yield
    jag.training = tag.training = False


def _jt(a, param=False):
    return JTensor(data=a, requires_grad=param, stores_grad=param)


def _tt(a, param=False):
    return TTensor(data=a, device="cpu", requires_grad=param,
                   stores_grad=param)


def _named(pairs, xs):
    """Gradients keyed ``in<i>`` for the inputs, else by param name."""
    ids = {id(x): f"in{i}" for i, x in enumerate(xs)}
    return {ids.get(id(p), p.name): np.asarray(g) for p, g in pairs}


def _run(jfn, tfn, inputs, dy, param_inputs=(0,)):
    """Forward both sides on ``inputs`` (numpy; those at
    ``param_inputs`` as gradient-storing leaves) and backward with
    ``dy``; returns ``(j_out, t_out, j_grads, t_grads)``."""
    jx = [_jt(a, i in param_inputs) for i, a in enumerate(inputs)]
    tx = [_tt(a, i in param_inputs) for i, a in enumerate(inputs)]
    jy, ty = jfn(*jx), tfn(*tx)
    jg = _named(jag.backward(jy, np.asarray(dy)), jx)
    tg = _named(tag.backward(ty, torch.from_numpy(np.asarray(dy))), tx)
    return np.asarray(jy.data), ty.numpy(), jg, tg


def _check(j_out, t_out, jg, tg):
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=0)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def _copy_params(jl, tl):
    tl.set_params({k: np.asarray(v.data) for k, v in jl.get_params().items()})
    for k, t in tl.get_params().items():         # same names on both sides
        t.name = k
    for k, t in jl.get_params().items():
        t.name = k


def _layer_case(jl, tl, x, dy, *extra):
    """Initialise both layers on ``x``, copy the weights across, run."""
    jl(_jt(x), *[_jt(e) for e in extra])
    tl(_tt(x), *[_tt(e) for e in extra])
    _copy_params(jl, tl)
    inputs = (x,) + extra
    return _run(lambda *a: jl(*a), lambda *a: tl(*a), inputs, dy)


def test_linear(training):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 8).astype(np.float32)
    dy = rng.randn(2, 5, 6).astype(np.float32)
    _check(*_layer_case(jlayer.Linear(6), tlayer.Linear(6), x, dy))


def test_layernorm_with_trained_scale_and_bias(training):
    rng = np.random.RandomState(1)
    x = (3 + 2 * rng.randn(2, 4, 16)).astype(np.float32)
    dy = rng.randn(2, 4, 16).astype(np.float32)
    jl, tl = jlayer.LayerNorm(), tlayer.LayerNorm()
    jl(_jt(x))
    jl.set_params({"scale": rng.randn(16).astype(np.float32),
                   "bias": rng.randn(16).astype(np.float32)})
    tl(_tt(x))
    _copy_params(jl, tl)
    _check(*_run(jl, tl, (x,), dy))


def test_embedding_with_repeated_ids(training):
    rng = np.random.RandomState(2)
    w = rng.randn(10, 4).astype(np.float32)
    ids = np.array([[1, 3, 1, 7], [3, 3, 0, 1]], np.int32)
    dy = rng.randn(2, 4, 4).astype(np.float32)
    jl = jlayer.Embedding(10, 4)
    tl = tlayer.Embedding(10, 4, device="cpu")
    jl.set_params({"W": w})
    tl.set_params({"W": w})
    jl.W.name = tl.W.name = "W"
    j_out, t_out, jg, tg = _run(lambda i: jl(i), lambda i: tl(i), (ids,), dy,
                                param_inputs=())
    _check(j_out, t_out, jg, tg)
    # id 1 three times, 3 three times: their rows sum three cotangents
    np.testing.assert_allclose(tg["W"][1], dy[0, 0] + dy[0, 2] + dy[1, 3],
                               atol=1e-6)
    assert not tg["W"][2].any()


def test_exact_gelu(training):
    rng = np.random.RandomState(3)
    x = (2 * rng.randn(3, 7)).astype(np.float32)
    dy = rng.randn(3, 7).astype(np.float32)
    _check(*_run(jag.gelu, tag.gelu, (x,), dy))
    tanh_form = torch.nn.functional.gelu(torch.from_numpy(x),
                                         approximate="tanh").numpy()
    assert np.abs(tag.gelu(_tt(x)).numpy() - tanh_form).max() > 1e-4


@pytest.mark.parametrize("one_hot", [False, True], ids=["int", "one_hot"])
def test_softmax_cross_entropy(training, one_hot):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(6, 9)).astype(np.float32)
    t = rng.randint(0, 9, size=6).astype(np.int32)
    if one_hot:
        t = np.eye(9, dtype=np.float32)[t]
    _check(*_run(lambda lg: jag.softmax_cross_entropy(lg, _jt(t)),
                 lambda lg: tag.softmax_cross_entropy(lg, _tt(t)),
                 (logits,), np.float32(1.0)))


def test_softmax_matmul_transpose_reshape_chain(training):
    rng = np.random.RandomState(5)
    a = rng.randn(2, 3, 4).astype(np.float32)
    b = rng.randn(4, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    dy = rng.randn(5, 6).astype(np.float32)

    def chain(ag):
        def f(x, w, c):
            y = ag.add_bias(ag.matmul(x, w), c)
            y = ag.softmax(ag.mul(y, y), axis=-1)
            y = ag.transpose(ag.reshape(y, (6, 5)), (1, 0))
            return ag.add(y, ag.cast(y, y.data.dtype))
        return f
    _check(*_run(chain(jag), chain(tag), (a, b, bias), dy,
                 param_inputs=(0, 1, 2)))


def test_tied_parameter_gradients_accumulate(training):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 4).astype(np.float32)
    w = rng.randn(4, 4).astype(np.float32)
    dy = rng.randn(3, 4).astype(np.float32)

    def f(ag):
        return lambda x_, w_: ag.matmul(ag.matmul(x_, w_), w_)
    j_out, t_out, jg, tg = _run(f(jag), f(tag), (x, w), dy,
                                param_inputs=(0, 1))
    _check(j_out, t_out, jg, tg)
    assert len(tg) == 2


MHA_CASES = [(flash, causal, rope) for flash in (False, True)
             for causal, rope in ((False, False), (True, False),
                                  (True, True))]


@pytest.mark.parametrize("flash,causal,rope", MHA_CASES,
                         ids=[f"{'flash' if f else 'naive'}"
                              f"{'-causal' if c else ''}"
                              f"{'-rope' if r else ''}"
                              for f, c, r in MHA_CASES])
def test_multi_head_attention(training, flash, causal, rope):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 32).astype(np.float32)
    dy = rng.randn(2, 12, 32).astype(np.float32)
    kw = dict(use_flash=flash, causal=causal, rope=rope)
    jl = jlayer.MultiHeadAttention(2, **kw)
    tl = tlayer.MultiHeadAttention(2, **kw)
    extra = ()
    if not causal:           # a key-padding mask on the second batch row
        m = np.zeros((2, 1, 1, 12), np.float32)
        m[1, ..., 9:] = -1e9
        extra = (m,)
    _check(*_layer_case(jl, tl, x, dy, *extra))


def test_flash_none_resolves_by_device():
    tl = tlayer.MultiHeadAttention(2, use_flash=None)
    assert not tl._flash_resolved(_tt(np.zeros((1, 2, 4), np.float32)))
    assert tlayer.MultiHeadAttention(2, use_flash=True)._flash_resolved(
        _tt(np.zeros((1, 2, 4), np.float32)))


def test_out_of_slice_arguments_raise():
    """Sequence parallelism raises, naming its slice.  Attention dropout
    in training is ported now: it runs on the naive route (flash asked
    for or not), draws a fresh mask each call, and is the identity
    outside training."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlayer.MultiHeadAttention(2, seq_mesh=object())
    tl = tlayer.MultiHeadAttention(2, dropout=0.5, use_flash=True)
    x = _tt(np.random.RandomState(0).randn(1, 3, 4).astype(np.float32))
    plain = tl(x).numpy()
    tag.training = True
    try:
        a, b = tl(x).numpy(), tl(x).numpy()
    finally:
        tag.training = False
    assert a.shape == plain.shape and not np.array_equal(a, b)
    np.testing.assert_array_equal(tl(x).numpy(), plain)


class _Tiny(Model):
    def __init__(self):
        super().__init__()
        self.fc = tlayer.Linear(3)
        self.ln = tlayer.LayerNorm()

    def forward(self, x):
        return self.ln(self.fc(x))


def test_model_compile_names_and_places_the_state():
    m = _Tiny()
    out = m.compile([_tt(np.zeros((2, 5), np.float32))], is_train=False)
    assert out.shape == (2, 3)
    states = m.get_states()
    assert sorted(states) == ["fc.W", "fc.b", "ln.bias", "ln.scale"]
    assert all(t.name == k and t.data.device.type == "cpu"
               for k, t in states.items())
    assert not tag.training
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.compile([_tt(np.zeros((2, 5), np.float32))], mesh=object())
    # a communicator is ported (tests/test_torch_dist.py); a foreign
    # object is refused
    with pytest.raises(TypeError, match="Communicator"):
        m.compile([_tt(np.zeros((2, 5), np.float32))],
                  communicator=object())
    # a precision policy is installed (the mixed-precision slice)
    m.compile([_tt(np.zeros((2, 5), np.float32))], precision="bfloat16")
    assert m.precision_policy.compute_dtype == torch.bfloat16
    assert all(t.data.dtype == torch.float32 for t in states.values())


class _Carry(Model):
    """A step with a carried state, the RNN pattern:
    ``s' = tanh(x W + s)``, loss = mean(s'^2)."""

    def __init__(self):
        super().__init__()
        self.fc = tlayer.Linear(4, bias=False)

    def forward(self, x):
        return self.fc(x)

    def train_one_batch(self, x, s):
        s_new = tag.op("Tanh", torch.tanh, tag.add(self.fc(x), s))
        loss = tag.reduce_mean(tag.mul(s_new, s_new))
        self.optimizer(loss)
        return loss, s_new


@pytest.mark.parametrize("use_graph", [True, False])
def test_graph_mode_cuts_the_step_at_inputs_and_outputs(use_graph):
    """``use_graph=True``: the carried output leaves the step without a
    creator and feeds the next step, whose gradient stops there (the
    losses equal a run fed numpy copies of the state).  Eager mode keeps
    the output's graph as it is."""
    from singa_tpu_torch import opt as topt
    rng = np.random.RandomState(9)
    xs = [rng.randn(2, 3).astype(np.float32) for _ in range(3)]
    w0 = rng.randn(3, 4).astype(np.float32)
    runs = []
    for carry_tensor in (True, False):
        m = _Carry()
        m.set_optimizer(topt.SGD(lr=0.1))
        m.compile([_tt(xs[0])], is_train=True, use_graph=use_graph)
        m.set_states({"fc.W": w0})
        s = _tt(np.zeros((2, 4), np.float32))
        losses = []
        for x in xs[:1 if not use_graph else 3]:
            loss, s_new = m.train_one_batch(x, s)
            losses.append(loss.item())
            assert (s_new.creator is None) == use_graph
            s = s_new if carry_tensor else s_new.numpy().copy()
        runs.append(losses)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("axes", [[], ()])
def test_reduce_mean_over_no_axes_is_the_identity(training, axes):
    """``jnp.mean(axis=())`` reduces nothing; torch reads ``dim=()`` as
    every axis, so the port must not pass it through."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 3).astype(np.float32)
    dy = rng.randn(2, 3).astype(np.float32)
    j_out, t_out, jg, tg = _run(lambda v: jag.reduce_mean(v, axes=axes),
                                lambda v: tag.reduce_mean(v, axes=axes),
                                (x,), dy)
    assert t_out.shape == j_out.shape == (2, 3)
    np.testing.assert_array_equal(t_out, np.asarray(jnp.mean(x, axis=())))
    _check(j_out, t_out, jg, tg)


# ids against a table of n = 5 rows: in range, wrapped (-1, -n) and out
# of range (n, -n-1), the last two giving NaN rows with no gradient
GATHER_IDS = {"mixed": [[1, -1, 5], [-5, 4, -6]], "invalid": [[5, -6, 9]],
              "wrapped": [[-1, -2, -5, 0]]}


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("case", list(GATHER_IDS))
def test_gather_wraps_negative_ids_and_fills_out_of_range(training, case,
                                                          axis):
    rng = np.random.RandomState(12)
    ids = np.array(GATHER_IDS[case], np.int32)
    x = rng.randn(5, 5).astype(np.float32)
    shape = list(x.shape)
    shape[axis:axis + 1] = ids.shape
    dy = rng.randn(*shape).astype(np.float32)
    j_out, t_out, jg, tg = _run(lambda v: jag.gather(v, ids, axis=axis),
                                lambda v: tag.gather(v, ids, axis=axis),
                                (x,), dy)
    np.testing.assert_array_equal(
        t_out, np.asarray(jnp.take(jnp.asarray(x), ids, axis=axis)))
    bad = (ids < -5) | (ids >= 5)
    k = ids.ndim

    def by_id(a):            # the ids' axes first
        return np.moveaxis(a, list(range(axis, axis + k)), list(range(k)))
    assert np.isnan(by_id(t_out)[bad]).all()
    assert not np.isnan(by_id(t_out)[~bad]).any()
    _check(j_out, t_out, jg, tg)
    # the invalid rows' cotangents reach no row of x
    want = np.zeros_like(x)
    np.add.at(np.moveaxis(want, axis, 0), ids[~bad] % 5, by_id(dy)[~bad])
    np.testing.assert_allclose(tg["in0"], want, atol=1e-6, rtol=0)
    if case == "invalid":
        assert not tg["in0"].any()
