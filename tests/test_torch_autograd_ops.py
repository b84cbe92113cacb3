"""The port's autograd operator surface (singa_tpu_torch.autograd) against
the JAX package's (singa_tpu.autograd) on the CPU: one table, one case an
operator.  Each case runs the same call through both modules on the same
seeded numpy inputs, held as parameter leaves, in training mode; the
outputs are compared, then each module's ``backward(y, dy)`` under a
seeded cotangent ``dy``: the gradients with respect to every input, which
the reference derives with ``jax.vjp`` and the port with
``torch.autograd``.  Operators without
a gradient (the comparisons, ``argmax``, ``onehot``) compare their
outputs only.  Dropout has its own tests (its masks come from each
framework's own generator).

Tolerance: float32 at atol 1e-5 and rtol 1e-5; the float16 cast at one
float16 unit (rtol 2^-11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as ja
from singa_tpu import tensor as jt
from singa_tpu.device import get_default_device
from singa_tpu_torch import autograd as ta
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)


def _u(lo, hi, *shape):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def _n(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


X = _n(3, 4)
POS = _u(0.5, 2.0, 3, 4)
UNIT = _u(-0.9, 0.9, 3, 4)
COND = np.array([[True, False, True, True], [False] * 4, [True] * 4])
IDS = np.array([[2, 0], [-1, 2]], np.int32)   # a negative and a repeat

# case -> (the call on a module ``A`` and its Tensors, input makers)
CASES = {
    "add": (lambda A, a, b: A.add(a, b), [X, X]),
    "sub": (lambda A, a, b: A.sub(a, b), [X, X]),
    "mul": (lambda A, a, b: A.mul(a, b), [X, X]),
    "div": (lambda A, a, b: A.div(a, b), [X, POS]),
    "pow_": (lambda A, a, b: A.pow_(a, b), [POS, X]),
    "maximum": (lambda A, a, b: A.maximum(a, b), [X, X]),
    "minimum": (lambda A, a, b: A.minimum(a, b), [X, X]),
    "negative": (lambda A, x: A.negative(x), [X]),
    "abs_": (lambda A, x: A.abs_(x), [X]),
    "exp": (lambda A, x: A.exp(x), [X]),
    "log": (lambda A, x: A.log(x), [POS]),
    "sqrt": (lambda A, x: A.sqrt(x), [POS]),
    "square": (lambda A, x: A.square(x), [X]),
    "reciprocal": (lambda A, x: A.reciprocal(x), [POS]),
    "sign": (lambda A, x: A.sign(x), [X]),
    "clip": (lambda A, x: A.clip(x, -0.5, 0.7), [X]),
    "sin": (lambda A, x: A.sin(x), [X]),
    "cos": (lambda A, x: A.cos(x), [X]),
    "tan": (lambda A, x: A.tan(x), [UNIT]),
    "sinh": (lambda A, x: A.sinh(x), [X]),
    "cosh": (lambda A, x: A.cosh(x), [X]),
    "asin": (lambda A, x: A.asin(x), [UNIT]),
    "acos": (lambda A, x: A.acos(x), [UNIT]),
    "atan": (lambda A, x: A.atan(x), [X]),
    "asinh": (lambda A, x: A.asinh(x), [X]),
    "acosh": (lambda A, x: A.acosh(x), [_u(1.2, 3.0, 3, 4)]),
    "atanh": (lambda A, x: A.atanh(x), [UNIT]),
    "ceil": (lambda A, x: A.ceil(x), [X]),
    "floor": (lambda A, x: A.floor(x), [X]),
    "erf": (lambda A, x: A.erf(x), [X]),
    "relu": (lambda A, x: A.relu(x), [X]),
    "leakyrelu": (lambda A, x: A.leakyrelu(x, 0.2), [X]),
    "elu": (lambda A, x: A.elu(x, 0.7), [X]),
    "selu": (lambda A, x: A.selu(x), [X]),
    "sigmoid": (lambda A, x: A.sigmoid(x), [X]),
    "tanh": (lambda A, x: A.tanh(x), [X]),
    "gelu": (lambda A, x: A.gelu(x), [X]),
    "softplus": (lambda A, x: A.softplus(x), [_n(3, 4)]),
    "softsign": (lambda A, x: A.softsign(x), [X]),
    "hardsigmoid": (lambda A, x: A.hardsigmoid(x), [_n(3, 4)]),
    "softmax": (lambda A, x: A.softmax(x, axis=0), [X]),
    "logsoftmax": (lambda A, x: A.logsoftmax(x), [X]),
    "matmul": (lambda A, a, b: A.matmul(a, b), [_n(2, 3, 4), _n(4, 5)]),
    "gemm": (lambda A, a, b, c: A.gemm(a, b, c, 0.5, 2.0, 1, 1),
             [_n(4, 3), _n(5, 4), _n(3, 5)]),
    "add_bias": (lambda A, x, b: A.add_bias(x, b, axis=1),
                 [_n(2, 3, 4), _n(3)]),
    "linear": (lambda A, x, w, b: A.linear(x, w, b),
               [_n(3, 4), _n(4, 5), _n(5)]),
    "einsum": (lambda A, a, b: A.einsum("bij,jk->bik", a, b),
               [_n(2, 3, 4), _n(4, 5)]),
    "reshape": (lambda A, x: A.reshape(x, (2, -1)), [_n(2, 3, 4)]),
    "transpose": (lambda A, x: A.transpose(x, (2, 0, 1)), [_n(2, 3, 4)]),
    "transpose-reversed": (lambda A, x: A.transpose(x), [_n(2, 3, 4)]),
    "flatten": (lambda A, x: A.flatten(x), [_n(2, 3, 4, 5)]),
    "flatten-axis2": (lambda A, x: A.flatten(x, 2), [_n(2, 3, 4, 5)]),
    "cat": (lambda A, a, b: A.cat([a, b], axis=1), [_n(2, 3), _n(2, 4)]),
    "stack": (lambda A, a, b: A.stack([a, b], axis=1), [X, X]),
    "squeeze": (lambda A, x: A.squeeze(x), [_n(1, 3, 1, 4)]),
    "squeeze-axis": (lambda A, x: A.squeeze(x, 2), [_n(1, 3, 1, 4)]),
    "unsqueeze": (lambda A, x: A.unsqueeze(x, [0, 3]), [X]),
    "slice_": (lambda A, x: A.slice_(x, [1, 0], [3, 5], [0, 2]),
               [_n(4, 3, 6)]),
    "slice_-steps": (lambda A, x: A.slice_(x, [0, 5], [4, 0], [0, 1],
                                           [2, -2]), [_n(5, 6)]),
    "split": (lambda A, x: A.split(x, [1, 3, 2], axis=1), [_n(2, 6)]),
    "gather": (lambda A, x: A.gather(x, IDS, axis=0), [_n(3, 4)]),
    "gather-axis1": (lambda A, x: A.gather(x, IDS, axis=1), [_n(2, 3, 2)]),
    "tile": (lambda A, x: A.tile(x, (2, 1, 3)), [_n(2, 3)]),
    "expand": (lambda A, x: A.expand(x, (2, 3, 4)), [_n(3, 1)]),
    "pad-constant": (lambda A, x: A.pad(x, [1, 0, 2, 1], value=0.5),
                     [_n(2, 3)]),
    "pad-edge": (lambda A, x: A.pad(x, [1, 2, 0, 3], mode="edge"),
                 [_n(3, 4)]),
    "pad-reflect": (lambda A, x: A.pad(x, [2, 1, 1, 3], mode="reflect"),
                    [_n(3, 4)]),
    "pad-wrap": (lambda A, x: A.pad(x, [1, 2, 3, 0], mode="wrap"),
                 [_n(3, 4)]),
    "where": (lambda A, a, b: A.where(COND, a, b), [X, X]),
    "cast": (lambda A, x: A.cast(x, "float16"), [X]),
    "reduce_sum": (lambda A, x: A.reduce_sum(x, [0, 2], keepdims=True),
                   [_n(2, 3, 4)]),
    "reduce_sum-all": (lambda A, x: A.reduce_sum(x), [_n(2, 3, 4)]),
    "reduce_mean": (lambda A, x: A.reduce_mean(x, 1), [_n(2, 3, 4)]),
    "reduce_max": (lambda A, x: A.reduce_max(x, [1, 2]), [_n(2, 3, 4)]),
    "reduce_min": (lambda A, x: A.reduce_min(x, 0, keepdims=True),
                   [_n(2, 3, 4)]),
    "reduce_prod": (lambda A, x: A.reduce_prod(x, [0, 2]),
                    [_u(0.5, 1.5, 2, 3, 4)]),
    "mean-list": (lambda A, a, b, c: A.mean([a, b, c]), [X, X, X]),
    "mean-axis": (lambda A, x: A.mean(x, 1), [X]),
    "softmax_cross_entropy": (lambda A, x: A.softmax_cross_entropy(
        x, np.array([1, 3, 0], np.int32)), [X]),
    "cross_entropy-onehot": (lambda A, x: A.cross_entropy(
        x, np.eye(4, dtype=np.float32)[[2, 0, 1]]), [X]),
    "binary_cross_entropy": (lambda A, p: A.binary_cross_entropy(
        p, (np.arange(12) % 2).reshape(3, 4).astype(np.float32)),
        [_u(0.05, 0.95, 3, 4)]),
    "mse_loss": (lambda A, a, b: A.mse_loss(a, b), [X, X]),
    "mse_loss-array": (lambda A, a: A.mse_loss(a, np.ones((3, 4),
                                                          np.float32)), [X]),
    "nll_loss": (lambda A, x: A.nll_loss(x, np.array([1, 3, 0], np.int32)),
                 [X]),
    "checkpoint": (lambda A, a, b: A.checkpoint(
        (lambda u, v: jnp.sin(u) * v + u) if A is ja else
        (lambda u, v: torch.sin(u) * v + u), a, b), [X, X]),
}

NOGRAD = {
    "less": (lambda A, a, b: A.less(a, b), [X, X]),
    "greater": (lambda A, a, b: A.greater(a, b), [X, X]),
    "equal": (lambda A, a, b: A.equal(a, b),
              [lambda rng: np.array([1, 2, 3], np.float32),
               lambda rng: np.array([1, 0, 3], np.float32)]),
    "argmax": (lambda A, x: A.argmax(x, axis=0), [X]),
    "onehot": (lambda A, x: A.onehot(x, 4),
               [lambda rng: np.array([[0, 3], [5, -1]], np.int32)]),
}


def _jax_run(call, arrays, dys):
    """:func:`_run` of the reference as one jitted program (the ops and
    their ``jax.vjp`` backward traced together, as ``Model.compile``
    traces a step): one compile a case instead of one a primitive."""
    def fn(arrays, dys):
        return _run(ja, call, arrays, dys, host=False)
    # the default device (and its RNG key) exists before the trace, which
    # would otherwise create it and leak its key out of the jit
    get_default_device()
    outs, grads = jax.jit(fn)(list(arrays), list(dys))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run(A, call, arrays, dys=None, host=True):
    """The call on parameter leaves made from ``arrays``; with ``dys``
    also the gradients of the outputs under those cotangents (a
    multi-output op's outputs are joined with ``cat`` first).  Returns
    (outputs, grads)."""
    T = jt.Tensor if A is ja else Tensor
    dev = {} if A is ja else {"device": "cpu"}
    xs = [T(data=a, requires_grad=dys is not None,
            stores_grad=dys is not None, **dev) for a in arrays]
    A.training = dys is not None
    try:
        ys = call(A, *xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        if dys is None:
            return [np.asarray(y.data) if A is ja else y.numpy()
                    for y in ys], None
        y = ys[0] if len(ys) == 1 else A.cat(list(ys), axis=1)
        dy = (jnp if A is ja else np).concatenate(dys, axis=1) \
            if len(ys) > 1 else dys[0]
        grads = dict(A.backward(y, dy))
    finally:
        A.training = False
    if not host:
        return ([jnp.asarray(y.data, jnp.float32) for y in ys],
                [grads[x].data for x in xs])
    outs = [np.asarray(jnp.asarray(y.data, jnp.float32)) if A is ja
            else y.data.detach().float().numpy() for y in ys]
    return outs, [np.asarray(grads[x].data) if A is ja else
                  grads[x].numpy() for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_forward_and_vjp(case):
    call, makers = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    arrays = [m(rng) for m in makers]
    shapes, _ = _run(ta, call, arrays)
    dys = [np.asarray(rng.randn(*np.shape(w)), np.float32) for w in shapes]
    want, jgrads = _jax_run(call, arrays, dys)
    got, tgrads = _run(ta, call, arrays, dys)
    tol = dict(rtol=2.0 ** -11, atol=1e-5) if case == "cast" else \
        dict(rtol=1e-5, atol=1e-5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(g, w, err_msg=f"input {i}", **tol)


@pytest.mark.parametrize("case", sorted(NOGRAD))
def test_nograd_op_matches_jax(case):
    call, makers = NOGRAD[case]
    arrays = [m(np.random.RandomState(1)) for m in makers]
    want, _ = _run(ja, call, arrays)
    got, _ = _run(ta, call, arrays)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_every_reference_name_is_ported():
    """The reference's operator surface, by name (its graph engine's
    classes aside: torch.autograd is the port's engine)."""
    engine = {"Operation", "Dummy", "JaxOp", "infer_dependency", "recording",
              "jax", "jnp", "np", "deque", "partial", "annotations",
              "Tensor"}
    want = {n for n, v in vars(ja).items()
            if not n.startswith("_") and n not in engine
            and (callable(v) or n == "training")}
    assert want <= set(ta.__all__)
    assert all(hasattr(ta, n) for n in ta.__all__)


def _dropout(x, p, gen_state=None):
    t = Tensor(data=x, device="cpu", requires_grad=True, stores_grad=True)
    if gen_state is not None:
        t.device.generator.set_state(gen_state)
    ta.training = True
    try:
        y = ta.dropout(t, p)
        g = ta.gradients(ta.reduce_sum(y))[t]
    finally:
        ta.training = False
    return y.numpy(), g.numpy()


def test_dropout_rate_scale_and_gradient():
    """Each value is kept with probability 1 - p and scaled to v / keep;
    the gradient is the mask over keep."""
    x = np.random.RandomState(2).uniform(1, 2, (200, 100)).astype(np.float32)
    y, g = _dropout(x, 0.3)
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.01              # 20,000 draws
    np.testing.assert_allclose(y[kept], x[kept] / np.float32(0.7), rtol=1e-6)
    np.testing.assert_allclose(g, kept / np.float32(0.7), rtol=1e-6)
    assert y.dtype == np.float32


def test_dropout_is_the_identity_outside_training_or_at_p0():
    t = Tensor(data=np.ones((4, 4), np.float32), device="cpu")
    assert ta.dropout(t, 0.5) is t
    ta.training = True
    try:
        assert ta.dropout(t, 0.0) is t
    finally:
        ta.training = False


def test_dropout_reruns_with_the_same_generator_state():
    """A rerun from the same generator state draws the same mask, which
    is what a captured step's replay relies on (the generator is
    registered with the graph); the next draw is a fresh mask."""
    x = np.ones((64, 64), np.float32)
    gen = Tensor(data=x, device="cpu").device.generator
    state = gen.get_state()
    a, _ = _dropout(x, 0.5, state)
    b, _ = _dropout(x, 0.5, state)
    c, _ = _dropout(x, 0.5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
