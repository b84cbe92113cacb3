"""The port's RNN ops and layers (singa_tpu_torch.ops.rnn, layer.RNN /
LSTM / GRU, on the CPU) against the JAX package's ``_rnn_fwd`` and
layers on the same numpy inputs: every mode (LSTM through the fused
cell and through the plain cell, GRU, tanh, relu), one layer, two
layers, bidirectional and ``batch_first``.  Outputs ``(y, hy, cy)`` at
rtol/atol 1e-5 (float32, summation order only); the gradients of x, hx,
cx and every weight, from one ``jax.vjp`` against ``torch.autograd.grad``
with the same cotangents, at rtol 2e-4, atol 2e-5 (the JAX package's
fused-cell test tolerance).  The Pallas cell runs in interpret mode.

The layers' state names equal the reference's (``rnn._w0`` ...), and
weights cross by ``set_states`` from the JAX ``get_states()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import layer as jlayer
from singa_tpu import tensor as jtensor
from singa_tpu.model import Model as JModel
from singa_tpu.ops import rnn as jrnn
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch.model import Model as TModel
from singa_tpu_torch.ops import lstm_cell as lc
from singa_tpu_torch.ops import rnn as trnn
from singa_tpu_torch.tensor import Tensor as TTensor

torch.set_num_threads(1)

T, B, D, H = 4, 3, 5, 6
MODES = {"lstm_fused": ("lstm", True), "lstm_scan": ("lstm", False),
         "gru": ("gru", False), "tanh": ("tanh", False),
         "relu": ("relu", False)}
# (num_layers, bidirectional, batch_first)
SHAPES = {"1layer": (1, False, False), "2layer_bidir": (2, True, False),
          "batch_first": (1, False, True)}


def _case(mode, fused, layers, bidir, batch_first, seed):
    kw = dict(num_layers=layers, mode=mode, bidirectional=bidir,
              batch_first=batch_first, use_fused_cell=fused)
    jh, th = jrnn.RNNHandle(D, H, **kw), trnn.RNNHandle(D, H, **kw)
    rng = np.random.RandomState(seed)
    L = layers * jh.num_directions
    x = rng.randn(*((B, T, D) if batch_first else (T, B, D)))
    arrays = [x, rng.randn(L, B, H), rng.randn(L, B, H)]
    for shapes in jh.weight_shapes():
        arrays += [rng.uniform(-0.4, 0.4, s) for s in shapes]
    arrays = [a.astype(np.float32) for a in arrays]
    y_shape = x.shape[:2] + (H * jh.num_directions,)
    cots = [rng.randn(*s).astype(np.float32)
            for s in (y_shape, (L, B, H), (L, B, H))]
    return jh, th, arrays, cots


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
def test_rnn_fwd_and_gradients_match_jax(mode, shape):
    m, fused = MODES[mode]
    layers, bidir, bf = SHAPES[shape]
    seed = 10 * list(MODES).index(mode) + list(SHAPES).index(shape)
    jh, th, arrays, cots = _case(m, fused, layers, bidir, bf, seed)
    assert th.use_fused_cell == jh.use_fused_cell == fused
    jouts, vjp = jax.vjp(lambda *a: jrnn._rnn_fwd(*a, handle=jh),
                         *[jnp.asarray(a) for a in arrays])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = lc.launches
    touts = trnn._rnn_fwd(*targs, handle=th)
    assert lc.launches == before              # the CPU launches nothing
    for name, t, j in zip(("y", "hy", "cy"), touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    tgrads = torch.autograd.grad(touts, targs,
                                 [torch.from_numpy(c) for c in cots],
                                 allow_unused=True)
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        jg = np.asarray(jg)
        got = np.zeros_like(jg) if g is None else g.numpy()
        np.testing.assert_allclose(got, jg, rtol=2e-4, atol=2e-5,
                                   err_msg=f"input {i}")


class _JNet(JModel):
    def __init__(self, cls, **kw):
        super().__init__()
        self.rnn = cls(H, **kw)

    def forward(self, x):
        return self.rnn(x)


class _TNet(TModel):
    def __init__(self, cls, **kw):
        super().__init__()
        self.rnn = cls(H, **kw)

    def forward(self, x):
        return self.rnn(x)


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "RNN"])
def test_layer_states_cross_by_name(kind):
    """Two-layer bidirectional layers: the same state names as the JAX
    layer's, weights carried over by ``set_states``, the same outputs
    (zero initial states by default)."""
    kw = dict(num_layers=2, bidirectional=True)
    x = np.random.RandomState(3).randn(T, B, D).astype(np.float32)
    np.random.seed(0)
    jm = _JNet(getattr(jlayer, kind), **kw)
    jm.compile([jtensor.from_numpy(x)], is_train=False)
    tm = _TNet(getattr(tlayer, kind), **kw)
    tm.compile([TTensor(data=x, device="cpu")], is_train=False)
    js = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
    assert set(tm.get_states()) == set(js)
    assert {f"rnn._w{i}" for i in range(12)} == set(js)
    tm.set_states(js)
    jouts = jm.forward(jtensor.from_numpy(x))
    touts = tm.forward(TTensor(data=x, device="cpu"))
    assert len(touts) == len(jouts) == (3 if kind == "LSTM" else 2)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.data),
                                   rtol=1e-5, atol=1e-5)


def test_layer_init_is_uniform_in_the_hidden_bound():
    m = tlayer.LSTM(16)
    x = TTensor(data=np.zeros((2, 3, 4), np.float32), device="cpu")
    y, hy, cy = m(x)
    assert [tuple(w.shape) for w in m.weights] == [(4, 64), (16, 64), (64,)]
    bound = 1.0 / np.sqrt(16)
    for w in m.weights:
        v = w.numpy()
        assert np.abs(v).max() <= bound and np.abs(v).max() > 0.5 * bound
    assert y.shape == (2, 3, 16) and hy.shape == cy.shape == (1, 3, 16)


def test_rnn_op_outputs_share_one_creator():
    """The multi-output op: y, hy and cy of a training-mode LSTM come
    from one recorded op; backward from any of them reaches the
    weights."""
    m = tlayer.LSTM(4)
    x = TTensor(data=np.random.RandomState(4).randn(3, 2, 5)
                .astype(np.float32), device="cpu")
    prev = tautograd.training
    tautograd.training = True
    try:
        y, hy, cy = m(x)
        assert y.creator is hy.creator is cy.creator is not None
        assert y.creator.name == "RNN-lstm"
        loss = tautograd.reduce_mean(tautograd.mul(hy, cy))
        names = {p.name for p, _ in tautograd.backward(loss)}
    finally:
        tautograd.training = prev
    assert len(names) == 3


def test_onehot_matches_jax_and_records_no_gradient():
    ids = np.array([[0, 3, 5], [2, -1, 6]], np.int32)
    got = tautograd.onehot(TTensor(data=ids, device="cpu"), 6)
    want = jax.nn.one_hot(jnp.asarray(ids), 6)
    assert got.dtype == torch.float32 and got.creator is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
