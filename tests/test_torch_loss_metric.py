"""The port's v2 loss and metric API (singa_tpu_torch.loss, .metric)
against the JAX package's (singa_tpu.loss, .metric) on the CPU, on the
same seeded numpy inputs: per-sample forward, the cached analytic
backward, ``evaluate``, integer and one-hot targets, the distillation
loss at two temperatures, and top-1 / top-k accuracy.  Tolerance:
float32 at atol 1e-6, rtol 1e-5."""

import numpy as np
import pytest
import torch

from singa_tpu import loss as jloss
from singa_tpu import metric as jmetric
from singa_tpu import tensor as jt
from singa_tpu_torch import loss as tloss
from singa_tpu_torch import metric as tmetric
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-5)


def _pair(rng, onehot):
    x = rng.randn(6, 5).astype(np.float32) * 2
    y = rng.randint(0, 5, 6).astype(np.int32)
    if onehot:
        y = np.eye(5, dtype=np.float32)[y]
    return x, y


def _losses(kind):
    if kind == "ce":
        return jloss.SoftmaxCrossEntropy(), tloss.SoftmaxCrossEntropy()
    if kind.startswith("kl"):
        t = float(kind[2:])
        return jloss.DistillationKL(t), tloss.DistillationKL(t)
    return jloss.SquaredError(), tloss.MeanSquareError()


@pytest.mark.parametrize("kind,onehot", [
    ("ce", False), ("ce", True), ("kl1", True), ("kl2.5", True),
    ("se", True)])
def test_loss_forward_backward_evaluate_match_jax(kind, onehot):
    rng = np.random.RandomState(len(kind) + onehot)
    x, y = _pair(rng, onehot)
    if kind.startswith("kl"):
        y = rng.randn(6, 5).astype(np.float32)      # the teacher's logits
    j, t = _losses(kind)
    want = j.forward(True, jt.from_numpy(x), jt.from_numpy(y))
    got = t.forward(True, Tensor(data=x, device="cpu"), y)
    assert isinstance(got, Tensor) and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **TOL)
    np.testing.assert_allclose(t.backward().numpy(),
                               np.asarray(j.backward().data), **TOL)
    np.testing.assert_allclose(t.evaluate(False, x, y),
                               j.evaluate(False, jt.from_numpy(x),
                                          jt.from_numpy(y)), **TOL)


def test_backward_before_forward_raises_and_soften_logits():
    for t in (tloss.SoftmaxCrossEntropy(), tloss.DistillationKL(),
              tloss.SquaredError()):
        with pytest.raises(RuntimeError, match="backward"):
            t.backward()
    with pytest.raises(ValueError, match="temperature"):
        tloss.DistillationKL(0)
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    got = tloss.soften_logits(Tensor(data=x, device="cpu"), 2.0)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jloss.soften_logits(x, 2.0)), **TOL)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("top_k,onehot", [(1, False), (1, True), (3, False),
                                          (9, True)])
def test_accuracy_matches_jax(top_k, onehot):
    x, y = _pair(np.random.RandomState(top_k), onehot)
    j, t = jmetric.Accuracy(top_k), tmetric.Accuracy(top_k)
    want = j.forward(jt.from_numpy(x), jt.from_numpy(y))
    got = t.forward(Tensor(data=x, device="cpu"), y)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    assert t.evaluate(x, y) == pytest.approx(
        j.evaluate(jt.from_numpy(x), jt.from_numpy(y)))
