"""The port's MLP example (singa_tpu_torch.examples.mlp) against the JAX
package's (examples/mlp/train.py) on the CPU: the same MLP (784-128-128-10)
from the same states takes 5 SGD steps (momentum 0.9) on the same
synthetic MNIST batches in graph mode, each loss within rtol 1e-5 and
every parameter and momentum within atol 1e-5 of JAX's; the data
generator is the reference's, bit for bit; and the example's ``run``
trains on the CPU with a falling loss."""

import importlib.util
import os

import numpy as np
import torch

from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu_torch import opt as topt
from singa_tpu_torch.examples import mlp
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "jax_mlp_train", os.path.join(os.path.dirname(__file__), "..",
                                  "examples", "mlp", "train.py"))
jmlp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jmlp)

B, STEPS = 64, 5


def test_synthetic_mnist_is_the_reference_s():
    for a, b in zip(mlp.synthetic_mnist(n=300, seed=3),
                    jmlp.synthetic_mnist(n=300, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_five_sgd_steps_match_jax():
    x, y = mlp.synthetic_mnist(n=B * STEPS, seed=1)
    np.random.seed(0)
    jm = jmlp.MLP()
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    jm.compile([jt.Tensor(data=x[:B], requires_grad=False)], is_train=True,
               use_graph=True)
    tm = mlp.MLP()
    tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    tm.compile([Tensor(data=x[:B], device="cpu")], is_train=True,
               use_graph=True)
    assert set(tm.get_states()) == set(jm.get_states())
    tm.set_states({k: np.asarray(v.data) for k, v in jm.get_states().items()})
    for s in range(STEPS):
        xb, yb = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        _, jl = jm.train_one_batch(jt.from_numpy(xb), jt.from_numpy(yb))
        _, tl = tm.train_one_batch(Tensor(data=xb, device="cpu"),
                                   Tensor(data=yb, device="cpu"))
        np.testing.assert_allclose(tl.item(), float(jl.data), rtol=1e-5)
    for k, v in jm.get_states().items():
        np.testing.assert_allclose(tm.get_states()[k].numpy(),
                                   np.asarray(v.data), atol=1e-5, err_msg=k)
    jo, to = jm.optimizer.get_states(), tm.optimizer.get_states()
    assert set(to) == set(jo)
    for k in jo:
        np.testing.assert_allclose(to[k], np.asarray(jo[k]), atol=1e-5,
                                   err_msg=k)


def test_example_trains_on_the_cpu():
    losses = mlp.main(["--device", "cpu", "--epochs", "2"])
    assert len(losses) == 2 and losses[1] < losses[0]
    assert all(np.isfinite(losses))
