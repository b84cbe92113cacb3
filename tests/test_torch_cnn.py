"""The port's CNN zoo (singa_tpu_torch.examples.cnn.model) against the JAX
package's (examples/cnn/model) on the CPU, from the same states and
seeded batches.

* ``get_states()`` names: equal to the JAX model's, for every model.
* One SGD step (``train_one_batch`` through ``compile(use_graph=True)``,
  SGD lr 0.005, momentum 0.9, weight decay 1e-5 as in ``train_cnn.py``;
  JAX in graph mode) at B 2: the loss and the training-mode logits, then
  every parameter, BatchNorm buffer and momentum after the step.
  Tolerances: float32 at atol 1e-5, 1e-4 for conv stacks deeper than 10
  layers (vgg16, resnet18, xception, resnet50's forward).
* Input sizes.  A batch-norm layer whose map is 1x1 normalizes two values
  a channel at B 2, so ``x_hat`` is +-1 whatever the values and its
  gradients reach hundreds: there the step amplifies a rounding
  difference without bound (at 32x32, resnet18's parameters after one
  step differ from JAX's by up to 0.08 while a 1e-6 relative change of
  the input moves the port's own by 51 in norm, and JAX's eager and
  compiled losses differ by 4e-4).  So the BN models step at the smallest
  size whose last map is 2x2 or more: resnet18 and mobilenet at 64,
  xception at 48.  AlexNet's smallest legal input is 63 (pool5 needs a
  3x3 map); cnn runs at MNIST's 28, vgg16 at 32.
* Depth.  XLA's CPU compile of the reference's step grows with the
  layer count, so two repeated stacks are cut on both sides alike, after
  construction: xception's middle flow keeps 2 of its 8 identical
  blocks, and MobileNetV2's inverted residuals keep the first 7 of 17
  (every expansion kind, stride and residual case of the table; the
  last 1x1 conv takes the narrower input, as its width is lazy).  The
  state-name test runs the full models.
* MobileNetV2 stays chaotic at random init there: a 1e-6 relative change
  of the input moves the port's parameters after one step by 0.024 in
  norm (the step moves them by 1.22), and the port's distance from JAX
  is the same (0.024).  Its parameters are held to JAX's within twice
  the port's own distance between that input and the perturbed one,
  measured in the test; its loss and buffers at 1e-4.
* Dropout draws from each framework's own generator, so AlexNet's and
  VGG's dropout layers are set to p 0 on both sides for the step.
* resnet50: the eval-mode forward only, at 32x32.
* NHWC against NCHW, and zip checkpoints both ways with the JAX package.
"""

import functools
import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples", "cnn"))

from singa_tpu import opt as jopt  # noqa: E402
from singa_tpu import tensor as jtensor  # noqa: E402
from singa_tpu_torch import opt as topt  # noqa: E402
from singa_tpu_torch.examples.cnn import train_cnn  # noqa: E402
from singa_tpu_torch.tensor import Tensor  # noqa: E402

torch.set_num_threads(1)

LR = 0.005
# model -> (input size of the step, channels, atol)
STEP = {"cnn": (28, 1, 1e-5), "alexnet": (63, 3, 1e-5),
        "vgg16": (32, 3, 1e-4), "resnet18": (64, 3, 1e-4),
        "xceptionnet": (48, 3, 1e-4), "mobilenet": (64, 3, None)}
ZOO = ("cnn", "resnet18", "resnet50", "alexnet", "vgg16", "mobilenet",
       "xceptionnet")
NO_DROPOUT = {"alexnet": ("drop6", "drop7"), "vgg16": ("drop1", "drop2")}


def _jax_model(name, **kw):
    mod = ("resnet" if name.startswith("resnet") else
           "vgg" if name.startswith("vgg") else name)
    m = importlib.import_module(f"model.{mod}")
    if mod in ("resnet", "vgg"):
        return m.create_model(name, **kw)
    return m.create_model(**kw)


def _batch(c, hw, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, c, hw, hw).astype(np.float32),
            rng.randint(0, classes, 2).astype(np.int32))


def _np_states(m):
    return {k: np.asarray(v.data) for k, v in m.get_states().items()}


def _cut(name, m):
    """The test's depth cuts (module docstring) and no dropout."""
    for attr in NO_DROPOUT.get(name, ()):
        getattr(m, attr).p = 0.0
    if name == "xceptionnet":
        m.mid.layers = m.mid.layers[:2]
    elif name == "mobilenet":
        m.blocks.layers = m.blocks.layers[:7]


def _port(name, states, x, y, c, layout=None):
    kw = {} if layout is None else dict(layout=layout)
    tm = train_cnn.create_model(name, num_classes=10, num_channels=c, **kw)
    _cut(name, tm)
    tm.set_optimizer(topt.SGD(lr=LR, momentum=0.9, weight_decay=1e-5))
    tx = Tensor(data=x, device="cpu")
    tm.compile([tx], is_train=True, use_graph=True)
    tm.set_states(states)
    out, loss = tm.train_one_batch(tx, Tensor(data=y, device="cpu"))
    return tm, out.numpy(), loss.item()


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """The JAX model's states before and after one step, its logits and
    loss, and the model (with its optimizer)."""
    hw, c, _ = STEP[name]
    x, y = _batch(c, hw)
    np.random.seed(0)
    jm = _jax_model(name, num_classes=10, num_channels=c)
    _cut(name, jm)
    jm.set_optimizer(jopt.SGD(lr=LR, momentum=0.9, weight_decay=1e-5))
    jm.compile([jtensor.from_numpy(x)], is_train=True, use_graph=True)
    before = _np_states(jm)
    out, loss = jm.train_one_batch(jtensor.from_numpy(x),
                                   jtensor.from_numpy(y))
    return before, _np_states(jm), np.asarray(out.data), float(loss.data), jm


@pytest.mark.parametrize("name", ZOO)
def test_state_names_equal_jax(name):
    """Every state (parameters and BatchNorm buffers) by the JAX model's
    dotted name, from the placeholder pass of ``compile``."""
    c = 1 if name == "cnn" else 3
    x, _ = _batch(c, 63 if name == "alexnet" else 32)
    jm = _jax_model(name, num_classes=10, num_channels=c)
    jm.compile([jtensor.from_numpy(x)], is_train=False, use_graph=False)
    tm = train_cnn.create_model(name, num_classes=10, num_channels=c)
    tm.compile([Tensor(data=x, device="cpu")], is_train=False)
    want = {k: tuple(v.shape) for k, v in jm.get_states().items()}
    got = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert got == want
    assert set(tm.get_params()) == set(jm.get_params())


@pytest.mark.parametrize("name", sorted(STEP))
def test_one_sgd_step_matches_jax(name):
    hw, c, atol = STEP[name]
    before, after, jout, jloss, _ = _jax_step(name)
    x, y = _batch(c, hw)
    tm, out, loss = _port(name, before, x, y, c)
    got = {k: v.numpy() for k, v in tm.get_states().items()}
    params = [k for k in before if k in tm.get_params()]
    bufs = [k for k in before if k not in params]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    if atol is None:
        # mobilenet: calibrated by the port's own sensitivity (docstring)
        np.testing.assert_allclose(out, jout, atol=1e-4)
        _, x2 = None, (x * (1 + 1e-6 * np.random.RandomState(1).randn(
            *x.shape))).astype(np.float32)
        tm2, _, _ = _port(name, before, x2, y, c)
        own = {k: v.numpy() for k, v in tm2.get_states().items()}

        def dist(a, b):
            return np.sqrt(sum(((a[k] - b[k]).astype(np.float64) ** 2).sum()
                               for k in params))
        assert dist(got, after) <= 2 * dist(got, own)
        for k in bufs:
            np.testing.assert_allclose(got[k], after[k], atol=1e-4,
                                       rtol=1e-5, err_msg=k)
        return
    np.testing.assert_allclose(out, jout, atol=atol)
    for k in before:
        np.testing.assert_allclose(got[k], after[k], atol=atol, rtol=1e-5,
                                   err_msg=k)
    moved = [k for k in bufs if not np.array_equal(after[k], before[k])]
    assert len(moved) == len(bufs)          # every buffer was updated


def test_resnet50_forward_matches_jax():
    """The bottleneck stack's eval-mode forward at 32x32 (BatchNorm from
    its running buffers, set to seeded values on both sides)."""
    x, _ = _batch(3, 32)
    np.random.seed(0)
    jm = _jax_model("resnet50", num_classes=10)
    jm.compile([jtensor.from_numpy(x)], is_train=False, use_graph=False)
    rng = np.random.RandomState(3)
    states = _np_states(jm)
    for k in states:
        if k.endswith("running_mean"):
            states[k] = 0.1 * rng.randn(*states[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            states[k] = (0.5 + rng.rand(*states[k].shape)).astype(np.float32)
    jm.set_states(states)
    jm.eval()
    want = np.asarray(jm.predict(jtensor.from_numpy(x)).data)
    tm = train_cnn.create_model("resnet50", num_classes=10, num_channels=3)
    tm.compile([Tensor(data=x, device="cpu")], is_train=False)
    tm.set_states(states)
    tm.eval()
    got = tm.forward(Tensor(data=x, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["resnet18", "vgg16"])
def test_nhwc_matches_nchw(name):
    """``layout="NHWC"`` runs channels-last on the same NCHW inputs and
    OIHW weights: one step gives the NCHW model's logits, loss and
    states."""
    hw, c, _ = STEP[name]
    before = _jax_step(name)[0]
    x, y = _batch(c, hw)
    a, out_a, loss_a = _port(name, before, x, y, c)
    b, out_b, loss_b = _port(name, before, x, y, c, layout="NHWC")
    np.testing.assert_allclose(out_b, out_a, atol=1e-5)
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-6)
    sa, sb = a.get_states(), b.get_states()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_zip_checkpoints_cross_both_ways(tmp_path):
    """The port's zip checkpoint loads into the JAX model (params, BN
    buffers and SGD momentum), and the JAX one into the port, bit for
    bit, with the aux states."""
    hw, c, _ = STEP["resnet18"]
    before, after, _, _, jm = _jax_step("resnet18")
    x, y = _batch(c, hw)
    tm, _, _ = _port("resnet18", before, x, y, c)
    port_ckpt, jax_ckpt = str(tmp_path / "port.zip"), str(tmp_path / "j.zip")
    tm.save_states(port_ckpt, aux_states={"epoch": np.asarray(3)})
    jm.save_states(jax_ckpt, aux_states={"epoch": np.asarray(5)})
    # copies: a CPU tensor's numpy() shares its storage, which loading
    # the JAX checkpoint below overwrites
    want_t = {k: v.numpy().copy() for k, v in tm.get_states().items()}
    want_t.update({f"opt.{k}": np.array(v)
                   for k, v in tm.optimizer.get_states().items()})
    want_j = _np_states(jm)
    want_j.update({f"opt.{k}": np.asarray(v)
                   for k, v in jm.optimizer.get_states().items()})
    assert set(want_t) == set(want_j)
    # JAX's checkpoint into the port
    aux = tm.load_states(jax_ckpt)
    assert int(aux["epoch"]) == 5
    got = {k: v.numpy() for k, v in tm.get_states().items()}
    got.update({f"opt.{k}": v for k, v in tm.optimizer.get_states().items()})
    for k in want_j:
        np.testing.assert_array_equal(got[k], want_j[k], err_msg=k)
    # the port's checkpoint into JAX
    aux = jm.load_states(port_ckpt)
    assert int(aux["epoch"]) == 3
    got = _np_states(jm)
    got.update({f"opt.{k}": np.asarray(v)
                for k, v in jm.optimizer.get_states().items()})
    for k in want_t:
        np.testing.assert_array_equal(got[k], want_t[k], err_msg=k)


def test_train_cnn_trains_resumes_and_raises(tmp_path):
    """``train_cnn.run`` on the CPU: the loss falls over two epochs; with
    ``--ckpt`` and ``--resume`` a third epoch continues from the saved
    one; ``--ckpt-every`` without ``--ckpt DIR`` raises, as the
    reference's (``--zero1`` runs: ``tests/test_torch_dist_cnn.py``; the
    resilient mode: ``tests/test_torch_checkpoint_resume.py``)."""
    ckpt = str(tmp_path / "cnn.zip")
    args = ["cnn", "--device", "cpu", "-n", "256", "-b", "32", "--ckpt",
            ckpt]
    first = train_cnn.main(args + ["-m", "2"])
    assert first["epoch_losses"][1] < first["epoch_losses"][0]
    assert first["step_losses"][-1] < first["step_losses"][0]
    resumed = train_cnn.main(args + ["-m", "3", "--resume"])
    assert len(resumed["epoch_losses"]) == 1
    assert resumed["loss"] < first["epoch_losses"][0]
    with pytest.raises(SystemExit, match="--ckpt DIR"):
        train_cnn.main(["cnn", "--device", "cpu", "--ckpt-every", "5"])


@pytest.mark.parametrize("name", ["alexnet", "cnn", "resnet18", "vgg16"])
def test_emission_order_equals_jax(name):
    """``autograd.backward(ordered=True)`` (what ``DistOpt`` buckets and
    selects by) yields the parameters in the order the JAX package's
    backward does, from one training forward of each model (the JAX
    side runs eagerly, op by op, so resnet18 runs at 32x32)."""
    from singa_tpu import autograd as jautograd
    from singa_tpu_torch import autograd as tautograd

    class JOrder(jopt.SGD):
        def __call__(self, loss):
            self.order = [id(p) for p, _ in jautograd.backward(loss)]

    class TOrder(topt.SGD):
        def __call__(self, loss):
            self.order = [id(p) for p, _ in
                          tautograd.backward(loss, ordered=True)]

    hw, c, _ = STEP[name]
    x, y = _batch(c, min(hw, 32) if name == "resnet18" else hw)
    jm = _jax_model(name, num_classes=10, num_channels=c)
    _cut(name, jm)
    jm.set_optimizer(JOrder(lr=LR))
    jm.compile([jtensor.from_numpy(x)], is_train=True, use_graph=False)
    jm.train_one_batch(jtensor.from_numpy(x), jtensor.from_numpy(y))
    tm = train_cnn.create_model(name, num_classes=10, num_channels=c)
    _cut(name, tm)
    tm.set_optimizer(TOrder(lr=LR))
    tx = Tensor(data=x, device="cpu")
    tm.compile([tx], is_train=True, use_graph=False)
    tm.train_one_batch(tx, Tensor(data=y, device="cpu"))
    jnames = {id(t): k for k, t in jm.get_params().items()}
    tnames = {id(t): k for k, t in tm.get_params().items()}
    want = [jnames[i] for i in jm.optimizer.order]
    assert [tnames[i] for i in tm.optimizer.order] == want
    assert len(want) == len(jnames)
