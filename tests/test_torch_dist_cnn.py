"""The port's distributed CNN paths against the JAX package's on the
CPU: the zoo's ``dist_option`` and the CNN examples' multi-process
scripts.  The port runs gloo ranks (``parallel.launch``; rank bodies in
``tests/_torch_dist_cases.py``), JAX a mesh of two of the conftest's
virtual CPU devices with ``use_graph=True``.

* ``cnn`` (28x28) and ``resnet18`` (64x64) through ``dist_option``
  ``plain`` and ``sharded`` at world 2 (one group for the four), from
  JAX's initial states, on seeded global batches of 8 (4 a rank), SGD lr
  0.005, momentum 0.9, weight decay 1e-5: rank 0's losses and every
  state (parameters, momenta or the all-gathered ZeRO-1 state, and the
  BatchNorm buffers, which are each rank's own and rank 0's here, as the
  reference's host read of device 0's) against JAX's.  A sum of two
  addends is exact, so the gaps are the local compute's: ``cnn`` takes 3
  steps at atol 1e-5; ``resnet18`` one step at 1e-4 (the bounds of
  ``tests/test_torch_cnn.py``'s one step).  ResNet-18 runs at 64x64,
  where its last map is 2x2, and one step: at 4 images a rank its
  momenta after 3 steps sit 0.013 from JAX's while a 1e-6 relative
  change of the input moves the port's own by 0.018 (max abs), so a
  longer run measures the net's amplification of float noise, not the
  port (``tests/test_torch_cnn.py``'s docstring).
* ``train_multiprocess.run`` at ``-w 2`` from JAX's initial states and
  the JAX script's ``run`` (its ``np.random.permutation`` fed the port's
  permutations: the JAX models draw their weights from numpy's global
  generator first): the epoch losses, which the JAX script prints at 4
  decimals (held within half a printed unit plus 1e-4), and the epoch
  line.
* ``train_cnn --zero1 2`` (ZeRO-1 over two gloo ranks) resuming from a
  zip checkpoint of JAX's initial states, and the JAX script with
  ``--zero1 2`` (two virtual devices; its single-process path takes the
  plain DistOpt update, the same values up to float order): every
  step's loss (``--log-steps``) within rtol 1e-5.
"""

import logging
import os
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples", "cnn"))

from singa_tpu import opt as jopt  # noqa: E402
from singa_tpu import tensor as jtensor  # noqa: E402
from singa_tpu.parallel import Communicator as JCommunicator  # noqa: E402
from singa_tpu_torch.examples.cnn import train_cnn  # noqa: E402
from singa_tpu_torch.examples.cnn import train_multiprocess  # noqa: E402
from singa_tpu_torch.parallel import launch  # noqa: E402

import _torch_dist_cases as cases  # noqa: E402

torch.set_num_threads(1)

LR, B = 0.005, 8
TIMEOUT = 300
# model -> (input size, channels, atol, steps)
ZOO = {"cnn": (28, 1, 1e-5, 3), "resnet18": (64, 3, 1e-4, 1)}
SPECS = {f"{name}_{opt}": (name, ZOO[name][1], opt)
         for name in ZOO for opt in ("plain", "sharded")}


def _jax_model(name, **kw):
    import importlib
    mod = "resnet" if name.startswith("resnet") else name
    m = importlib.import_module(f"model.{mod}")
    return (m.create_model(name, **kw) if mod == "resnet"
            else m.create_model(**kw))


def _batches(name):
    hw, c, _, steps = ZOO[name]
    rng = np.random.RandomState(1)
    return [(rng.randn(B, c, hw, hw).astype(np.float32),
             rng.randint(0, 10, B).astype(np.int32)) for _ in range(steps)]


def _jax_zoo(name, option, init):
    c = ZOO[name][1]
    batches = _batches(name)
    comm = JCommunicator.from_devices(jax.devices()[:2])
    np.random.seed(0)
    jm = _jax_model(name, num_classes=10, num_channels=c)
    jm.set_optimizer(jopt.DistOpt(
        jopt.SGD(lr=LR, momentum=0.9, weight_decay=1e-5),
        communicator=comm))
    jm.compile([jtensor.from_numpy(batches[0][0])], is_train=True,
               use_graph=True, communicator=comm)
    if init is not None:
        jm.set_states(init)
    losses = [float(jm.train_one_batch(jtensor.from_numpy(x),
                                       jtensor.from_numpy(y),
                                       option)[1].data)
              for x, y in batches]
    st = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
    st.update({f"opt.{k}": np.asarray(v)
               for k, v in jm.optimizer.get_states().items()})
    return jm, losses, st


@pytest.fixture(scope="module")
def zoo():
    inits = {}
    for name in ZOO:
        np.random.seed(0)
        jm = _jax_model(name, num_classes=10, num_channels=ZOO[name][1])
        jm.compile([jtensor.from_numpy(_batches(name)[0][0])],
                   is_train=True)
        inits[name] = {k: np.asarray(v.data)
                       for k, v in jm.get_states().items()}
    port = launch(cases.zoo_cases, 2,
                  args=(SPECS, {n: _batches(n) for n in ZOO}, inits, LR),
                  device="cpu", timeout=TIMEOUT)
    return inits, port


@pytest.mark.parametrize("key", sorted(SPECS))
def test_zoo_dist_option_matches_jax(zoo, key):
    inits, port = zoo
    name, _, option = SPECS[key]
    atol = ZOO[name][2]
    _, jl, js = _jax_zoo(name, option, inits[name])
    got = port[key]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5, atol=atol)
    assert set(got["states"]) == set(js)
    for k in js:
        np.testing.assert_allclose(got["states"][k], js[k], rtol=1e-5,
                                   atol=atol, err_msg=f"{key} {k}")
    if option == "sharded":
        assert "opt.mom:zero_bucket@zshard" in got["states"]
    bufs = [k for k in js if k.endswith(("running_mean", "running_var"))]
    assert bool(bufs) == (name == "resnet18")


def _epoch_losses(text):
    return [float(v) for v in re.findall(r"epoch \d+: loss=([0-9.]+)", text)]


def test_train_multiprocess_matches_jax_script(capsys, monkeypatch):
    import train_multiprocess as jtm
    args = SimpleNamespace(model="cnn", data="mnist", max_epoch=2,
                           batch_size=8, lr=0.005, num_samples=64,
                           world_size=2, dist_option="plain", spars=0.05,
                           seed=0, device="cpu")
    # the JAX script's initial weights: its own seeded draws, replayed
    np.random.seed(args.seed)
    jm = _jax_model("cnn", num_classes=10, num_channels=1)
    from data import synthetic
    x, _ = synthetic.load("mnist", num=args.num_samples, seed=args.seed)
    jm.compile([jtensor.from_numpy(x[:16])], is_train=True)
    init = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
    port = launch(train_multiprocess.run, 2, args=(args, init),
                  device="cpu", timeout=TIMEOUT)
    rs = np.random.RandomState(args.seed)      # the port's permutations
    perms = [rs.permutation(args.num_samples) for _ in range(2)]
    monkeypatch.setattr(np.random, "permutation",
                        lambda n: perms.pop(0))
    capsys.readouterr()
    jtm.run(args)
    out = capsys.readouterr().out
    want = _epoch_losses(out)
    assert len(want) == 2 and not perms
    np.testing.assert_allclose(port["epoch_losses"], want, atol=1.5e-4)
    assert port["epoch_losses"][1] < port["epoch_losses"][0]


def test_train_cnn_zero1_matches_jax_script(tmp_path, caplog):
    import train_cnn as jtc
    argv = ["cnn", "-d", "mnist", "-n", "64", "-b", "16", "-m", "2",
            "--device", "cpu", "--zero1", "2", "--log-steps"]
    import argparse
    ns = argparse.Namespace(
        model="cnn", data="mnist", max_epoch=2, batch_size=16, lr=0.005,
        num_samples=64, graph=True, verbosity=0, seed=0, data_dir=None,
        device="cpu", ckpt=None, resume=False, ckpt_format="zip",
        ckpt_every=0, ckpt_keep=3, ckpt_sync=False, watchdog="skip",
        zero1=2, log_steps=True, chaos_nan_step=None, chaos_kill_step=None,
        chaos_kill_save=0, chaos_kill_phase="staged")
    # the JAX script's initial states, from its own seeded draws
    from data import loader
    from singa_tpu.device import CppCPU
    np.random.seed(0)
    CppCPU().set_rand_seed(0)
    x, y, _ = loader.load("mnist", num=64, seed=0)
    comm = JCommunicator.from_devices(jax.devices()[:2])
    jm = jtc.create_model("cnn", num_classes=10, num_channels=1)
    jm.set_optimizer(jopt.DistOpt(jopt.SGD(lr=0.005, momentum=0.9,
                                           weight_decay=1e-5),
                                  communicator=comm))
    jm.compile([jtensor.Tensor(data=x[:16])], is_train=True,
               use_graph=True, communicator=comm)
    ckpt = str(tmp_path / "jax_init.zip")
    jm.save_states(ckpt, aux_states={"epoch": np.asarray(-1)})
    port = train_cnn.main(argv + ["--ckpt", ckpt, "--resume"])
    with caplog.at_level(logging.INFO, logger="singa_tpu"):
        jtc.run(ns)
    want = [float(m.group(1)) for m in
            (re.search(r"step \d+: loss=([-0-9.e]+)", r.getMessage())
             for r in caplog.records) if m]
    assert len(want) == len(port["step_losses"]) == 8
    np.testing.assert_allclose(port["step_losses"], want, rtol=1e-5)
