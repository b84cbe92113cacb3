"""The port's char-RNN example (singa_tpu_torch.examples.char_rnn, on the
CPU) against the JAX package's ``examples/rnn/train.py``, both compiled
with ``use_graph=True``, with the LSTM's fused cell on (the Pallas kernel
in interpret mode against the port's plain cell and recompute backward)
and off.

Weights cross by name (JAX ``get_states()`` into the port's
``set_states``); both then take 6 Adam steps of truncated BPTT on the
same batches of the example's synthetic corpus, hidden 32, B 4, T 16,
carrying ``hx, cx = hy, cy`` from step to step.  Per-step losses agree to
a relative 1e-5 (float32, summation order only).  The carried state
leaves each graph-mode step without a creator, so the next step's
gradient stops there, and ``sample()`` then draws the same characters
from both trained models with the same numpy generator."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.device import CppCPU
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.device import get_device
from singa_tpu_torch.examples import char_rnn as tex
from singa_tpu_torch.ops import lstm_cell as lc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, B, T, STEPS, LR, SAMPLE = 32, 4, 16, 6, 3e-3, 40


def _jax_example():
    """``examples/rnn/train.py`` under a name of its own (other tests
    import other examples' ``train`` modules)."""
    spec = importlib.util.spec_from_file_location(
        "jax_char_rnn_example", os.path.join(REPO, "examples", "rnn",
                                             "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jex():
    return _jax_example()


@pytest.fixture(scope="module", params=["fused", "scan"])
def trained(request, jex):
    fused = request.param == "fused"
    data = tex.Data(tex.synthetic_corpus(4000))
    batches = list(data.batches(B, T))[:STEPS]
    zeros = np.zeros((1, B, HIDDEN), np.float32)

    np.random.seed(0)
    jm = jex.CharRNN(data.vocab, HIDDEN)
    jm.lstm.use_fused_cell = fused
    jm.set_optimizer(jopt.Adam(lr=LR))
    jm.compile([jtensor.from_numpy(batches[0][0])], is_train=True,
               use_graph=True)
    start = jax.tree.map(np.asarray, jm.get_states())
    hx, cx = jtensor.from_numpy(zeros), jtensor.from_numpy(zeros)
    j_loss = []
    for bx, by in batches:
        loss, hx, cx = jm.train_one_batch(jtensor.from_numpy(bx),
                                          jtensor.from_numpy(by), hx, cx)
        j_loss.append(float(loss.numpy()))
    j_hy = hx.numpy()

    dev = get_device("cpu")
    tm = tex.CharRNN(data.vocab, HIDDEN)
    tm.lstm.use_fused_cell = fused
    tm.set_optimizer(topt.Adam(lr=LR))
    tm.compile([ttensor.Tensor(data=batches[0][0], device=dev)],
               is_train=True, use_graph=True)
    names = set(tm.get_states())
    tm.set_states(start)
    hx = ttensor.Tensor(data=zeros, device=dev)
    cx = ttensor.Tensor(data=zeros, device=dev)
    t_loss, creators = [], []
    for bx, by in batches:
        loss, hx, cx = tm.train_one_batch(bx, by, hx, cx)
        t_loss.append(loss.item())
        creators.append((loss.creator, hx.creator, cx.creator,
                         hx.data.requires_grad))
    return dict(fused=fused, data=data, jm=jm, tm=tm, dev=dev,
                start=start, names=names, j_loss=j_loss, t_loss=t_loss,
                j_hy=j_hy, t_hy=hx.numpy(), creators=creators)


def test_state_names_match_jax(trained):
    assert trained["names"] == set(trained["start"]) == {
        "lstm._w0", "lstm._w1", "lstm._w2", "fc.W", "fc.b"}
    assert trained["tm"].lstm.handle.use_fused_cell == trained["fused"]


def test_truncated_bptt_losses_match_jax(trained):
    j, t = np.asarray(trained["j_loss"]), np.asarray(trained["t_loss"])
    assert np.all(np.isfinite(t)) and t[-1] < t[0]
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    np.testing.assert_allclose(trained["t_hy"], trained["j_hy"], rtol=0,
                               atol=1e-5)


def test_carried_state_has_no_creator(trained):
    for loss_c, hy_c, cy_c, grad in trained["creators"]:
        assert loss_c is None and hy_c is None and cy_c is None
        assert not grad


def test_sample_draws_the_same_characters(trained, jex):
    data = trained["data"]
    before = lc.launches
    got = tex.sample(trained["tm"], data, trained["dev"], length=SAMPLE)
    assert lc.launches == before              # the CPU launches nothing
    want = jex.sample(trained["jm"], data, CppCPU(), length=SAMPLE)
    assert len(got) == SAMPLE + 1
    assert got == want


def test_export_onnx_is_not_ported():
    with pytest.raises(NotImplementedError, match="sonnx"):
        tex.main(["--device", "cpu", "--export-onnx", "m.onnx"])


def test_example_runs_an_epoch_on_the_cpu():
    """``run`` end to end at a small size: the loss it returns is
    finite and below the uniform guess over the corpus' characters."""
    loss = tex.main(["--device", "cpu", "-m", "1", "-b", "4", "-t", "16",
                     "--hidden", "16", "-l", "1e-2"])
    vocab = tex.Data(tex.synthetic_corpus()).vocab
    assert np.isfinite(loss) and loss < np.log(vocab)
