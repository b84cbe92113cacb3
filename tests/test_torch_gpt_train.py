"""The port's training slice as a whole (singa_tpu_torch.models.gpt.GPT
through Model.compile -> train_one_batch -> opt.Adam, on the CPU) against
the JAX GPT trained in graph mode, for GPTConfig.tiny with use_flash True
(the Pallas kernels in interpret mode against the port's plain flash
forward and backward) and False, and with rope.

Weights cross by name: the JAX states after compile go into
``GPT.from_jax_states``; both then take 3 Adam steps on the same numpy
batches.  Tolerances: losses to a relative 1e-5 (float32, summation order
only); parameters atol 1e-5.  The attention key biases carry no signal:
their exact gradient is zero (a per-row shift of the scores leaves softmax
unchanged), so each side's gradient there is float noise, which Adam's
normalised step turns into a move of either sign.  They are not compared
across the two sides; instead each side must have moved them no further
from the starting weights than Adam can move any entry in that many steps
(``_adam_max_move``, about lr a step), plus an ulp a step.  The trained
port model's ``decode_params()`` matches the JAX ``decode_params()`` leaf
for leaf at the same tolerances, and the port's ServingEngine gives the
same greedy tokens on the port-trained model as on the JAX-trained
weights."""

import jax
import numpy as np
import pytest
import torch

from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt as jgpt
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

LR, STEPS, B, T = 1e-3, 3, 2, 16
ATOL = 1e-5
CONFIGS = {"flash": dict(use_flash=True), "naive": dict(use_flash=False),
           "rope": dict(use_flash=True, use_rope=True)}
ENGINE_KW = dict(n_slots=2, page_tokens=8, chunk_tokens=8, decode_horizon=4)


def _stream(vocab, n, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab if rng.rand() > 0.1 \
            else rng.randint(vocab)
    return x


def _batches(vocab):
    data = _stream(vocab, STEPS * B * T + 1, seed=5)
    out = []
    for s in range(STEPS):
        seg = data[s * B * T:(s + 1) * B * T + 1]
        out.append((seg[:-1].reshape(B, T), seg[1:].reshape(B, T)))
    return out


def _adam_max_move(steps, b1=0.9, b2=0.999):
    """The most Adam (bias-corrected, constant lr) moves one entry in
    ``steps`` steps: step t moves it by lr * sum_i w_i g_i / sqrt(sum_i
    u_i g_i^2) (w, u the bias-corrected moment weights), at most
    lr * sqrt(sum_i w_i^2 / u_i) by Cauchy-Schwarz."""
    total = 0.0
    for t in range(1, steps + 1):
        age = t - np.arange(1, t + 1)
        w = (1 - b1) * b1 ** age / (1 - b1 ** t)
        u = (1 - b2) * b2 ** age / (1 - b2 ** t)
        total += np.sqrt((w * w / u).sum())
    return LR * total


def _no_signal(name):
    """Attention key biases (state ``*.Wk.b``, decode leaf ``*].k.b``)."""
    return name.endswith("Wk.b") or name.endswith("].k.b")


def _assert_leaf(name, got, want, start, steps):
    """``got`` against ``want`` at ATOL; a no-signal leaf instead checks
    that each side moved at most Adam's bound from ``start``."""
    if not _no_signal(name):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=name)
        return
    bound = _adam_max_move(steps)
    bound += steps * float(np.spacing(np.float32(np.abs(start).max()
                                                 + bound)))
    for side, a in (("port", got), ("jax", want)):
        moved = float(np.abs(np.asarray(a) - start).max())
        assert moved <= bound, f"{name} ({side}) moved {moved} > {bound}"


@pytest.fixture(scope="module", params=list(CONFIGS))
def trained(request):
    """Both models trained the same 3 steps from the same weights."""
    kw = CONFIGS[request.param]
    np.random.seed(0)
    cfg = jgpt.GPTConfig.tiny(**kw)
    batches = _batches(cfg.vocab_size)
    m = jgpt.GPT(cfg)
    m.set_optimizer(jopt.Adam(lr=LR))
    m.compile([jtensor.from_numpy(batches[0][0])], is_train=True,
              use_graph=True)
    start = jax.tree.map(np.asarray, m.get_states())
    j_loss = [float(m.train_one_batch(jtensor.from_numpy(x),
                                      jtensor.from_numpy(y))[1].numpy())
              for x, y in batches]
    j_states = jax.tree.map(np.asarray, m.get_states())
    j_opt = {k: np.asarray(v) for k, v in m.optimizer.get_states().items()}
    j_decode = jax.tree.map(np.asarray, m.decode_params())
    # one more step from there, for the optimizer-state hand-over
    x, y = batches[0]
    j_loss4 = float(m.train_one_batch(jtensor.from_numpy(x),
                                      jtensor.from_numpy(y))[1].numpy())
    j_states4 = jax.tree.map(np.asarray, m.get_states())
    m.eval()

    tcfg = tgpt.GPTConfig.tiny(**kw)
    tm = tgpt.GPT.from_jax_states(start, tcfg, device="cpu")
    tm.set_optimizer(topt.Adam(lr=LR))
    tm.compile([batches[0][0]], is_train=True, use_graph=True)
    t_loss = [tm.train_one_batch(x, y)[1].item() for x, y in batches]
    tm.eval()
    return dict(name=request.param, cfg=tcfg, start=start, j_loss=j_loss,
                t_loss=t_loss, j_states=j_states, j_opt=j_opt,
                j_decode=j_decode, j_loss4=j_loss4, j_states4=j_states4,
                tm=tm)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_states_cross_by_name(trained):
    start, tm = trained["start"], trained["tm"]
    n = 38 if trained["name"] != "rope" else 37       # no pos table
    assert len(start) == n
    assert set(tm.get_states()) == set(start)
    assert all(t.name == k for k, t in tm.get_states().items())


def test_losses_match_jax(trained):
    j, t = np.asarray(trained["j_loss"]), np.asarray(trained["t_loss"])
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def test_graph_step_outputs_leave_the_graph(trained):
    """Under ``use_graph=True`` a step's outputs come back as a traced
    step's do: no creator and no torch graph (the losses above are those
    of such steps).  The carried-state case is
    ``test_torch_autograd_layer.py::test_graph_mode_cuts_the_step_at_inputs_and_outputs``
    and ``test_torch_char_rnn.py``."""
    cfg = trained["cfg"]
    x, y = _batches(cfg.vocab_size)[0]
    tm = tgpt.GPT.from_jax_states(trained["start"], cfg, device="cpu")
    tm.set_optimizer(topt.Adam(lr=LR))
    tm.compile([x], is_train=True, use_graph=True)
    logits, loss = tm.train_one_batch(x, y)
    tm.eval()
    assert logits.creator is None and loss.creator is None
    assert not logits.data.requires_grad and not loss.requires_grad
    assert loss.item() == trained["t_loss"][0]


def test_params_and_adam_state_match_jax(trained):
    tm, js = trained["tm"], trained["j_states"]
    start = trained["start"]
    for name, t in tm.get_states().items():
        _assert_leaf(name, t.numpy(), js[name], start[name], STEPS)
    to = tm.optimizer.get_states()
    jo = trained["j_opt"]
    assert set(to) == set(jo)
    assert int(to["opt_step"]) == int(jo["opt_step"]) == STEPS
    for name in ("m:tok.W", "v:head.W", "m:blocks1.fc2.W"):
        # moments to 1e-5 of the tensor's largest entry
        np.testing.assert_allclose(to[name], jo[name], rtol=0,
                                   atol=1e-5 * np.abs(jo[name]).max(),
                                   err_msg=name)


def test_decode_params_match_jax(trained):
    def numpy_leaves(model):
        return dict(_leaves(jax.tree.map(lambda t: t.numpy(),
                                         model.decode_params())))

    got = numpy_leaves(trained["tm"])
    start = numpy_leaves(tgpt.GPT.from_jax_states(
        trained["start"], trained["cfg"], device="cpu"))
    want = dict(_leaves(trained["j_decode"]))
    assert got.keys() == want.keys() == start.keys()
    for name, a in want.items():
        _assert_leaf(name, got[name], a, start[name], STEPS)


def test_port_trained_model_serves_like_the_jax_weights(trained):
    cfg, tm = trained["cfg"], trained["tm"]
    jm = tgpt.GPT.from_jax_decode_params(trained["j_decode"], cfg,
                                         device="cpu")
    prompts = [_stream(cfg.vocab_size, n, seed=20 + n) for n in (5, 11, 19)]
    outs = []
    for model in (tm, jm):
        eng = ServingEngine(model, device="cpu", **ENGINE_KW)
        rids = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_optimizer_continues_from_jax_state(trained):
    """A fresh port model and optimizer restored from the JAX run after 3
    steps (model states by ``from_jax_states``, optimizer states by
    ``set_states``: ``opt_step``, ``m:<param>``, ``v:<param>``) take a
    4th step like the JAX run's 4th."""
    cfg = trained["cfg"]
    x, y = _batches(cfg.vocab_size)[0]
    tm = tgpt.GPT.from_jax_states(trained["j_states"], cfg, device="cpu")
    tm.set_optimizer(topt.Adam(lr=LR))
    tm.optimizer.set_states(trained["j_opt"])   # before the state exists
    tm.compile([x], is_train=True)
    assert tm.optimizer.step_counter == STEPS
    loss = tm.train_one_batch(x, y)[1].item()
    tm.eval()
    np.testing.assert_allclose(loss, trained["j_loss4"], rtol=1e-5, atol=0)
    for name, t in tm.get_states().items():
        _assert_leaf(name, t.numpy(), trained["j_states4"][name],
                     trained["start"][name], STEPS + 1)
    assert tm.optimizer.get_states()["opt_step"] == STEPS + 1
