"""The port's optimizers and schedules (singa_tpu_torch.opt, on the CPU)
against the JAX package's (singa_tpu.opt): the same parameters and the
same seeded gradients through ``apply`` + ``step`` for 3 steps; parameters
and every named state agree to atol 1e-6 in float32 after each step (the
update rules are the same elementwise arithmetic), and the schedules give
the JAX float32 learning rates to a relative 3e-7 (a float32 ulp or two:
``pow`` is numpy's on one side and XLA's on the other)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import opt as jopt
from singa_tpu.tensor import Tensor as JTensor
from singa_tpu_torch import opt as topt
from singa_tpu_torch.tensor import Tensor as TTensor

torch.set_num_threads(1)

ATOL = 1e-6

CASES = {
    "sgd": lambda o: o.SGD(lr=0.1),
    "sgd_momentum_dampening": lambda o: o.SGD(lr=0.1, momentum=0.9,
                                              dampening=0.1),
    "sgd_nesterov_weight_decay": lambda o: o.SGD(lr=0.1, momentum=0.9,
                                                 nesterov=True,
                                                 weight_decay=0.01),
    "sgd_exponential_decay": lambda o: o.SGD(
        lr=o.ExponentialDecay(0.1, 2, 0.5), momentum=0.5),
    "adam": lambda o: o.Adam(lr=0.01),
    "adam_weight_decay": lambda o: o.Adam(lr=0.01, weight_decay=0.1),
    "adamw": lambda o: o.AdamW(lr=0.01, weight_decay=0.1),
    "adamw_warmup_cosine": lambda o: o.AdamW(
        lr=o.WarmupCosine(0.01, 1, 3, final_value=0.001), weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_jax(name):
    rng = np.random.RandomState(list(CASES).index(name))
    shapes = {"w": (4, 3), "b": (3,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jo, to = CASES[name](jopt), CASES[name](topt)
    jp = {k: JTensor(data=a, requires_grad=True, stores_grad=True, name=k)
          for k, a in init.items()}
    tp = {k: TTensor(data=a, device="cpu", requires_grad=True,
                     stores_grad=True, name=k) for k, a in init.items()}
    for step, g in enumerate(grads):
        for k in shapes:
            jo.apply(jp[k], JTensor(data=g[k], requires_grad=False))
            to.apply(tp[k], TTensor(data=g[k], device="cpu",
                                    requires_grad=False))
        jo.step()
        to.step()
        for k in shapes:
            assert tp[k].data.requires_grad         # still the same leaf
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k].data),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{k} after step {step}")
    js = {k: np.asarray(v) for k, v in jo.get_states().items()}
    ts = to.get_states()
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("sched", [
    lambda o: o.WarmupCosine(0.01, 2, 6, final_value=0.001),
    lambda o: o.WarmupCosine(1.0, 1, 2),
    lambda o: o.ExponentialDecay(0.1, 3, 0.5, staircase=True),
    lambda o: o.ExponentialDecay(0.2, 2, 0.9),
    lambda o: o.Constant(0.05)],
    ids=["warmup_cosine", "warmup_cosine_short", "exp_staircase", "exp",
         "constant"])
def test_schedules_match_jax(sched):
    js, ts = sched(jopt), sched(topt)
    for step in range(9):
        want = float(js(jnp.asarray(step, jnp.int32)))
        # within an ulp or two: pow is numpy's here and XLA's there
        np.testing.assert_allclose(np.float32(ts(step)), want, rtol=3e-7,
                                   err_msg=f"step {step}")


def test_states_restore_by_name_before_they_exist():
    o = topt.Adam(lr=0.01)
    p = TTensor(data=np.ones((2, 2), np.float32), device="cpu",
                requires_grad=True, stores_grad=True, name="w")
    o.set_states({"opt_step": np.int32(7),
                  "m:w": np.full((2, 2), 0.5, np.float32),
                  "v:w": np.full((2, 2), 0.25, np.float32)})
    assert o.step_counter == 7
    assert set(o.get_states()) == {"opt_step", "m:w", "v:w"}
    o.apply(p, TTensor(data=np.zeros((2, 2), np.float32), device="cpu"))
    st = o.get_states()
    np.testing.assert_allclose(st["m:w"], 0.45)          # 0.9 * 0.5
    np.testing.assert_allclose(st["v:w"], 0.24975)       # 0.999 * 0.25
