"""The port's data parallelism (``singa_tpu_torch.parallel`` and
``opt.DistOpt``) against the JAX package's on the CPU.

The port runs gloo ranks, one spawned process each
(``parallel.launch``, bodies in ``tests/_torch_dist_cases.py``); the
JAX side runs ``Communicator.from_devices(jax.devices()[:2])`` on the
conftest's virtual CPU devices with ``use_graph=True``.  One world-2
group runs every case of this file (a module fixture), one world-4 group
the cold reshard, one world-1 group the collectives.

* Each collective against numpy at world 1 and 2, exactly (sums of two
  addends and copies are exact).
* Every ``DistOpt`` variant on ``tests/test_dist.py``'s MLP and data
  (seed 5, SGD lr 0.1, momentum 0.9, a global batch of 64), 5 steps:
  rank 0's losses and every state (parameters, momenta, residuals,
  accumulation buffers, the ZeRO-1 state all-gathered) against JAX's.
  A sum of two addends is exact, so the gaps are the local compute's
  (float32 products summed in another order): losses and states within
  rtol 1e-5, atol 1e-6, the bf16 all-reduce included.
* ZeRO-1 checkpoints: the port's world-2 save loads into JAX, whose next
  step equals the port's; JAX's save loads into the port, whose next
  step equals JAX's; JAX's world-2 save restores cold into a world-4
  port group and a world-4 JAX mesh, whose next two steps agree; the
  three refusals.
* The overflow vote under bf16 with a unit update guard: an inf in one
  rank's rows makes every rank skip the round (states bit-equal), and
  with the inf on rank 0 the states equal JAX's (bf16 compute: two bf16
  units, ``BF16_RTOL``).  JAX's own vote backs
  the loss scale off on every device but skips the update only where
  the local gradients overflowed: with the inf on device 1, device 0
  (what the host reads) applies the non-finite mean (PERF.md, PR 17).
"""

import jax
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import precision as jprecision
from singa_tpu import tensor as jtensor
from singa_tpu.model import Model as JModel
from singa_tpu.parallel import Communicator as JCommunicator
from singa_tpu_torch import opt as topt
from singa_tpu_torch.model import Model
from singa_tpu_torch.parallel import Communicator, launch
from singa_tpu_torch.tensor import Tensor

import _torch_dist_cases as cases

torch.set_num_threads(1)

STEPS = 5
RTOL, ATOL = 1e-5, 1e-6
# the bf16 policy's gradients round to 8 bits in XLA's order and in
# torch's: two bf16 units of a value apart (the momentum of a bias, 2^-6
# relative, is the largest seen), 2^-10 near zero
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -10
TIMEOUT = 300
# all-reduces a step: the MLP's four grads (256, 32, 128 and 4 values)
CALLS = {"plain_bucket": 1, "plain_big": 4, "half": 1, "partial": 4,
         "sparse_dense": 4, "sparse_indices": 0, "sharded": 0,
         "sharded_small": 0, "accum": 1}
CASES = {
    "plain_bucket": {"variant": "plain"},
    "plain_big": {"variant": "plain", "threshold": 0},
    "half": {"variant": "half"},
    "partial": {"variant": "partial"},
    "sparse_dense": {"variant": "sparse"},
    "sparse_indices": {"variant": "sparse", "encoding": "indices"},
    "sharded": {"variant": "sharded"},
    "sharded_small": {"variant": "sharded", "threshold": 100},
    "accum": {"variant": "accum"},
}


def make_data(n=64, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    y = rng.randint(0, classes, n)
    x = (centers[y] + rng.randn(n, dim)).astype(np.float32)
    return x, y.astype(np.int32)


class JMLP(JModel):
    def __init__(self, case):
        super().__init__()
        self.fc1 = jlayer.Linear(32)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)
        self.case = case

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y, update=True, k=1):
        out = self.forward(x)
        loss = jautograd.softmax_cross_entropy(out, y)
        cases.dist_update(self.optimizer, loss, self.case, update, k)
        return out, loss


def jax_build(case, x, init, n_dev=2):
    comm = JCommunicator.from_devices(jax.devices()[:n_dev])
    np.random.seed(5)
    m = JMLP(case)
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=cases.LR,
                                          momentum=cases.MOMENTUM),
                                 communicator=comm))
    pol = (jprecision.with_update_guard(case["precision"])
           if case.get("precision") else None)
    m.compile([jtensor.from_numpy(x)], is_train=True, use_graph=True,
              communicator=comm, precision=pol)
    m.set_states(init)
    return m


def jax_train(m, batches):
    out = []
    for args in batches:
        xs = [jtensor.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
        _, loss = m.train_one_batch(*xs)
        out.append(float(loss.data))
    return out


def jax_states(m):
    out = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def assert_states(got, want, rtol=RTOL, atol=ATOL, label=""):
    assert set(got) == set(want), (label, sorted(set(got) ^ set(want)))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{label} {k}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The data, the JAX MLP's initial states, the JAX checkpoint the
    port loads, and every world-2 case of the port (one group)."""
    x, y = make_data()
    np.random.seed(5)
    init = {k: np.asarray(v.data)
            for k, v in jax_build({"variant": "plain"}, x, {})
            .get_states().items()}
    ckpt = tmp_path_factory.mktemp("dist_ckpt")
    jm = jax_build({"variant": "sharded"}, x, init)
    jax_train(jm, [(x, y)] * 3)
    jm.save_states(str(ckpt / "jax_sharded.zip"))
    jnext = jax_train(jm, [(x, y)])[0]
    port = launch(cases.mlp_cases, 2, args=(CASES, x, y, init, STEPS,
                                            str(ckpt)),
                  device="cpu", timeout=TIMEOUT)
    return {"x": x, "y": y, "init": init, "ckpt": ckpt, "port": port,
            "jax_next": (jnext, jax_states(jm))}


def _expected_collectives(n):
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
          for r in range(n)]
    rs = [np.arange(4 * n, dtype=np.float32).reshape(2 * n, 2) * (r + 1)
          for r in range(n)]
    total = sum(xs)
    per_rank = {
        "all_reduce": [total] * n,
        "all_reduce_bf16": [total] * n,
        "all_reduce_mean": [total / n] * n,
        "all_gather": [np.concatenate(xs)] * n,
        "all_gather_untiled": [np.stack(xs)] * n,
        "all_gather_scalar": [np.arange(n, dtype=np.float32)] * n,
        "reduce_scatter": [sum(rs)[2 * r:2 * r + 2] for r in range(n)],
        "ppermute_ring": [xs[(r - 1) % n] for r in range(n)],
        "ppermute_one": [xs[0] if r == n - 1 else np.zeros_like(xs[0])
                         for r in range(n)],
        "axis_index": [np.float32(r) for r in range(n)],
    }
    return {k: np.stack(v) for k, v in per_rank.items()}


@pytest.mark.parametrize("n", [1, 2])
def test_collectives_against_numpy(n):
    got = launch(cases.collectives, n, device="cpu", timeout=TIMEOUT)
    assert got["world_size"] == n and got["active"]
    for k, want in _expected_collectives(n).items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    calls = got["stats"]["calls"]
    assert calls[("all_reduce", "data")] == 2
    assert calls[("all_gather", "data")] == 3
    assert got["stats"]["total_calls"] == sum(calls.values()) == 9
    assert got["stats"]["bytes"][("all_reduce", "data")] == 24 + 12


def test_default_communicator_is_the_identity():
    comm = Communicator.default()
    x = torch.arange(4.0)
    assert comm.world_size == 1 and not comm.active
    assert comm.all_reduce(x) is x and comm.reduce_scatter(x) is x
    assert comm.all_gather(x, tiled=False).shape == (1, 4)
    assert comm.axis_index() == 0 and comm.comm_stats()["total_calls"] == 0
    with pytest.raises(ValueError, match="one axis"):
        comm.all_reduce(x, axis="model")
    with pytest.raises(NotImplementedError, match="item 12"):
        Communicator.from_mesh_shape({"data": 2, "model": 2})
    with pytest.raises(RuntimeError, match="process group"):
        Communicator.from_devices()
    with pytest.raises(NotImplementedError, match="item 9"):
        comm.publish_metrics()


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(cases.fail_on_rank_1, 2, device="cpu", timeout=TIMEOUT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_distopt_variant_matches_jax(world, name):
    case = CASES[name]
    x, y = world["x"], world["y"]
    jm = jax_build(case, x, world["init"])
    jl = jax_train(jm, cases.batches_for(case, x, y, STEPS))
    got = world["port"][name]
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL, atol=ATOL)
    assert_states(got["states"], jax_states(jm), label=name)
    assert got["comm_stats"]["allreduce_calls"] == CALLS[name] * STEPS


@pytest.mark.parametrize("name", ["sparse_dense", "sparse_indices"])
def test_sparse_first_step_selects_jax_index_sets(world, name):
    """The first step's top-K selection (the zeros of each residual) is
    JAX's exactly, and its states agree tightly."""
    case = CASES[name]
    x, y = world["x"], world["y"]
    jm = jax_build(case, x, world["init"])
    jax_train(jm, [(x, y)])
    want = jax_states(jm)
    got = world["port"][name]["first"]
    for k in [k for k in want if k.startswith("opt.resid:")]:
        np.testing.assert_array_equal(np.asarray(got[k]) == 0,
                                      want[k] == 0, err_msg=k)
    assert_states(got, want, label=f"{name} step 1")


def test_sharded_state_is_really_sharded(world):
    """Each rank holds its chunk of the ZeRO-1 state (the MLP's 420
    values in one bucket: 210 a rank); saved, it is the global padded
    layout, stamped."""
    got = launch(cases.sharded_shapes, 2, args=(world["x"], world["y"]),
                 device="cpu", timeout=TIMEOUT)
    assert got["views"] == {"zero_bucket@zshard": 210}
    assert got["mom:zero_bucket@zshard"] == (210,)
    assert got["saved"] == (420,)
    assert got["layout"] == [2, 50000]


def test_port_zero1_save_loads_into_jax(world):
    x, y = world["x"], world["y"]
    res = world["port"]["checkpoints"]
    jm = jax_build({"variant": "sharded"}, x, world["init"])
    jm.load_states(str(world["ckpt"] / "port_sharded.zip"))
    jl = jax_train(jm, [(x, y)])[0]
    np.testing.assert_allclose(res["port_next_loss"], jl, rtol=RTOL)
    assert_states(res["port_next"], jax_states(jm), label="port save")


def test_jax_zero1_save_loads_into_port(world):
    res = world["port"]["checkpoints"]
    jl, js = world["jax_next"]
    np.testing.assert_allclose(res["jax_loaded_loss"], jl, rtol=RTOL)
    assert_states(res["jax_loaded"], js, label="JAX save")


def test_zero1_cold_reshard_2_to_4_matches_jax(world):
    x, y = world["x"], world["y"]
    path = str(world["ckpt"] / "jax_sharded.zip")
    case = {"variant": "sharded"}
    got = launch(cases.reshard_case, 4, args=(case, x, y, path, 2),
                 device="cpu", timeout=TIMEOUT)
    assert got["resaved_layout"].tolist() == [2, 50000]
    jm = jax_build(case, x, world["init"], n_dev=4)
    jm.load_states(path)
    jl = jax_train(jm, [(x, y)] * 2)
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL)
    assert_states(got["states"], jax_states(jm), label="reshard")


def test_zero1_refusals(world):
    msgs = world["port"]["refusals"]
    assert "FRESH optimizer" in msgs["warm"]
    assert "threshold" in msgs["threshold"]
    d = topt.DistOpt(topt.SGD(lr=0.1, momentum=0.9))     # world 1
    with pytest.raises(ValueError, match="world_size=1"):
        d.set_states({"__zero1_layout__": np.array([2, 50000], np.int64),
                      "mom:zero_bucket@zshard": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="ZeRO-1"):
        topt.SGD(lr=0.1).set_states(
            {"__zero1_layout__": np.array([2, 50000], np.int64)})


@pytest.mark.parametrize("rank", [0, 1])
def test_overflow_on_one_rank_skips_every_rank(world, rank):
    got = world["port"]["overflow"][rank]
    assert got["kept"] == [1.0, 1.0]
    assert not np.isfinite(got["loss"])
    assert int(got["second"]["opt.loss_scale_good_steps"]) == 0
    assert int(got["first"]["opt.loss_scale_good_steps"]) == 1
    if rank:
        return
    x, y = world["x"], world["y"]
    case = {"variant": "plain", "precision": "bfloat16"}
    jm = jax_build(case, x, world["init"])
    jax_train(jm, [(x, y)])
    assert_states(got["first"], jax_states(jm), BF16_RTOL, BF16_ATOL,
                  label="bf16 step 1")
    xb = x.copy()
    xb[0] = np.inf
    jax_train(jm, [(xb, y)])
    assert_states(got["second"], jax_states(jm), BF16_RTOL, BF16_ATOL,
                  label="bf16 overflow step")


def test_rank_rows_and_batch_split():
    """A rank takes its rows of every array argument (here rank 1 of 2,
    a group-less communicator: its collectives are the identity); a
    batch that does not split over the ranks raises."""
    from singa_tpu_torch import layer

    class _Net(Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(2)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x):
            return self.forward(x)

    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    m = _Net()
    m.compile([Tensor(data=x, device="cpu")],
              communicator=Communicator(world_size=2, rank=1))
    m.eval()
    want = m.forward(Tensor(data=x[2:], device="cpu")).numpy()
    m.train()
    for arg in (x, Tensor(data=x, device="cpu"), torch.from_numpy(x)):
        np.testing.assert_array_equal(m.train_one_batch(arg).numpy(), want)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        m.train_one_batch(x[:3])
    with pytest.raises(TypeError, match="Communicator"):
        m.compile([Tensor(data=x, device="cpu")], communicator=object())


def test_optimizer_states_are_snapshots():
    """``get_states()`` arrays keep their values after the next in-place
    update (a CPU tensor's ``numpy()`` is a copy), as the reference's
    immutable arrays do."""
    from singa_tpu_torch import layer
    t = Tensor(data=np.ones(3, np.float32), device="cpu")
    snap = t.numpy()
    t.data.add_(1.0)
    np.testing.assert_array_equal(snap, np.ones(3, np.float32))
    o = topt.SGD(lr=0.1, momentum=0.9)
    p = layer.Linear(2)
    del p
    saved = o.get_states()["opt_step"]
    o.step()
    assert int(saved) == 0 and int(o.get_states()["opt_step"]) == 1
