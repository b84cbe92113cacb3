"""The rest of the port's Model and Optimizer (singa_tpu_torch.model,
singa_tpu_torch.opt) on the CPU against the JAX package's, on the Net of
tests/test_run_k_steps.py (Linear 16, ReLU, Linear 4, softmax
cross-entropy) with the same seeded numpy weights and batches.

Tolerances, with the reason for each:

* ``run_k_steps(5)`` against five port calls: bit for bit (the same ops
  in the same order); against the JAX ``run_k_steps(5)``: atol 1e-5 on
  the loss and every state (float32, summation order only);
* ``track_grad_norm``: relative 1e-5 in float32 (a sum in another
  order), and two units in the last place of the compute dtype under
  bf16 and fp16 (each gradient within one unit of JAX's, squared);
* ``predict``: atol 1e-5 in float32; under bf16, the float32 outputs of
  a bf16 forward within two units in the last place of bf16 at
  max(|x|, 2^-6) (each of the two products rounds its sum to bf16 once,
  in either framework's order: one unit each);
* checkpoints: the members, names and values exactly; a restored model
  continues as the uninterrupted one bit for bit in the port, and as the
  JAX model within atol 1e-5.

The address-stable step holds every optimizer under no policy, bf16 and
fp16: after step 1, every state tensor (parameters, buffers, optimizer
state, the loss scale, the step counter) keeps its name and its
storage, which a step replayed as a CUDA graph needs."""

import os
import zipfile

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.model import Model as JModel
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch.model import Model as TModel
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

ATOL = 1e-5
BITS = {"bfloat16": 8, "float16": 11}


class JNet(JModel):
    def __init__(self):
        super().__init__()
        self.fc1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = jautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


class TNet(TModel):
    def __init__(self):
        super().__init__()
        self.fc1 = tlayer.Linear(16)
        self.relu = tlayer.ReLU()
        self.fc2 = tlayer.Linear(4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = tautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


OPTS = {"sgd_momentum": lambda o: o.SGD(lr=0.1, momentum=0.9),
        "adam": lambda o: o.Adam(lr=0.01),
        "adamw": lambda o: o.AdamW(lr=0.01, weight_decay=0.1),
        "rmsprop": lambda o: o.RMSProp(lr=0.01),
        "adagrad": lambda o: o.AdaGrad(lr=0.1)}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 12).astype(np.float32),
            rng.randint(0, 4, 8).astype(np.int32))


def _jax_net(opt="sgd_momentum", precision=None, seed=0, track=False):
    np.random.seed(seed)
    m = JNet()
    m.set_optimizer(OPTS[opt](jopt))
    if track:
        m.optimizer.track_grad_norm(True)
    x, _ = _data(seed)
    m.compile([jtensor.from_numpy(x)], is_train=True, use_graph=True,
              precision=precision)
    return m


def _port_net(init, opt="sgd_momentum", precision=None, seed=0,
              track=False, use_graph=True):
    """The port's Net on the CPU with the JAX Net's initial weights."""
    m = TNet()
    m.set_optimizer(OPTS[opt](topt))
    if track:
        m.optimizer.track_grad_norm(True)
    x, _ = _data(seed)
    m.compile([Tensor(data=x, device="cpu", requires_grad=False)],
              is_train=True, use_graph=use_graph, precision=precision)
    m.set_states(init)
    return m


def _init(jm):
    return {k: np.asarray(v.data) for k, v in jm.get_states().items()}


def _states(m):
    """Model and optimizer states as numpy arrays (``opt.`` prefixed)."""
    out = {k: np.asarray(v.numpy() if isinstance(v, Tensor) else v.data)
           for k, v in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def _ulps(got, ref, bits):
    g, r = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(r)), 2.0 ** -6))
    return float((np.abs(g - r) / np.ldexp(1.0, e - bits)).max())


# ---- track_grad_norm ------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bfloat16", "float16"])
def test_track_grad_norm_matches_jax(precision):
    jm = _jax_net("adam", precision, track=True)
    tm = _port_net(_init(jm), "adam", precision, track=True)
    x, y = _data()
    rtol = 1e-5 if precision is None else 2 * 2.0 ** -BITS[precision]
    for step in range(3):
        jm.train_one_batch(jtensor.from_numpy(x), jtensor.from_numpy(y))
        tm.train_one_batch(x, y)
        want = float(jm.optimizer._grad_norm_sq.data)
        got = tm.optimizer.get_states()["grad_norm_sq"]
        assert got.dtype == np.float32 and got.shape == ()
        assert want > 0
        np.testing.assert_allclose(float(got), want, rtol=rtol,
                                   err_msg=f"step {step}")
    assert "grad_norm_sq" in {t.name for t in tm.optimizer.state_tensors()}
    tm.optimizer.track_grad_norm(False)
    assert "grad_norm_sq" not in tm.optimizer.get_states()


# ---- the address-stable step ----------------------------------------------

@pytest.mark.parametrize("precision", [None, "bfloat16", "float16"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_steps_keep_every_state_in_place(opt, precision):
    jm = _jax_net(opt)
    tm = _port_net(_init(jm), opt, precision)
    x, y = _data()

    def storage():
        out = {n: t.data.data_ptr() for n, t in tm.get_states().items()}
        for t in tm.optimizer.state_tensors():
            assert t.name not in out, t.name
            out[t.name] = t.data.data_ptr()
        return out

    tm.train_one_batch(x, y)
    first = storage()
    assert "opt_step" in first
    if precision == "float16":
        assert {"loss_scale", "loss_scale_good_steps",
                "loss_scale_found_inf"} <= set(first)
    for _ in range(2):
        tm.train_one_batch(x, y)
        assert storage() == first
    assert tm.optimizer.step_counter.dtype == torch.int32
    assert tm.optimizer.get_states()["opt_step"] == 3


# ---- run_k_steps -----------------------------------------------------------

def test_run_k_steps_matches_calls_and_jax():
    k = 5
    jm = _jax_net()
    init = _init(jm)
    x, y = _data()
    _, jloss = jm.run_k_steps(k, jtensor.from_numpy(x), jtensor.from_numpy(y))
    seq = _port_net(init)
    for _ in range(k):
        _, sloss = seq.train_one_batch(x, y)
    tm = _port_net(init)
    out, loss = tm.run_k_steps(k, x, y)
    assert loss.creator is None and out.creator is None
    assert loss.item() == sloss.item()
    js, ss, ts = _states(jm), _states(seq), _states(tm)
    assert set(ts) == set(ss) == set(js)
    for name in ts:
        np.testing.assert_array_equal(ts[name], ss[name], err_msg=name)
        np.testing.assert_allclose(ts[name], js[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(loss.item(), float(jloss.data), rtol=0,
                               atol=ATOL)
    _, after = tm.train_one_batch(x, y)       # the normal step still works
    assert np.isfinite(after.item())
    assert tm.optimizer.get_states()["opt_step"] == k + 1
    with pytest.raises(ValueError):
        tm.run_k_steps(0, x, y)


# ---- predict ---------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bfloat16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_predict_matches_jax(precision, training):
    jm = _jax_net(precision=precision)
    tm = _port_net(_init(jm), precision=precision)
    x, y = _data(3)
    jm.train_one_batch(jtensor.from_numpy(x), jtensor.from_numpy(y))
    tm.train_one_batch(x, y)
    tm.train(training)
    want = np.asarray(jm.predict(jtensor.from_numpy(x)).data)
    got = tm.predict(x)
    assert tm.training == training and tautograd.training == training
    assert got.creator is None and not got.data.requires_grad
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert got.shape == want.shape == (8, 4)
    if precision is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    else:
        assert _ulps(got.numpy(), want, BITS[precision]) <= 2
    for t in tm.get_states().values():       # the masters are back
        assert t.data.dtype == torch.float32 and t.data.requires_grad
    tm.train(True)


# ---- checkpoints -----------------------------------------------------------

def test_port_checkpoint_resumes_bit_for_bit(tmp_path):
    """Save after step 2, load into a fresh model (before its first step:
    the optimizer's state is created from the restored entries), three
    more steps: the uninterrupted run's losses and states exactly."""
    init = _init(_jax_net("adam"))
    x, y = _data()
    batches = [_data(s) for s in range(5)]
    whole = _port_net(init, "adam")
    losses = []
    for s, (bx, by) in enumerate(batches):
        losses.append(whole.train_one_batch(bx, by)[1].item())
        if s == 1:
            whole.save_states(str(tmp_path / "ckpt.zip"))
    fresh = _port_net(_init(_jax_net("adam", seed=1)), "adam")
    assert fresh.load_states(str(tmp_path / "ckpt.zip")) == {}
    assert fresh.optimizer.step_counter.item() == 2
    resumed = [fresh.train_one_batch(bx, by)[1].item()
               for bx, by in batches[2:]]
    assert resumed == losses[2:]
    a, b = _states(whole), _states(fresh)
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    jm = _jax_net("adam")
    init = _init(jm)
    x, y = _data()
    for _ in range(2):
        jm.train_one_batch(jtensor.from_numpy(x), jtensor.from_numpy(y))
    path = str(tmp_path / "jax.zip")
    jm.save_states(path, aux_states={"epoch": 2})
    jl = [float(jm.train_one_batch(jtensor.from_numpy(x),
                                   jtensor.from_numpy(y))[1].data)
          for _ in range(2)]
    tm = _port_net({k: np.zeros_like(v) for k, v in init.items()}, "adam")
    aux = tm.load_states(path)
    assert set(aux) == {"epoch"} and int(aux["epoch"]) == 2
    tl = [tm.train_one_batch(x, y)[1].item() for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    js, ts = _states(jm), _states(tm)
    assert set(js) == set(ts)
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    assert ts["opt.opt_step"].dtype == np.int32 and ts["opt.opt_step"] == 4


def test_port_checkpoint_loads_into_jax(tmp_path):
    jm0 = _jax_net("sgd_momentum")
    tm = _port_net(_init(jm0), "sgd_momentum", precision="float16")
    x, y = _data()
    for _ in range(2):
        tm.train_one_batch(x, y)
    path = str(tmp_path / "port.zip")
    tm.save_states(path, aux_states={"lr": np.float32(0.1),
                                     "seen": Tensor(data=np.arange(3),
                                                    device="cpu")})
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["states_attr.npz",
                                         "tensor_dict.npz"]
    jm = _jax_net("sgd_momentum", precision="float16", seed=5)
    aux = jm.load_states(path)
    assert float(aux["lr"]) == np.float32(0.1)
    np.testing.assert_array_equal(aux["seen"], np.arange(3))
    js, ts = _states(jm), _states(tm)
    assert set(js) == set(ts)
    assert {"opt.opt_step", "opt.mom:fc1.W", "opt.loss_scale"} <= set(ts)
    for name in ts:
        np.testing.assert_array_equal(js[name], ts[name], err_msg=name)
    jl = float(jm.train_one_batch(jtensor.from_numpy(x),
                                  jtensor.from_numpy(y))[1].data)
    tl = tm.train_one_batch(x, y)[1].item()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


def test_checkpoint_members_and_names_match_jax(tmp_path):
    jm = _jax_net("adam")
    tm = _port_net(_init(jm), "adam")
    x, y = _data()
    jm.train_one_batch(jtensor.from_numpy(x), jtensor.from_numpy(y))
    tm.train_one_batch(x, y)
    keys = {}
    for side, m in (("jax", jm), ("port", tm)):
        path = str(tmp_path / f"{side}.zip")
        m.save_states(path)
        assert not os.path.exists(path + ".tmp")
        with zipfile.ZipFile(path) as zf:
            assert sorted(zf.namelist()) == ["states_attr.npz",
                                             "tensor_dict.npz"]
            with zf.open("tensor_dict.npz") as f:
                keys[side] = set(np.load(f).files)
    assert keys["port"] == keys["jax"]
    assert {k for k in keys["port"] if not k.startswith("opt.")} == \
        set(tm.get_states())
    assert {k[4:] for k in keys["port"] if k.startswith("opt.")} == \
        set(tm.optimizer.get_states())


@pytest.mark.parametrize("fmt", ["snapshot", "orbax"])
def test_other_checkpoint_formats_raise(tmp_path, fmt):
    """orbax raises NotImplementedError naming its ROADMAP item, on save
    and on a directory; a snapshot saves, and a corrupt one raises
    ``CorruptCheckpointError`` by its path and by its prefix; an unknown
    format and a missing file raise."""
    from singa_tpu_torch.snapshot import CorruptCheckpointError
    tm = _port_net(_init(_jax_net()))
    with pytest.raises(ValueError):
        tm.save_states(str(tmp_path / "ckpt"), format="pickle")
    with pytest.raises(FileNotFoundError):
        tm.load_states(str(tmp_path / "missing.zip"))
    if fmt == "orbax":
        with pytest.raises(NotImplementedError, match="item 12"):
            tm.save_states(str(tmp_path / "ckpt"), format=fmt)
        with pytest.raises(NotImplementedError, match="item 12"):
            tm.load_states(str(tmp_path))
        return
    tm.save_states(str(tmp_path / "good"), format=fmt)
    assert tm.load_states(str(tmp_path / "good")) == {}
    (tmp_path / "ckpt.bin").write_bytes(b"SGBF" + bytes(12))
    with pytest.raises(CorruptCheckpointError):
        tm.load_states(str(tmp_path / "ckpt.bin"))
    with pytest.raises(CorruptCheckpointError):
        tm.load_states(str(tmp_path / "ckpt"))      # the snapshot's prefix


# ---- the captured step's bookkeeping (the capture itself needs the card) --

def test_step_signature_keys_the_captured_step():
    """The graph of a step is keyed on its input signature (reference
    ``_split_args``): Tensor shapes and dtypes, the other arguments'
    values and the training flag; host arrays are narrowed to 32 bits
    as ``Tensor`` narrows them, and an argument that is neither array
    data nor a hashable scalar raises."""
    from singa_tpu_torch import model as tmodel
    x, y = _data()
    raw = tmodel._raw_inputs([x, Tensor(data=y, device="cpu"), 3, "mode"])
    assert raw[0].dtype == torch.float32 and raw[1].dtype == torch.int32
    assert raw[2:] == [3, "mode"]
    wide = tmodel._raw_inputs([x.astype(np.float64), y.astype(np.int64)])
    assert [r.dtype for r in wide] == [torch.float32, torch.int32]
    key = tmodel._signature(raw)
    assert key == tmodel._signature(tmodel._raw_inputs(
        [x + 1, y, 3, "mode"]))
    for other in ([x[:4], y, 3, "mode"], [x, y.astype(np.float32), 3, "mode"],
                  [x, y, 4, "mode"]):
        assert tmodel._signature(tmodel._raw_inputs(other)) != key
    prev = tautograd.training
    try:
        tautograd.training = not prev
        assert tmodel._signature(raw) != key
    finally:
        tautograd.training = prev
    with pytest.raises(TypeError, match="cannot be captured"):
        tmodel._signature(tmodel._raw_inputs([x, [1, 2]]))


def test_replays_are_credited_every_kernel_counter():
    """A replay adds the launches its capture recorded to every
    ``launches*`` counter of the kernel wrappers."""
    from singa_tpu_torch import model as tmodel
    from singa_tpu_torch.ops import (elementwise, flash_attention, lstm_cell,
                                     paged_attention)
    counts = tmodel._launch_counts()
    names = {(m.__name__.rsplit(".", 1)[-1], n) for m, n in counts}
    assert {("flash_attention", "launches_dq"), ("lstm_cell", "launches_bwd"),
            ("paged_attention", "launches_merge"),
            ("elementwise", "launches")} <= names
    assert len(names) == sum(
        1 for m in (flash_attention, paged_attention, lstm_cell, elementwise)
        for n in vars(m) if n.startswith("launches"))


def test_fixed_order_take_matches_index_select():
    """The gather the card runs (``autograd._Take``: index_select forward,
    a sorted ``index_put_`` accumulate backward) gives index_select's
    values and gradients, repeated ids summed, on any axis."""
    from singa_tpu_torch.autograd import _Take
    rng = np.random.RandomState(0)
    v = torch.tensor(rng.randn(7, 5, 3).astype(np.float32),
                     requires_grad=True)
    for ax in (0, 1, 2):
        idx = torch.tensor(rng.randint(0, v.shape[ax], 11))
        a = _Take.apply(v, ax, idx)
        b = torch.index_select(v, ax, idx)
        g = torch.tensor(rng.randn(*a.shape).astype(np.float32))
        ga, = torch.autograd.grad(a, v, g)
        gb, = torch.autograd.grad(b, v, g)
        assert torch.equal(a, b)
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"axis {ax}")


# ---- on_device, graph and the device's profiling ----------------------------

@pytest.mark.parametrize("opt", ["sgd_momentum", "adam"])
def test_on_device_mid_training_matches_jax_and_the_uninterrupted_run(opt):
    """Two steps, ``on_device`` to a second CPU device (the JAX model to
    its second virtual CPU device), two more steps: every state, the
    optimizer's included, is on the new device, and the losses and
    states equal the uninterrupted port run exactly and JAX's within
    atol 1e-5.  The reference's ``on_device`` leaves the optimizer's
    state where it was, and its next step then mixes two devices; the
    port moves it, so the JAX side moves it too (``Tensor.to_device``),
    and the second device's RNG key, which JAX made on the first."""
    from singa_tpu import device as jdevice
    from singa_tpu_torch import device as tdevice
    jm = _jax_net(opt)
    init = _init(jm)
    whole = _port_net(init, opt)
    moved = _port_net(init, opt)
    batches = [_data(s) for s in range(4)]
    other, jother = tdevice.create_cpu_device(seed=1), jdevice.CppCPU(1)
    assert jother.jax_device != jm.device.jax_device
    for s, (x, y) in enumerate(batches):
        if s == 2:
            assert moved.on_device(other) is moved
            jm.on_device(jother)
            for t in jm.optimizer.state_tensors():
                t.to_device(jother)
            jother.set_rng_state(jother.put(jother.get_rng_state()))
            assert moved.device is other and moved._graphs == {}
            for t in list(moved.get_states().values()) + \
                    moved.optimizer.state_tensors():
                assert t.device is other, t.name
            params = moved.get_params().values()
            assert all(p.data.is_leaf and p.data.requires_grad
                       for p in params)
        _, lw = whole.train_one_batch(x, y)
        _, lm = moved.train_one_batch(x, y)
        _, lj = jm.train_one_batch(jtensor.from_numpy(x, jm.device),
                                   jtensor.from_numpy(y, jm.device))
        assert lm.item() == lw.item()
        np.testing.assert_allclose(lm.item(), float(lj.data), rtol=0,
                                   atol=ATOL)
    sw, sm, sj = _states(whole), _states(moved), _states(jm)
    assert set(sm) == set(sw) == set(sj)
    for name in sm:
        np.testing.assert_array_equal(sm[name], sw[name], err_msg=name)
        np.testing.assert_allclose(sm[name], sj[name], rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("use_graph", [True, False])
def test_graph_sets_the_mode_as_jax(use_graph):
    jm = _jax_net()
    tm = _port_net(_init(jm), use_graph=use_graph)
    x, y = _data()
    for mode, seq in ((not use_graph, True), (use_graph, False)):
        jm.graph(mode, seq)
        tm.graph(mode, seq)
        assert (tm.graph_mode, tm.sequential) == (jm.graph_mode,
                                                  jm.sequential)
        _, lj = jm.train_one_batch(jtensor.from_numpy(x),
                                   jtensor.from_numpy(y))
        out, lt = tm.train_one_batch(x, y)
        # graph mode cuts the step's outputs from its graph
        assert (out.creator is None) == mode
        np.testing.assert_allclose(lt.item(), float(lj.data), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("use_graph", [True, False])
def test_verbosity_times_every_step_and_banks_one_flop_table(use_graph):
    """At ``SetVerbosity(1)`` every ``train_one_batch`` is timed (JAX's
    compiled steps too), and the flop table is banked once per input
    signature: the products of the Net's two Linear layers, forward and
    backward (4 B I H + 6 B H O: no gradient for the input)."""
    from singa_tpu_torch import device as tdevice
    jm = _jax_net()
    tm = _port_net(_init(jm), use_graph=use_graph)
    dev = tdevice.create_cpu_device(seed=0)
    tm.on_device(dev)
    x, y = _data()
    half = (x[:4], y[:4])
    jm.device.Reset()               # the JAX default device is shared
    dev.SetVerbosity(1)
    jm.device.SetVerbosity(1)
    try:
        for xb, yb in ((x, y), (x, y), half, (x, y)):
            tm.train_one_batch(xb, yb)
            jm.train_one_batch(jtensor.from_numpy(xb), jtensor.from_numpy(yb))
    finally:
        dev.SetVerbosity(0)
        jm.device.SetVerbosity(0)
    assert len(dev._step_times_ms) == 4 == len(jm.device._step_times_ms)
    assert all(t > 0 for t in dev._step_times_ms)
    tables = dev._cost_tables
    assert len(tables) == 2, list(tables)      # two input signatures
    for (B, _), cost in zip(((8, 0), (4, 0)), tables.values()):
        I, H, O = 12, 16, 4
        assert cost["flops"] == 4 * B * I * H + 6 * B * H * O, cost
        assert not any(k.startswith("launches") for k in cost)
    table = dev.PrintTimeProfiling()
    assert "compiled steps timed: 4" in table
    assert "TNet.train_one_batch[(8, 12) float32, (8,) int32]" in table
    assert "ctypes" in table
