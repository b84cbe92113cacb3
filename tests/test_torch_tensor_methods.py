"""The port's Tensor (singa_tpu_torch.tensor.Tensor) against the JAX
package's on the CPU: metadata and conversions, indexing, the operators
(JAX's side under one ``jax.jit`` a test), no ``__eq__``; every
view-returning function followed by an in-place write to its input
(no result aliases it); the in-place methods keeping the buffer and the
leaf, and rebinding where the reference's dtype or shape changes; the
random fills.  Tolerances: see ``_torch_tensor_common``; random fills
differ from JAX's values (another generator), so their range, mean and
deviation are held over 20,000 draws (5 sigma bounds), and their
seeding: one seed, one sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tensor_common import (
    GRID, JDEV, TDEV, TDT, JCppCPU, _data, _hold, _pair, _rng, _same,
    _vals, jt, tdevice, tt)

torch.set_num_threads(1)


VIEWS = {
    "Reshape": lambda m, t: m.Reshape(t, (4, 3)),
    "Transpose": lambda m, t: m.Transpose(t),
    "Squeeze": lambda m, t: m.Squeeze(m.Unsqueeze(t, 0)),
    "Squeeze_none": lambda m, t: m.Squeeze(t),
    "Unsqueeze": lambda m, t: m.Unsqueeze(t, 1),
    "Flatten": lambda m, t: m.Flatten(t, 0),
    "Flatten_whole": lambda m, t: m.Flatten(t),
    "SliceOn": lambda m, t: m.SliceOn(t, 0, 2, 1),
    "CopyRows": lambda m, t: m.CopyRows(t, 0, 3),
    "CopyColumns": lambda m, t: m.CopyColumns(t, 1, 3),
    "Broadcast": lambda m, t: m.Broadcast(t, (3, 4)),
    "Broadcast_up": lambda m, t: m.Broadcast(t, (2, 3, 4)),
    "getitem_row": lambda m, t: t[1],
    "getitem_slice": lambda m, t: t[:, 1:3],
    "getitem_all": lambda m, t: t[...],
    "method_reshape": lambda m, t: t.reshape((2, 6)),
    "method_transpose": lambda m, t: t.transpose((1, 0)),
    "T": lambda m, t: t.T,
    "as_type_same": lambda m, t: t.as_type(m.float32),
    "clone": lambda m, t: t.clone(),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_results_do_not_alias_their_input(case):
    """``b = f(a)`` then an in-place write to ``a``: ``b`` keeps its
    values, as in the reference (whose arrays are immutable)."""
    arr = _data(_rng("views", case), "float32")
    j, t = _pair(arr, "float32")
    jb, tb = VIEWS[case](jt, j), VIEWS[case](tt, t)
    j += 1
    t += 1
    jt.Scale(2.0, j)
    tt.Scale(2.0, t)
    t.set_value(7.0)
    _same(jb, tb)
    assert tb.data.untyped_storage().data_ptr() != \
        t.data.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# Tensor methods, operators, mutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", GRID)
def test_tensor_metadata_and_conversions_match_jax(dtype):
    j, t = _pair(_data(_rng("meta", dtype), dtype, (2, 3, 4)), dtype)
    assert (t.ndim, t.size(), t.memsize(), t.is_empty(), len(t)) == \
        (j.ndim, j.size(), j.memsize(), j.is_empty(), len(j))
    empty = tt.Tensor(shape=(0, 3), device=TDEV)
    assert empty.is_empty() and len(empty) == 0 and empty.size() == 0
    for to in ("float32", "int32", "bool", "float64", "int64", "bfloat16"):
        jdt, tdt = getattr(jt, to) if to != "bool" else jt.bool_, \
            getattr(tt, to) if to != "bool" else tt.bool_
        _same(j.as_type(jdt), t.as_type(tdt))
    _same(j.T, t.T)
    _same(j.transpose((2, 0, 1)), t.transpose((2, 0, 1)))
    _same(j.reshape((6, 4)), t.reshape((6, 4)))
    c = t.clone()
    _same(j.clone(), c)    # the reference's data + 0: a bool's is int32
    assert c.dtype == (torch.int32 if dtype == "bool" else t.dtype)
    assert torch.equal(c.data, t.data.to(c.dtype))
    assert c.data.data_ptr() != t.data.data_ptr()


def test_to_host_goes_to_the_cpu_and_to_device_keeps_a_leaf():
    p = tt.Tensor(data=np.ones(3, np.float32), device=TDEV, stores_grad=True)
    leaf = p.data
    assert p.to_host() is p and p.device.lang == "cpp"
    assert p.data is leaf and p.data.is_leaf and p.data.requires_grad
    other = tdevice.create_cpu_device(seed=1)
    p.to_device(other)
    assert p.device is other and p.data is leaf


# the last five lie past an end of their (3, 4) axes: jnp clamps them
INDICES = ((1,), (slice(None), 2), (slice(0, 2), slice(1, 3)), (-1,),
           (np.array([0, 2]),), (Ellipsis, 1), (None, 0),
           (5,), (-5,), (slice(None), 9), (1, -9), (None, Ellipsis, 7))


@pytest.mark.parametrize("dtype", ("float32", "int32", "bool"))
def test_getitem_and_setitem_match_jax(dtype):
    rng = _rng("index", dtype)
    arr = _data(rng, dtype)
    for idx in INDICES:
        j, t = _pair(arr, dtype)
        _same(j[idx if len(idx) > 1 else idx[0]],
              t[idx if len(idx) > 1 else idx[0]])
    ji, ti = _pair(np.array([2, 0], np.int32), "int32")
    j, t = _pair(arr, dtype)
    _same(j[ji.data], t[ti])           # the port takes a Tensor index too
    # the last two write past an end: jnp drops the update
    for idx, value in (((0, 1), 5), ((slice(None), 0), 0.5),
                       ((1,), np.array([1, 0, 1, 0])), ((2, 3), True),
                       ((4,), 1), ((slice(None), -5), 0.5)):
        j, t = _pair(arr, dtype)
        ptr = t.data.data_ptr()
        j[idx] = value
        t[idx] = value
        _same(j, t)
        assert t.data.data_ptr() == ptr


OPERATORS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 2.7 - a,
    "rsub_int": lambda a, b: 3 - a,
    "mul": lambda a, b: a * b, "rmul": lambda a, b: 0.5 * a,
    "truediv": lambda a, b: a / b, "rtruediv": lambda a, b: 1 / a,
    "rtruediv_float": lambda a, b: 2.5 / a,
    "pow": lambda a, b: a ** 2, "pow_tensor": lambda a, b: a ** b,
    "neg": lambda a, b: -a, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= 0.5, "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= 1,
}


@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op):
    """Each operator on operands of every dtype of the grid."""
    arrays = []
    for d in GRID:
        rng = _rng("operator", op, d)
        arrays += [(_data(rng, d, lo=0.5, hi=2.0, ilo=1, ihi=4), d),
                   (_data(rng, d, lo=0.5, hi=1.5, ilo=0, ihi=3), d)]
    _hold(lambda m: {d: lambda ts, i=i: OPERATORS[op](ts[2 * i],
                                                      ts[2 * i + 1])
                     for i, d in enumerate(GRID)}, arrays)


def test_no_equality_operators_tensors_hash_by_identity():
    a = tt.Tensor(data=np.ones(2, np.float32), device=TDEV)
    b = tt.Tensor(data=np.ones(2, np.float32), device=TDEV)
    assert "__eq__" not in vars(tt.Tensor) and "__eq__" not in vars(jt.Tensor)
    assert a == a and a != b and len({a, b, a}) == 2
    assert {a: 1}[a] == 1


IN_PLACE = {
    "iadd": lambda m, t, o: t.__iadd__(o),
    "isub": lambda m, t, o: t.__isub__(o),
    "imul": lambda m, t, o: t.__imul__(o),
    "itruediv": lambda m, t, o: t.__itruediv__(o),
    "iadd_scalar": lambda m, t, o: t.__iadd__(0.25),
    "Axpy": lambda m, t, o: m.Axpy(0.5, o, t),
    "Scale": lambda m, t, o: m.Scale(1.5, t),
    "set_value": lambda m, t, o: t.set_value(0.25),
    "Fill": lambda m, t, o: m.Fill(t, -1.0),
    "copy_data": lambda m, t, o: t.copy_data(o),
    "copy_from_numpy": lambda m, t, o: t.copy_from_numpy(
        np.full((3, 4), 3.0)),
    "reset_like": lambda m, t, o: t.reset_like(o),
    "setitem": lambda m, t, o: t.__setitem__((slice(None), 1), 9.0),
    "AddColumn": lambda m, t, o: m.AddColumn(m.SliceOn(o, 0, 1, 1)
                                             .reshape((3,)), t),
    "SubColumn": lambda m, t, o: m.SubColumn(m.CopyColumns(o, 1, 2)
                                             .reshape((3,)), t),
    "MultColumn": lambda m, t, o: m.MultColumn(m.CopyColumns(o, 2, 3)
                                               .reshape((3,)), t),
    "DivColumn": lambda m, t, o: m.DivColumn(m.Abs(m.CopyColumns(o, 0, 1))
                                             .reshape((3,)) + 1, t),
    "AddRow": lambda m, t, o: m.AddRow(o[0], t),
    "SubRow": lambda m, t, o: m.SubRow(o[1], t),
    "MultRow": lambda m, t, o: m.MultRow(o[2], t),
    "DivRow": lambda m, t, o: m.DivRow(m.Abs(o[0]) + 1, t),
}


@pytest.mark.parametrize("case", list(IN_PLACE))
def test_in_place_methods_keep_the_buffer_and_the_leaf(case):
    """On a parameter (a float32 leaf that requires grad): the values
    JAX's rebinding gives, the same storage and the same leaf."""
    rng = _rng("inplace", case)
    arr, other = _data(rng, "float32"), _data(rng, "float32")
    jp = jt.Tensor(data=arr, device=JDEV, stores_grad=True)
    jo = jt.Tensor(data=other, device=JDEV)
    tp = tt.Tensor(data=arr, device=TDEV, stores_grad=True)
    to = tt.Tensor(data=other, device=TDEV)
    leaf, ptr = tp.data, tp.data.data_ptr()
    IN_PLACE[case](jt, jp, jo)
    IN_PLACE[case](tt, tp, to)
    _same(jp, tp)
    assert tp.data is leaf and tp.data.data_ptr() == ptr
    assert tp.data.is_leaf and tp.data.requires_grad


@pytest.mark.parametrize("case", ("iadd_half", "itruediv", "DivRow",
                                  "Axpy", "reset_like_shape", "imul_bf16"))
def test_mutation_rebinds_where_the_reference_changes_dtype_or_shape(case):
    arr = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jt_, tt_ = _pair(arr, "int32")
    jo, to = _pair(np.ones((2, 3), np.float32) * 0.5, "float32")
    jr, tr = _pair(np.arange(3, dtype=np.int32) + 1, "int32")
    if case == "iadd_half":
        jt_ += 0.5
        tt_ += 0.5
    elif case == "itruediv":
        jt_ /= 2
        tt_ /= 2
    elif case == "DivRow":
        jt.DivRow(jr, jt_)
        tt.DivRow(tr, tt_)
    elif case == "Axpy":
        jt.Axpy(0.5, jo, jt_)
        tt.Axpy(0.5, to, tt_)
    elif case == "reset_like_shape":
        jt_.reset_like(jr)
        tt_.reset_like(tr)
    else:
        jt_ *= jt.Tensor(data=jnp.ones((2, 3), jnp.bfloat16), device=JDEV)
        tt_ *= tt.Tensor(data=torch.ones((2, 3), dtype=torch.bfloat16),
                         device=TDEV)
    _same(jt_, tt_)


def test_iadd_on_a_parameter_keeps_it_the_trained_leaf():
    """``W += d`` on a compiled model's parameter: the same leaf, and the
    next training step still reaches it (its gradient and update)."""
    from singa_tpu_torch import autograd as tautograd
    from singa_tpu_torch import layer as tlayer
    from singa_tpu_torch import opt as topt
    from singa_tpu_torch.model import Model

    class Net(Model):
        def __init__(self):
            super().__init__()
            self.fc = tlayer.Linear(3)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = tautograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    rng = _rng("iadd_param")
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.int32)
    m = Net()
    m.set_optimizer(topt.SGD(lr=0.1))
    m.compile([tt.Tensor(data=x, device=TDEV)], is_train=True,
              use_graph=True)
    W = m.fc.W
    leaf = W.data
    W += 0.5
    after_iadd = W.data.detach().clone()
    assert W.data is leaf and leaf.is_leaf and leaf.requires_grad
    m.train_one_batch(x, y)
    assert W.data is leaf and not torch.equal(W.data, after_iadd)


# ---------------------------------------------------------------------------
# random fills
# ---------------------------------------------------------------------------

N_DRAWS = 20_000


@pytest.mark.parametrize("fill", ("Uniform", "uniform", "Gaussian",
                                  "gaussian", "Bernoulli", "bernoulli"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int32"))
def test_random_fills_statistics_and_seeding(fill, dtype):
    def draw(seed):
        dev = tdevice.create_cpu_device(seed=seed)
        t = tt.Tensor(shape=(N_DRAWS,), dtype=TDT[dtype], device=dev)
        leaf_ptr = t.data.data_ptr()
        args = {"uniform": (-1.0, 3.0), "gaussian": (0.5, 2.0),
                "bernoulli": (0.3,)}[fill.lower()]
        out = getattr(tt, fill)(*args, t) if fill[0].isupper() \
            else getattr(t, fill)(*args)
        assert out is t and t.data.data_ptr() == leaf_ptr
        assert t.dtype == TDT[dtype] and t.shape == (N_DRAWS,)
        return t.data.double()

    x = draw(5)
    assert torch.equal(x, draw(5)) and not torch.equal(x, draw(6))
    mean, std = float(x.mean()), float(x.std())
    if fill.lower() == "uniform":
        if dtype == "int32":         # float32 draws truncated toward 0
            assert set(x.unique().tolist()) <= {0.0, 1.0, 2.0}
            return
        assert -1.0 <= float(x.min()) and float(x.max()) <= 3.0
        assert abs(mean - 1.0) < 5 * 4 / np.sqrt(12 * N_DRAWS)
        assert abs(std - 4 / np.sqrt(12)) < 0.03
    elif fill.lower() == "gaussian":
        if dtype == "int32":
            return
        assert abs(mean - 0.5) < 5 * 2.0 / np.sqrt(N_DRAWS)
        assert abs(std - 2.0) < 0.05
    else:
        assert set(x.unique().tolist()) <= {0.0, 1.0}
        assert abs(mean - 0.3) < 5 * np.sqrt(0.21 / N_DRAWS)


def test_random_fill_dtypes_and_shapes_match_jax():
    for fill, args in (("Uniform", (0.0, 1.0)), ("Gaussian", (0.0, 1.0)),
                       ("Bernoulli", (0.5,))):
        for dtype in ("float32", "int32", "bool"):
            j, t = _pair(np.zeros((2, 3), np.float32), dtype)
            jr = getattr(jt, fill)(*args, j)
            tr = getattr(tt, fill)(*args, t)
            assert _vals(jr)[0] == _vals(tr)[0] and jr.shape == tr.shape


def test_device_rng_state_round_trip_repeats_the_draws():
    dev = tdevice.create_cpu_device(seed=3)
    t = tt.Tensor(shape=(64,), device=dev)
    state = dev.get_rng_state()
    a = t.gaussian().data.clone()
    dev.set_rng_state(state)
    assert torch.equal(t.gaussian().data, a)
    jdev = JCppCPU(seed=3)
    jtt = jt.Tensor(shape=(64,), device=jdev)
    jstate = jdev.get_rng_state()
    ja = np.asarray(jtt.gaussian().data)
    jdev.set_rng_state(jstate)
    np.testing.assert_array_equal(np.asarray(jtt.gaussian().data), ja)
