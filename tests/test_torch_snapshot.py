"""The port's protobuf codec, Snapshot/BinFile format and snapshot
checkpoints (singa_tpu_torch.proto, singa_tpu_torch.snapshot,
Model.save_states(format="snapshot")) against the JAX package's on the
CPU, case for case with ``tests/test_snapshot.py``.

* ``TensorProto``: the port's bytes equal ``core_pb2``'s
  ``SerializeToString`` for every ``DataType``, 0-d, empty, bool and
  odd shapes and the typed fields; each side decodes the other's bytes;
  unpacked repeated fields, the typed fallbacks and unknown fields read
  as ``core_pb2`` reads them (the oracle for hand-built bytes); every
  truncation and seeded garbage either raises ``CorruptCheckpointError``
  or decodes as ``core_pb2`` does, and a Snapshot never returns an array
  its record does not fill.
* BinFile: the same records give the same file bytes in both packages.
* Checkpoints: a JAX-written snapshot or zip loads into the port, and the
  port's into JAX, on the MNIST CNN of the zoo, a Conv-BatchNorm net and
  the MLP, with the optimizer's momenta and the BatchNorm buffers: every
  state exact; one more step on each side within 1e-5 (float32, the
  local compute's order only)."""

import os
import struct
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples", "cnn"))

from singa_tpu import autograd as jautograd  # noqa: E402
from singa_tpu import layer as jlayer  # noqa: E402
from singa_tpu import opt as jopt  # noqa: E402
from singa_tpu import snapshot as jsnap  # noqa: E402
from singa_tpu import tensor as jtensor  # noqa: E402
from singa_tpu.model import Model as JModel  # noqa: E402
from singa_tpu.proto import core_pb2  # noqa: E402
from singa_tpu_torch import autograd as tautograd  # noqa: E402
from singa_tpu_torch import layer as tlayer  # noqa: E402
from singa_tpu_torch import opt as topt  # noqa: E402
from singa_tpu_torch import snapshot as tsnap  # noqa: E402
from singa_tpu_torch.model import Model as TModel  # noqa: E402
from singa_tpu_torch.proto import core, wire  # noqa: E402
from singa_tpu_torch.snapshot import (BinFileReader, BinFileWriter,  # noqa
                                      CorruptCheckpointError, Snapshot)
from singa_tpu_torch.tensor import Tensor  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


# ---- TensorProto ------------------------------------------------------------

def _arrays():
    """One array a DataType, and 0-d, empty, bool and odd shapes."""
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "f16": rng.randn(7).astype(np.float16),
        "i32": rng.randint(-300, 300, (2, 3, 4)).astype(np.int32),
        "i8": rng.randint(-128, 127, (5,)).astype(np.int8),
        "f64": rng.randn(1, 129).astype(np.float64),
        "u8": rng.randint(0, 255, (3, 1, 2)).astype(np.uint8),
        "bf16": rng.randn(4, 3).astype(ml_dtypes.bfloat16),
        "i64": np.arange(-3, 5, dtype=np.int64).reshape(2, 4),
        "scalar": np.asarray(2.5, np.float32),
        "scalar_i64": np.asarray(7),
        "empty": np.zeros((0, 3), np.float32),
        "bool": rng.rand(2, 3) < 0.5,
        "odd": rng.randn(1, 1, 300, 1).astype(np.float32),
    }


def _port_value(arr):
    """What the port writes for a JAX-side array: a bfloat16 tensor for
    ml_dtypes bfloat16, the array itself otherwise."""
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).bfloat16()
    return arr


def _as_numpy(got):
    if isinstance(got, torch.Tensor):
        return got.float().numpy()
    return got


@pytest.mark.parametrize("name", list(_arrays()))
def test_tensor_proto_bytes_equal_core_pb2(name):
    arr = _arrays()[name]
    want = jsnap._to_proto(arr).SerializeToString()
    got = tsnap._to_proto(_port_value(arr)).SerializeToString()
    assert got == want
    # each side decodes the other's bytes
    mine = core.TensorProto.FromString(want)
    theirs = core_pb2.TensorProto.FromString(got)
    assert (list(theirs.shape), theirs.data_type, theirs.data) == \
        (mine.shape, mine.data_type, mine.data)
    back = tsnap._from_proto(mine)
    ref = jsnap._from_proto(theirs)
    assert back.shape == ref.shape
    np.testing.assert_array_equal(_as_numpy(back), ref.astype(
        np.float32) if ref.dtype == ml_dtypes.bfloat16 else ref)
    if arr.dtype != ml_dtypes.bfloat16:
        assert back.dtype == ref.dtype


@pytest.mark.parametrize("dt", range(core.kNumDataType))
def test_every_data_type_and_typed_field_serializes_as_core_pb2(dt):
    """Every enum value (the same numbers as core.proto's) with shape,
    data and the typed fields, negative int32s included; the example
    of the codec's docstring; an all-default message is empty."""
    assert getattr(core.DataType, core_pb2.DataType.Name(dt)) == dt
    kw = dict(shape=[2, 300, 0, 4294967295], data_type=dt, data=b"ab",
              float_data=[1.5, -2.0, 3e38], int_data=[-3, 7, -2 ** 31],
              double_data=[1e300, -0.5])
    want = core_pb2.TensorProto(**kw).SerializeToString()
    assert core.TensorProto(**kw).SerializeToString() == want
    got, ref = core.TensorProto.FromString(want), \
        core_pb2.TensorProto.FromString(want)
    assert got == core.TensorProto(
        shape=ref.shape, data_type=ref.data_type, data=ref.data,
        float_data=ref.float_data, int_data=ref.int_data,
        double_data=ref.double_data)
    assert core.TensorProto(shape=[2, 300], data_type=core.kBFloat16,
                            data=b"ab").SerializeToString() == \
        b"\n\x03\x02\xac\x02\x10\x06\x1a\x02ab"
    assert core.TensorProto(shape=[], data_type=core.kFloat32
                            ).SerializeToString() == b""


def _key(field, wt):
    return bytes([field << 3 | wt])


HAND_BUILT = {
    # shape unpacked, one varint a value; data_type after data
    "unpacked_shape": (_key(1, 0) + b"\x02" + _key(1, 0) + b"\x03"
                       + _key(3, 2) + b"\x18" + bytes(24)
                       + _key(2, 0) + b"\x00"),
    # float_data unpacked (I32 fields), no data: the float fallback
    "unpacked_floats": (_key(1, 2) + b"\x01\x03"
                        + b"".join(_key(4, 5) + struct.pack("<f", v)
                                   for v in (1.5, -2.0, 0.25))),
    # double_data unpacked, kDouble
    "unpacked_doubles": (_key(1, 0) + b"\x02" + _key(2, 0) + b"\x04"
                         + b"".join(_key(6, 1) + struct.pack("<d", v)
                                    for v in (1e300, -3.0))),
    # int_data packed with a negative value, kInt
    "packed_ints": (_key(1, 0) + b"\x02" + _key(2, 0) + b"\x02"
                    + _key(5, 2) + bytes([11])
                    + wire.varint(-5) + b"\x07"),
    # int_data unpacked into a kChar tensor
    "unpacked_ints_char": (_key(1, 0) + b"\x02" + _key(2, 0) + b"\x03"
                           + _key(5, 0) + wire.varint(-1)
                           + _key(5, 0) + b"\x05"),
    # float_data into kBFloat16 (rounded as ml_dtypes rounds)
    "floats_to_bf16": (_key(1, 0) + b"\x02" + _key(2, 0) + b"\x06"
                       + _key(4, 2) + b"\x08"
                       + struct.pack("<2f", 1.00390625, -3.3)),
    # unknown fields of every wire type, skipped
    "unknown_fields": (_key(9, 0) + b"\x96\x01" + _key(10, 2) + b"\x02zz"
                       + _key(11, 5) + b"abcd" + _key(12, 1) + bytes(8)
                       + _key(1, 0) + b"\x01" + _key(3, 2) + b"\x04"
                       + struct.pack("<f", 7.0)),
}


@pytest.mark.parametrize("case", list(HAND_BUILT))
def test_decoder_reads_what_core_pb2_reads(case):
    raw = HAND_BUILT[case]
    want = core_pb2.TensorProto.FromString(raw)
    got = core.TensorProto.FromString(raw)
    assert got.shape == list(want.shape)
    assert got.data_type == want.data_type and got.data == want.data
    assert got.int_data == list(want.int_data)
    np.testing.assert_array_equal(np.float32(got.float_data),
                                  np.float32(want.float_data))
    assert got.double_data == list(want.double_data)
    ref = jsnap._from_proto(want)
    arr = tsnap._from_proto(got)
    if ref.dtype == ml_dtypes.bfloat16:
        assert arr.dtype == torch.bfloat16
        np.testing.assert_array_equal(arr.float().numpy(),
                                      ref.astype(np.float32))
    else:
        assert arr.dtype == ref.dtype
        np.testing.assert_array_equal(arr, ref)


def _agrees_or_raises(raw):
    """The port raises CorruptCheckpointError, or decodes ``raw`` as
    core_pb2 does."""
    try:
        got = core.TensorProto.FromString(raw)
    except CorruptCheckpointError:
        return "raised"
    want = core_pb2.TensorProto.FromString(raw)
    assert (got.shape, got.data_type, got.data, got.int_data,
            got.double_data) == (list(want.shape), want.data_type,
                                 want.data, list(want.int_data),
                                 list(want.double_data))
    return "decoded"


def test_truncated_and_garbage_bytes_raise_or_decode_as_core_pb2():
    full = core_pb2.TensorProto(
        shape=[3, 700], data_type=core.kInt64, data=bytes(range(64)),
        float_data=[1.0, 2.0], int_data=[-9, 300], double_data=[4.0]
    ).SerializeToString()
    seen = {"raised": 0, "decoded": 0}
    for n in range(len(full)):
        seen[_agrees_or_raises(full[:n])] += 1
    rng = np.random.RandomState(7)
    for _ in range(300):
        seen[_agrees_or_raises(rng.bytes(rng.randint(1, 40)))] += 1
    assert seen["raised"] > 100 and seen["decoded"] > 5, seen
    for raw in (b"\x0b", b"\xff" * 11, b"\x00", b"\x1a\x05ab",
                b"\x12\x01\x00", b"\x25\x01\x02"):
        with pytest.raises(CorruptCheckpointError):
            core.TensorProto.FromString(raw)


def test_snapshot_never_returns_an_array_its_record_does_not_fill(tmp_path):
    prefix = str(tmp_path / "bad")
    w = BinFileWriter(prefix + ".bin")
    w.write("short", core.TensorProto(shape=[2, 3], data=bytes(20)
                                      ).SerializeToString())
    w.close()
    with pytest.raises(CorruptCheckpointError, match="short"):
        Snapshot(prefix, False).read()
    for name, proto in (("ragged", core.TensorProto(shape=[2], data=b"abc")),
                        ("no_data", core.TensorProto(shape=[4])),
                        ("bad_type", core.TensorProto(shape=[1],
                                                      data_type=11,
                                                      data=b"abcd"))):
        w = BinFileWriter(prefix + ".bin")
        w.write(name, proto.SerializeToString())
        w.close()
        with pytest.raises(CorruptCheckpointError, match=name):
            Snapshot(prefix, False).read()


# ---- BinFile ------------------------------------------------------------------

def test_binfile_roundtrip(tmp_path):
    records = [("a", b"hello"), ("b/deep.key", b"\x00\x01\x02" * 100),
               ("empty", b"")]
    with BinFileWriter(str(tmp_path / "f.bin")) as w:
        for k, v in records:
            w.write(k, v)
    with BinFileReader(str(tmp_path / "f.bin")) as r:
        assert list(r) == records
    with jsnap.BinFileWriter(str(tmp_path / "j.bin")) as w:
        for k, v in records:
            w.write(k, v)
    assert (tmp_path / "f.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert not os.path.exists(tmp_path / "f.bin.tmp")


def test_binfile_rejects_bad_magic_and_truncation(tmp_path):
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(b"NOPE\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="magic"):
        BinFileReader(path)
    with BinFileWriter(str(tmp_path / "ok.bin")) as w:
        w.write("key", b"value" * 10)
    full = (tmp_path / "ok.bin").read_bytes()
    for n in range(4, len(full)):
        (tmp_path / "cut.bin").write_bytes(full[:n])
        if n == 8:        # the header alone: an empty stream
            assert list(BinFileReader(str(tmp_path / "cut.bin"))) == []
            continue
        with pytest.raises(CorruptCheckpointError):
            list(BinFileReader(str(tmp_path / "cut.bin")))


def test_snapshot_tensor_roundtrip_and_bytes_equal_jax(tmp_path):
    arrays = _arrays()
    jsn = jsnap.Snapshot(str(tmp_path / "jax"), True)
    tsn = Snapshot(str(tmp_path / "port"), True)
    for k, v in arrays.items():
        jsn.write(k, v)
        tsn.write(k, _port_value(v))
    jsn.done()
    tsn.done()
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    got = Snapshot(str(tmp_path / "jax"), False).read()
    back = jsnap.Snapshot(str(tmp_path / "port"), False).read()
    assert set(got) == set(back) == set(arrays)
    for k, v in arrays.items():
        want = v.astype(np.uint8) if v.dtype == np.bool_ else v
        if v.dtype == ml_dtypes.bfloat16:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          v.astype(np.float32))
        else:
            assert got[k].dtype == want.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], want)
        assert back[k].dtype == want.dtype
        np.testing.assert_array_equal(back[k], want)


def test_snapshot_writes_port_tensors_and_torch_tensors(tmp_path):
    t = Tensor(data=np.arange(6, dtype=np.float32).reshape(2, 3),
               device="cpu")
    sn = Snapshot(str(tmp_path / "s"), True)
    sn.write("t", t)
    sn.write("raw", torch.ones(2, dtype=torch.int64))
    sn.done()
    got = jsnap.Snapshot(str(tmp_path / "s"), False).read()
    np.testing.assert_array_equal(got["t"], t.numpy())
    assert got["raw"].dtype == np.int64
    with pytest.raises(TypeError, match="unsupported"):
        Snapshot(str(tmp_path / "u"), True).write("u", np.zeros(2,
                                                                np.uint16))


# ---- checkpoints ------------------------------------------------------------

class _JSmallCNN(JModel):
    def __init__(self):
        super().__init__()
        self.conv = jlayer.Conv2d(4, 3, padding=1)
        self.bn = jlayer.BatchNorm2d()
        self.relu = jlayer.ReLU()
        self.flat = jlayer.Flatten()
        self.fc = jlayer.Linear(2)

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = jautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


class _TSmallCNN(TModel):
    def __init__(self):
        super().__init__()
        self.conv = tlayer.Conv2d(4, 3, padding=1)
        self.bn = tlayer.BatchNorm2d()
        self.relu = tlayer.ReLU()
        self.flat = tlayer.Flatten()
        self.fc = tlayer.Linear(2)

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = tautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


class _JMLP(JModel):
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


class _TMLP(TModel):
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


def _zoo_cnn(side):
    if side == "jax":
        from model import cnn
        return cnn.create_model(num_classes=10, num_channels=1)
    from singa_tpu_torch.examples.cnn.model import cnn
    return cnn.create_model(num_classes=10, num_channels=1)


MODELS = {  # name -> (JAX model, port model, input shape, classes)
    "zoo_cnn": (lambda: _zoo_cnn("jax"), lambda: _zoo_cnn("port"),
                (4, 1, 28, 28), 10),
    "conv_bn": (_JSmallCNN, _TSmallCNN, (4, 3, 8, 8), 2),
    "mlp": (_JMLP, _TMLP, (8, 12), 4),
}


def _batch(name, seed=0):
    _, _, shape, classes = MODELS[name]
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, classes, shape[0]).astype(np.int32))


def _jax_model(name, seed=0):
    np.random.seed(seed)
    m = MODELS[name][0]()
    m.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    m.compile([jtensor.from_numpy(_batch(name)[0])], is_train=True,
              use_graph=True)
    return m


def _port_model(name, seed=0):
    torch.manual_seed(seed)
    m = MODELS[name][1]()
    m.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    m.compile([Tensor(data=_batch(name)[0], device="cpu")], is_train=True,
              use_graph=True)
    return m


def _jstates(m):
    out = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def _tstates(m):
    out = {k: v.numpy() for k, v in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def _jstep(m, name, seed):
    x, y = _batch(name, seed)
    return float(m.train_one_batch(jtensor.from_numpy(x),
                                   jtensor.from_numpy(y))[1].data)


def _tstep(m, name, seed):
    return m.train_one_batch(*_batch(name, seed))[1].item()


@pytest.mark.parametrize("fmt", ["snapshot", "zip"])
@pytest.mark.parametrize("name", list(MODELS))
def test_checkpoints_cross_both_ways_with_jax(tmp_path, name, fmt):
    """A JAX-written checkpoint loads into the port and the port's into
    JAX: every state (parameters, BatchNorm buffers, momenta, the step
    counter) exact, the aux states back, and one more step on each side
    within ATOL."""
    path = str(tmp_path / ("ck.zip" if fmt == "zip" else "ck"))
    jm = _jax_model(name)
    for s in range(2):
        _jstep(jm, name, s)
    jm.save_states(path, aux_states={"epoch": np.asarray(3)}, format=fmt)
    tm = _port_model(name, seed=1)
    aux = tm.load_states(path)
    assert int(np.asarray(aux["epoch"])) == 3
    js, ts = _jstates(jm), _tstates(tm)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    np.testing.assert_allclose(_tstep(tm, name, 2), _jstep(jm, name, 2),
                               rtol=0, atol=ATOL)

    for s in range(3, 5):
        _tstep(tm, name, s)
    path2 = str(tmp_path / ("port.zip" if fmt == "zip" else "port"))
    tm.save_states(path2, aux_states={"seen": np.arange(3)}, format=fmt)
    jm2 = _jax_model(name, seed=5)
    aux = jm2.load_states(path2)
    np.testing.assert_array_equal(aux["seen"], np.arange(3))
    js, ts = _jstates(jm2), _tstates(tm)
    assert set(js) == set(ts)
    for k in ts:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    np.testing.assert_allclose(_jstep(jm2, name, 5), _tstep(tm, name, 5),
                               rtol=0, atol=ATOL)


def test_model_snapshot_format_roundtrip_incl_bn_buffers(tmp_path):
    m = _port_model("conv_bn")
    for s in range(3):
        _tstep(m, "conv_bn", s)
    path = str(tmp_path / "ck")
    m.save_states(path, aux_states={"epoch": np.asarray(3)},
                  format="snapshot")
    assert os.path.exists(path + ".bin")
    before = _tstates(m)
    assert {"bn.running_mean", "bn.running_var"} <= set(before)
    for t in m.get_states().values():
        with torch.no_grad():
            t.data.zero_()
    aux = m.load_states(path)
    assert int(np.asarray(aux["epoch"]).item()) == 3
    after = _tstates(m)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_snapshot_cross_model_load_by_name(tmp_path):
    m = _port_model("conv_bn")
    _tstep(m, "conv_bn", 0)
    path = str(tmp_path / "ck")
    m.save_states(path, format="snapshot")
    fc_w = m.get_states()["fc.W"].numpy()

    class Bigger(_TSmallCNN):
        def __init__(self):
            super().__init__()
            self.extra = tlayer.Linear(5)  # not in the checkpoint

    m2 = Bigger()
    m2.set_optimizer(topt.SGD(lr=0.05))
    m2.compile([Tensor(data=_batch("conv_bn")[0], device="cpu")],
               is_train=False)
    m2.load_states(path)  # matching names restore, extras stay
    np.testing.assert_array_equal(m2.get_states()["fc.W"].numpy(), fc_w)


def test_zip_vs_snapshot_equivalence(tmp_path):
    m = _port_model("conv_bn")
    for s in range(2):
        _tstep(m, "conv_bn", s)
    m.save_states(str(tmp_path / "ck.zip"))
    m.save_states(str(tmp_path / "ck_snap"), format="snapshot")
    m1, m2 = _port_model("conv_bn", seed=2), _port_model("conv_bn", seed=3)
    m1.load_states(str(tmp_path / "ck.zip"))
    m2.load_states(str(tmp_path / "ck_snap"))  # told apart by the magic
    a, b = _tstates(m1), _tstates(m2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_save_states_rejects_unknown_format(tmp_path):
    m = _port_model("mlp")
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        m.save_states(str(tmp_path / "x"), format="Orbax")


@pytest.mark.parametrize("fmt", ["zip", "snapshot"])
def test_states_file_layout_reads_back_by_magic_and_refuses_truncation(
        tmp_path, fmt):
    """``Model``'s one writer and reader of the checkpoint layout (shared
    by ``save_states`` and ``CheckpointManager``): states and aux come
    back exact from a file of any name, the format from its magic word;
    a truncated file raises ``CorruptCheckpointError`` in either
    format."""
    rng = np.random.RandomState(1)
    states = {"conv.W": rng.randn(4, 3, 3, 3).astype(np.float32),
              "opt.conv.W:momentum": rng.randn(4, 3, 3, 3).astype(
                  np.float32),
              "opt.step_counter": np.asarray(3, np.int32)}
    aux = {"epoch": np.asarray(2, np.int32)}
    path = str(tmp_path / "states")          # no suffix
    TModel._write_states_file(path, fmt, states, aux)
    got_states, got_aux = TModel._read_states_file(path)
    assert sorted(got_states) == sorted(states)
    assert list(got_aux) == ["epoch"]
    for name, want in list(states.items()) + list(aux.items()):
        got = got_states.get(name, got_aux.get(name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CorruptCheckpointError):
        TModel._read_states_file(path)
