"""``TensorProto`` and ``DataType`` of ``singa_tpu/proto/core.proto``
(package ``singa_tpu.core``, proto3), on the wire codec of
:mod:`.wire` instead of generated ``google.protobuf`` code.

``SerializeToString`` gives the bytes ``core_pb2``'s does: fields in
number order, a field equal to its default (an empty list, 0, ``b""``)
omitted, the repeated scalars packed.  ``ParseFromString`` /
``FromString`` read those bytes and also unpacked repeated fields, the
typed ``float_data``/``int_data``/``double_data`` fields, and skip
fields of other numbers; truncated or garbage bytes, and a known field
on the wrong wire type, raise
:class:`~singa_tpu_torch.snapshot.CorruptCheckpointError`.
"""

from __future__ import annotations

import struct

from . import wire

__all__ = ["DataType", "TensorProto", "kFloat32", "kFloat16", "kInt",
           "kChar", "kDouble", "kUChar", "kBFloat16", "kInt64",
           "kNumDataType"]


class DataType:
    """The enum's values (core.proto), as ``core_pb2`` exposes them."""
    kFloat32 = 0
    kFloat16 = 1
    kInt = 2
    kChar = 3
    kDouble = 4
    kUChar = 5
    kBFloat16 = 6
    kInt64 = 7
    kNumDataType = 8


kFloat32, kFloat16, kInt, kChar = (DataType.kFloat32, DataType.kFloat16,
                                   DataType.kInt, DataType.kChar)
kDouble, kUChar, kBFloat16, kInt64, kNumDataType = (
    DataType.kDouble, DataType.kUChar, DataType.kBFloat16, DataType.kInt64,
    DataType.kNumDataType)


def _corrupt(reason: str):
    from ..snapshot import CorruptCheckpointError  # the port's error type
    return CorruptCheckpointError("<TensorProto>", reason)


class TensorProto:
    """``message TensorProto { repeated uint32 shape = 1; DataType
    data_type = 2; bytes data = 3; repeated float float_data = 4;
    repeated int32 int_data = 5; repeated double double_data = 6; }``"""

    __slots__ = ("shape", "data_type", "data", "float_data", "int_data",
                 "double_data")

    def __init__(self, shape=(), data_type: int = kFloat32,
                 data: bytes = b"", float_data=(), int_data=(),
                 double_data=()):
        self.shape = [int(s) for s in shape]
        self.data_type = int(data_type)
        self.data = bytes(data)
        self.float_data = [float(v) for v in float_data]
        self.int_data = [int(v) for v in int_data]
        self.double_data = [float(v) for v in double_data]

    def SerializeToString(self) -> bytes:
        out = []
        if self.shape:
            out.append(wire.packed_varints(1, self.shape))
        if self.data_type:
            out.append(wire.field_varint(2, self.data_type))
        if self.data:
            out.append(wire.field_bytes(3, self.data))
        if self.float_data:
            out.append(wire.packed_floats(4, self.float_data))
        if self.int_data:
            out.append(wire.packed_varints(5, self.int_data))
        if self.double_data:
            out.append(wire.packed_doubles(6, self.double_data))
        return b"".join(out)

    def ParseFromString(self, buf) -> int:
        """Replace every field with the message in ``buf``; returns its
        length (as ``core_pb2``'s)."""
        self.__init__()
        try:
            for field, wt, value in wire.iter_fields(buf):
                self._merge(field, wt, value)
        except wire.DecodeError as e:
            raise _corrupt(str(e)) from e
        except struct.error as e:
            raise _corrupt(f"bad fixed-width value ({e})") from e
        return len(buf)

    @classmethod
    def FromString(cls, buf) -> "TensorProto":
        t = cls()
        t.ParseFromString(buf)
        return t

    def _merge(self, field, wt, value) -> None:
        if field == 1:
            self.shape += [v & 0xFFFFFFFF for v in
                           _repeated(wt, value, wire.VARINT,
                                     wire.unpack_varints)]
        elif field == 2:
            _expect(wt, wire.VARINT, field)
            self.data_type = wire.as_int32(value)
        elif field == 3:
            _expect(wt, wire.LEN, field)
            self.data = bytes(value)
        elif field == 4:
            self.float_data += _repeated(
                wt, value, wire.I32, wire.unpack_floats,
                lambda raw: struct.unpack("<f", raw)[0])
        elif field == 5:
            self.int_data += [wire.as_int32(v) for v in
                              _repeated(wt, value, wire.VARINT,
                                        wire.unpack_varints)]
        elif field == 6:
            self.double_data += _repeated(
                wt, value, wire.I64, wire.unpack_doubles,
                lambda raw: struct.unpack("<d", raw)[0])
        # any other field number: an unknown field, skipped

    def __eq__(self, other):
        return isinstance(other, TensorProto) and all(
            getattr(self, f) == getattr(other, f) for f in self.__slots__)

    def __repr__(self):
        return (f"TensorProto(shape={self.shape}, data_type={self.data_type},"
                f" data=<{len(self.data)} bytes>)")


def _expect(wt, want, field):
    if wt != want:
        raise wire.DecodeError(f"field {field} on wire type {wt}")


def _repeated(wt, value, scalar_wt, unpack, scalar=None) -> list:
    """A repeated scalar field's values: packed (length-delimited) or
    one unpacked element."""
    if wt == wire.LEN:
        return unpack(value)
    _expect(wt, scalar_wt, "repeated")
    return [value if scalar is None else scalar(value)]
