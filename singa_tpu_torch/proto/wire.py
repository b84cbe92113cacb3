"""The protobuf wire format in the standard library: the primitives a
message codec of the port is built from (:mod:`.core`'s ``TensorProto``;
an ONNX codec can reuse them).

Encoding: :func:`varint`, :func:`key` (field number and wire type),
:func:`field_varint`, :func:`field_bytes` (length-delimited),
:func:`packed_varints`, :func:`packed_floats` and :func:`packed_doubles`.
Negative ``int32``/``int64`` values encode as ten-byte two's-complement
varints, as protobuf's do.

Decoding: :func:`read_varint` and :func:`iter_fields`, which walks a
message's fields as ``(number, wire type, value)``: an int for a varint,
``I32`` and ``I64`` fields as their raw little-endian bytes, a
``memoryview`` for a length-delimited field.  :func:`unpack_varints`,
:func:`unpack_floats` and :func:`unpack_doubles` read a packed payload.
Truncated input, an overlong varint, a field number 0 and the group wire
types (3, 4) raise :class:`DecodeError`.
"""

from __future__ import annotations

import struct

__all__ = ["VARINT", "I64", "LEN", "I32", "DecodeError", "varint", "key",
           "field_varint", "field_bytes", "packed_varints", "packed_floats",
           "packed_doubles", "read_varint", "iter_fields", "unpack_varints",
           "unpack_floats", "unpack_doubles", "as_int32"]

VARINT, I64, LEN, I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Bytes that are not a well-formed protobuf message."""


def varint(n: int) -> bytes:
    """``n`` as a base-128 varint; a negative ``n`` as its 64-bit two's
    complement (ten bytes)."""
    n &= _MASK64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def key(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def field_varint(field: int, n: int) -> bytes:
    return key(field, VARINT) + varint(n)


def field_bytes(field: int, payload: bytes) -> bytes:
    return key(field, LEN) + varint(len(payload)) + bytes(payload)


def packed_varints(field: int, values) -> bytes:
    return field_bytes(field, b"".join(varint(int(v)) for v in values))


def packed_floats(field: int, values) -> bytes:
    values = list(values)
    return field_bytes(field, struct.pack(f"<{len(values)}f", *values))


def packed_doubles(field: int, values) -> bytes:
    values = list(values)
    return field_bytes(field, struct.pack(f"<{len(values)}d", *values))


def read_varint(buf, pos: int) -> tuple[int, int]:
    """The varint at ``buf[pos:]`` and the position after it."""
    result = shift = 0
    for i in range(10):
        if pos + i >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos + i]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos + i + 1
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def iter_fields(buf):
    """``(field number, wire type, value)`` for every field of a
    message, in the order they were written."""
    buf = memoryview(buf)
    pos, n = 0, len(buf)
    while pos < n:
        k, pos = read_varint(buf, pos)
        field, wire = k >> 3, k & 7
        if field == 0:
            raise DecodeError("field number 0")
        if wire == VARINT:
            value, pos = read_varint(buf, pos)
        elif wire in (I64, I32):
            width = 8 if wire == I64 else 4
            if pos + width > n:
                raise DecodeError("truncated fixed-width field")
            value, pos = bytes(buf[pos:pos + width]), pos + width
        elif wire == LEN:
            size, pos = read_varint(buf, pos)
            if pos + size > n:
                raise DecodeError("truncated length-delimited field")
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise DecodeError(f"unsupported wire type {wire}")
        yield field, wire, value


def unpack_varints(payload) -> list:
    out, pos = [], 0
    while pos < len(payload):
        v, pos = read_varint(payload, pos)
        out.append(v)
    return out


def _unpack_fixed(payload, fmt: str, width: int) -> list:
    if len(payload) % width:
        raise DecodeError(f"packed payload of {len(payload)} bytes is not "
                          f"a multiple of {width}")
    return list(struct.unpack(f"<{len(payload) // width}{fmt}", payload))


def unpack_floats(payload) -> list:
    return _unpack_fixed(payload, "f", 4)


def unpack_doubles(payload) -> list:
    return _unpack_fixed(payload, "d", 8)


def as_int32(v: int) -> int:
    """A decoded varint as protobuf's ``int32`` reads it (the low 32
    bits, signed)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v
