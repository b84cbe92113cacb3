"""Snapshot / BinFile checkpoints of the port.  Counterpart:
``singa_tpu/snapshot.py`` (the reference's ``src/io/snapshot.cc``,
``binfile_reader.cc`` / ``binfile_writer.cc``).

A BinFile is a magic-framed record stream::

    [file magic "SGBF"][version u32]
    repeat: [record magic "RECD"][key_len u32][key utf-8]
            [val_len u32][val bytes]

framed here in Python (the reference's path without its native codec;
``singa_tpu/native/binfile.cc`` writes the same bytes), so a file the
port writes and one the JAX package writes from the same records are
byte for byte the same.  :class:`Snapshot` stores one ``TensorProto``
(:mod:`singa_tpu_torch.proto.core`, the port's own wire codec) a record,
keyed by the state's dotted name, as ``Model.save_states(...,
format="snapshot")`` names it, so a snapshot crosses between the two
packages by name.

Types: float32, float16, int32, int8, float64, uint8 and int64 numpy
arrays, as the reference; bool arrays are stored as uint8 (the proto has
no bool type; a restore casts to the live tensor's dtype).  numpy has no
bfloat16, so a ``kBFloat16`` record is carried as its uint16 bit
patterns: a bfloat16 ``torch.Tensor`` writes one, and reading one gives
a CPU ``torch.bfloat16`` tensor viewed from those bits (every other type
reads as a numpy array).

Every write is staged, fsynced and renamed into place
(:func:`atomic_publish`); a truncated, garbage or otherwise undecodable
file raises :class:`CorruptCheckpointError`.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .logging import CHECK
from .proto import core

__all__ = ["BinFileWriter", "BinFileReader", "Snapshot",
           "CorruptCheckpointError", "fsync_path", "atomic_publish",
           "FILE_MAGIC", "RECORD_MAGIC", "VERSION"]

FILE_MAGIC = b"SGBF"
RECORD_MAGIC = b"RECD"
VERSION = 1

_U32 = struct.Struct("<I")


class CorruptCheckpointError(ValueError):
    """A checkpoint failed an integrity check (truncated, garbage
    framing, bad magic, an undecodable record, a CRC mismatch); ``key``
    names the record when one is to blame.  Restore flows
    (``resilience.CheckpointManager``) catch it to fall back to the
    newest valid checkpoint."""

    def __init__(self, path: str, reason: str, key: str | None = None):
        self.path = path
        self.key = key
        at = f" (record {key!r})" if key else ""
        super().__init__(f"{path}: {reason}{at}")


def fsync_path(path: str) -> None:
    """fsync an already-written file by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_publish(tmp: str, final: str) -> None:
    """Durably publish ``tmp`` as ``final``: fsync the staged bytes, then
    rename over the previous version, so a crash leaves either the old
    complete file or the new one, never a truncated mix."""
    fsync_path(tmp)
    os.replace(tmp, final)


_NP_TO_DT = {
    np.dtype(np.float32): core.kFloat32,
    np.dtype(np.float16): core.kFloat16,
    np.dtype(np.int32): core.kInt,
    np.dtype(np.int8): core.kChar,
    np.dtype(np.float64): core.kDouble,
    np.dtype(np.uint8): core.kUChar,
    np.dtype(np.int64): core.kInt64,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}
_DT_TO_NP[core.kBFloat16] = np.dtype(np.uint16)    # bit patterns


class BinFileWriter:
    """Append (key, bytes) records to a magic-framed file (reference:
    ``BinFileWriter``).  Records buffer in memory and land at
    :meth:`close`, staged at ``path + ".tmp"`` and published
    atomically."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._records: list = []
        self._closed = False

    def write(self, key: str, value: bytes) -> None:
        if self._closed:
            raise ValueError("write to closed BinFileWriter")
        self._records.append((key, bytes(value)))

    def _write_all(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(FILE_MAGIC)
            f.write(_U32.pack(VERSION))
            for key, value in self._records:
                kb = key.encode("utf-8")
                f.write(RECORD_MAGIC)
                f.write(_U32.pack(len(kb)))
                f.write(kb)
                f.write(_U32.pack(len(value)))
                f.write(value)
        atomic_publish(tmp, self._path)

    def flush(self) -> None:
        """Persist everything buffered so far (rewrites the file)."""
        if not self._closed:
            self._write_all()

    def close(self) -> None:
        if self._closed:
            return
        self._write_all()
        self._closed = True
        self._records = []

    def __del__(self):  # an unclosed writer still persists its records
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BinFileReader:
    """Iterate (key, bytes) records (reference: ``BinFileReader``)."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "rb")
        try:
            magic = self._f.read(4)
            if magic != FILE_MAGIC:
                raise CorruptCheckpointError(
                    path, f"not a BinFile (magic {magic!r})")
            header = self._f.read(4)
            if len(header) != 4:
                raise CorruptCheckpointError(path,
                                             "truncated version header")
            (self.version,) = _U32.unpack(header)
            if self.version > VERSION:
                raise CorruptCheckpointError(
                    path, f"unsupported BinFile version {self.version}")
        except BaseException:
            self._f.close()
            raise

    def _u32(self, what: str, key: str | None) -> int:
        raw = self._f.read(4)
        if len(raw) != 4:
            raise CorruptCheckpointError(self._path, f"truncated {what}",
                                         key=key)
        return _U32.unpack(raw)[0]

    def __iter__(self):
        last_key = None
        while True:
            magic = self._f.read(4)
            if not magic:
                return
            if magic != RECORD_MAGIC:
                raise CorruptCheckpointError(
                    self._path, f"corrupt record framing: {magic!r}",
                    key=last_key)
            klen = self._u32("key length", last_key)
            kb = self._f.read(klen)
            if len(kb) != klen:
                raise CorruptCheckpointError(self._path,
                                             "truncated record key",
                                             key=last_key)
            try:
                key = kb.decode("utf-8")
            except UnicodeDecodeError as e:
                raise CorruptCheckpointError(
                    self._path, "garbage record key", key=last_key) from e
            last_key = key
            vlen = self._u32("value length", key)
            value = self._f.read(vlen)
            if len(value) != vlen:
                raise CorruptCheckpointError(self._path,
                                             "truncated record value",
                                             key=key)
            yield key, value

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(value):
    """A checkpoint value (numpy data, a ``torch.Tensor`` or a port
    ``Tensor``) as a host numpy array, or as a CPU bfloat16 tensor."""
    from .tensor import Tensor  # lazy: the tensor module imports devices
    if isinstance(value, Tensor):
        value = value.data
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return value if value.dtype == torch.bfloat16 else value.numpy()
    return np.asarray(value)


def _to_proto(value) -> core.TensorProto:
    arr = _host(value)
    if isinstance(arr, torch.Tensor):                  # bfloat16
        bits = arr.contiguous().view(torch.int16).numpy().view(np.uint16)
        return core.TensorProto(shape=list(arr.shape),
                                data_type=core.kBFloat16,
                                data=bits.tobytes())
    shape = list(np.shape(arr))  # before ascontiguousarray, which makes
    arr = np.ascontiguousarray(arr)  # a 0-d scalar of shape (1,)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise TypeError(f"unsupported checkpoint dtype {arr.dtype}")
    return core.TensorProto(shape=shape, data_type=dt, data=arr.tobytes())


def _from_proto(t: core.TensorProto):
    """The record's array: numpy, or a CPU bfloat16 tensor for
    ``kBFloat16``.  The typed fields are read where ``data`` is empty,
    in the reference's order.  A value count that does not fill the
    shape raises ``ValueError``."""
    if t.data_type not in _DT_TO_NP:
        raise ValueError(f"unknown data type {t.data_type}")
    dtype = _DT_TO_NP[t.data_type]
    bf16 = t.data_type == core.kBFloat16
    if t.data:
        if len(t.data) % dtype.itemsize:
            raise ValueError(f"{len(t.data)} data bytes are not a whole "
                             f"number of {dtype} values")
        arr = np.frombuffer(t.data, dtype=dtype)
    else:
        arr = None
        for values, src in ((t.float_data, np.float32),
                            (t.double_data, np.float64),
                            (t.int_data, np.int32)):
            if values:
                arr = np.asarray(values, src)
                break
        if arr is None:
            arr = np.zeros(0, np.float32)
        if bf16:    # round to bfloat16 bits, as ml_dtypes' astype does
            arr = torch.from_numpy(arr.astype(np.float32)).to(
                torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        else:
            arr = arr.astype(dtype)
    arr = arr.reshape(tuple(t.shape))
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def write_records(path: str, records: dict) -> None:
    """Write ``records`` (name -> array) as the BinFile ``path``, staged
    and published atomically; a record that does not encode writes
    nothing."""
    encoded = [(name, _to_proto(value).SerializeToString())
               for name, value in records.items()]
    w = BinFileWriter(path)
    for name, value in encoded:
        w.write(name, value)
    w.close()


def read_records(path: str) -> dict:
    """Every record of the BinFile ``path``: name -> array."""
    out = {}
    with BinFileReader(path) as r:
        for key, value in r:
            try:
                out[key] = _from_proto(core.TensorProto.FromString(value))
            except CorruptCheckpointError as e:
                raise CorruptCheckpointError(path, str(e), key=key) from e
            except (ValueError, TypeError) as e:
                raise CorruptCheckpointError(
                    path, f"undecodable TensorProto ({e})", key=key) from e
    return out


class Snapshot:
    """Name -> tensor record store (reference: ``singa::Snapshot`` via
    ``python/singa/snapshot.py``).

    >>> sn = Snapshot("ckpt", True)        # write mode, to ckpt.bin
    >>> sn.write("fc1.W", w); sn.done()
    >>> params = Snapshot("ckpt", False).read()   # {name: array}
    """

    SUFFIX = ".bin"

    def __init__(self, prefix: str, mode: bool):
        self.prefix = prefix
        self.mode = mode  # True = write (reference convention)
        self._writer = BinFileWriter(prefix + self.SUFFIX) if mode else None

    def write(self, name: str, tensor) -> None:
        CHECK(self.mode, "Snapshot opened for reading")
        self._writer.write(name, _to_proto(tensor).SerializeToString())

    def read(self) -> dict:
        CHECK(not self.mode, "Snapshot opened for writing")
        return read_records(self.prefix + self.SUFFIX)

    def done(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    close = done
