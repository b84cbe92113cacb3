"""Protobuf schemas of the port (counterpart: ``singa_tpu/proto/``), on
a wire codec of its own in the standard library (:mod:`.wire`) instead
of generated ``google.protobuf`` code: :mod:`.core`'s ``TensorProto``
and ``DataType`` (``core.proto``), which the Snapshot checkpoints store.
The ONNX subset belongs to a later slice (ROADMAP.md queue 1, item 12b).
"""

from . import core, wire  # noqa: F401
from .core import DataType, TensorProto  # noqa: F401

__all__ = ["core", "wire", "DataType", "TensorProto"]
