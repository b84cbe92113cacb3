"""Tensors of the PyTorch/CUDA port.

Counterpart: ``singa_tpu/tensor.py`` — the ``Tensor`` class (:98) and
``from_numpy``.  A :class:`Tensor` wraps a
``torch.Tensor`` in ``.data`` on a :class:`~singa_tpu_torch.device.Device`
and carries the reference's autograd fields (``requires_grad``,
``stores_grad``, ``creator``) and a ``name``.  A tensor that stores its
gradient (a parameter) holds a ``torch`` leaf that requires grad, so the
autograd ops (:mod:`singa_tpu_torch.autograd`) record through
``torch.autograd``.

Unlike the JAX package's immutable arrays, ``.data`` is updated in place
where the reference mutates (``copy_from_numpy``, the optimizers), so a
parameter stays the same ``torch`` leaf for its whole life.  The ~100
reference-named free functions belong to a later slice.

Host data (numpy arrays, Python scalars) follows the JAX package's
32-bit default: float64 becomes float32 and int64 int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import Device, get_device

__all__ = ["Tensor", "from_numpy", "float32"]

float32 = torch.float32

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _host_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    return torch.tensor(a, device=device)


class Tensor:
    """N-d array on a :class:`Device` (reference ``python/singa/tensor.py``).

    ``device=None`` takes the device of ``data`` when it is a
    ``torch.Tensor``, and otherwise the CUDA card (raising without
    one).  ``stores_grad`` marks a parameter: its ``data`` becomes a
    ``torch`` leaf that requires grad."""

    __slots__ = ("data", "device", "requires_grad", "stores_grad", "creator",
                 "name")

    def __init__(self, shape=None, device: Device | None = None,
                 dtype=float32, data=None, requires_grad: bool = True,
                 stores_grad: bool = False, creator=None,
                 name: str | None = None):
        if isinstance(data, Tensor):
            data = data.data
        if device is None and isinstance(data, torch.Tensor):
            device = data.device
        self.device = get_device(device)
        tdev = self.device.torch_device
        if data is None:
            if shape is None:
                raise ValueError("Tensor needs shape or data")
            arr = torch.zeros(tuple(shape), dtype=dtype, device=tdev)
        elif isinstance(data, torch.Tensor):
            arr = data if data.device == tdev else data.to(tdev)
        else:
            arr = _host_to_torch(data, tdev)
        if stores_grad and not arr.requires_grad:
            arr = arr.detach().requires_grad_(True)
        self.data = arr
        self.requires_grad = requires_grad
        self.stores_grad = stores_grad
        self.creator = creator
        self.name = name

    # ---- metadata ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    # ---- conversion ----------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy of the values: a snapshot, as the reference's
        (a CPU tensor's own buffer would change with its next in-place
        update)."""
        data = self.data.detach()
        if data.device.type == "cpu":
            return data.numpy().copy()
        return data.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)

    def item(self):
        return self.data.item()

    def to_device(self, dev) -> "Tensor":
        """Reference: ``Tensor::ToDevice`` — move in place.  A parameter
        becomes a fresh leaf on the new device (same values); on its own
        device it stays the leaf it was."""
        dev = get_device(dev)
        if self.data.device != dev.torch_device:
            arr = self.data.detach().to(dev.torch_device)
            if self.stores_grad:
                arr.requires_grad_(True)
            self.data = arr
        self.device = dev
        return self

    def copy_from_numpy(self, arr) -> "Tensor":
        """Reference: ``CopyDataFromHostPtr`` — overwrite the values in
        place (cast to this tensor's dtype, reshaped to its shape)."""
        src = torch.from_numpy(np.array(arr)).reshape(self.shape)
        with torch.no_grad():
            self.data.copy_(src)
        return self

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device.lang})")


def from_numpy(arr, device=None, requires_grad: bool = True) -> Tensor:
    return Tensor(data=arr, device=device, requires_grad=requires_grad)
