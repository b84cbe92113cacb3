"""Tensors of the PyTorch/CUDA port.

Counterpart: ``singa_tpu/tensor.py`` — the ``Tensor`` class (:98), its
methods (:149-345) and the reference-named free functions of its
``__all__`` (:37-66): the constructors, the elementwise unary, binary
and comparison families, ``Clamp``/``Threshold``, the reductions, the
BLAS face (``Mult``, ``GEMM``, ``GEMV``, ``Dot``, ``Axpy``, ``Scale``,
``Einsum``), ``SoftMax``/``LogSoftMax``/``CrossEntropyFwd``/
``SoftmaxCrossEntropyBwd``, the shape family, the random fills and the
row and column ops, with the dtype aliases.  A :class:`Tensor` wraps a
``torch.Tensor`` in ``.data`` on a :class:`~singa_tpu_torch.device.Device`
and carries the reference's autograd fields (``requires_grad``,
``stores_grad``, ``creator``) and a ``name``.  A tensor that stores its
gradient (a parameter) holds a ``torch`` leaf that requires grad, so the
autograd ops (:mod:`singa_tpu_torch.autograd`) record through
``torch.autograd``.  The functions and methods here are raw math, run
under ``torch.no_grad()`` and recorded by no autograd, as the
reference's.

Results follow ``jax.numpy`` with 64-bit types off, where torch differs:

* host data, the dtype aliases and dtype names take the 32-bit default:
  ``float64`` and ``int64`` resolve to float32 and int32;
* promotion is ``jnp``'s: Python scalars are weakly typed (an int keeps
  the tensor's dtype, or int32 for bool; a float keeps a floating
  dtype, or float32), a Python bool is a bool; ``Div`` and ``Atan2``
  of integers give float32; ``Sum``, ``Prod`` and ``L1Norm`` of int32
  or bool give int32 (torch: int64), ``Average`` of them float32 (torch
  raises); ``ArgMax``/``ArgMin`` give int32; ``Mod`` is Python's
  (``torch.remainder``), and an integer modulo 0 gives 0, as XLA's;
  integer products (``Mult``, ``GEMM``, ``Dot``, ``Einsum``) stay
  integers, exact on the card too; where ``jnp`` raises (``Sigmoid`` or
  ``Erf`` of integers, ``Neg``/``Sign``/``Round``/``SoftMax`` of bools,
  bool minus bool) this raises too;
* ``Gelu`` is ``jax.nn.gelu``'s default, the tanh form
  (``autograd.gelu`` is the erf form);
* ``.T`` and ``transpose(None)`` reverse all axes, as ``jnp``'s
  (``torch.Tensor.T`` does not on ndim != 2), and ``GEMM``'s
  ``transA``/``transB`` use them;
* ``Gather`` follows ``jnp.take``'s fill mode: an id in ``[-n, 0)``
  counts from the end, one outside ``[-n, n)`` gives NaN (the dtype's
  minimum for signed integers, its maximum for unsigned ones, True for
  bools);
* ``__rsub__`` and ``__rtruediv__`` cast the scalar to the tensor's
  dtype first, as the reference's ``_wrap`` does (``2.7 - t`` of an
  int32 ``t`` is ``2 - t``);
* there is no ``__eq__``/``__ne__`` (``EQ``/``NE`` are functions), so a
  Tensor stays hashable by identity.

Where the port must differ from the reference, it does so here:

* **Mutation keeps the buffer.**  The reference rebinds ``.data`` to a
  fresh array (``Axpy``, ``Scale``, the row and column ops,
  ``set_value``, ``copy_data``, the fills, ``+=``, ``__setitem__`` …).
  The port writes in place, under ``no_grad``, wherever the result has
  the tensor's own dtype and shape, so a parameter stays the same leaf
  and a captured CUDA graph's address check still holds; where the
  reference's result dtype or shape differs it rebinds as the reference
  does (an int32 tensor ``+= 0.5`` becomes float32, ``reset_like``
  takes the other tensor's shape).
* **No result aliases its input.**  Because the port writes in place,
  every result has its own storage, including those torch would give
  as views (``Reshape``, ``Transpose``, ``Squeeze``, ``Unsqueeze``,
  ``Flatten``, ``SliceOn``, ``CopyRows``/``CopyColumns``, ``Broadcast``,
  ``__getitem__``, the ``reshape``/``transpose`` methods).
* **Random draws come from the tensor's device generator**, so their
  values differ from JAX's (the ranges, moments and seeding hold).
* ``device=None`` is :func:`~singa_tpu_torch.device.get_default_device`
  (the card unless ``set_default_device`` named another), and
  ``to_host()`` goes to the CPU.

Indexing is ``jnp``'s: a Python integer index past either end of its
axis clamps into it on read (``t[5]`` of 3 rows is row 2, ``t[-5]`` row
0), and a write through one drops the update, as ``.at[].set`` does;
both are decided on the host, so the card never sees an index out of
range.  ``clone()`` is the reference's ``data + 0``: a bool tensor's
clone is int32.
"""

from __future__ import annotations

import string

import numpy as np
import torch
import torch.nn.functional as F

from . import device as device_mod
from .device import _NARROW, Device, _host_to_torch, get_device

__all__ = [
    "Tensor", "from_numpy", "to_numpy", "from_raw_tensor", "as_array",
    "zeros_like", "ones_like", "zeros", "ones", "full", "arange", "eye",
    # elementwise unary
    "Abs", "Exp", "Log", "Sign", "Sqrt", "Square", "ReLU", "Sigmoid",
    "Tanh", "Cos", "Sin", "Tan", "Cosh", "Sinh", "Acos", "Asin", "Atan",
    "Acosh", "Asinh", "Atanh", "Ceil", "Floor", "Round", "Reciprocal",
    "Erf", "Gelu", "SoftPlus", "SoftSign", "Neg",
    # elementwise binary / scalar
    "Add", "Sub", "EltwiseMult", "Div", "Pow", "Mod", "Atan2",
    "Maximum", "Minimum",
    # comparison
    "LT", "LE", "GT", "GE", "EQ", "NE",
    # reductions
    "Sum", "Average", "Max", "Min", "Prod", "SumAll", "MaxAll", "MinAll",
    "SumRows", "SumColumns", "AverageRows", "AverageColumns", "ArgMax",
    "ArgMin", "Norm", "L2Norm", "L1Norm",
    # blas
    "Mult", "GEMM", "GEMV", "Dot", "Axpy", "Scale", "Einsum", "einsum",
    # nn-ish
    "SoftMax", "LogSoftMax", "CrossEntropyFwd", "SoftmaxCrossEntropyBwd",
    "Clamp", "Threshold",
    # shape
    "Reshape", "Transpose", "Broadcast", "ConcatOn", "SliceOn",
    "ConcatenateRows", "ConcatenateColumns", "CopyRows", "CopyColumns",
    "Stack", "Repeat", "Tile", "Squeeze", "Unsqueeze", "Flatten", "Gather",
    # random / fill
    "Uniform", "Gaussian", "Bernoulli", "Fill",
    # row/col ops
    "AddColumn", "AddRow", "DivColumn", "DivRow", "MultColumn", "MultRow",
    "SubColumn", "SubRow",
    # dtype helpers
    "int32", "float32", "float16", "bfloat16", "float64", "int64", "uint8",
    "bool_",
]

# dtype aliases (reference DataType enum kFloat32/kFloat16/kInt/kChar/kDouble);
# float64 and int64 resolve to float32 and int32 wherever a dtype is taken
float32 = torch.float32
float16 = torch.float16
bfloat16 = torch.bfloat16
float64 = torch.float64
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool

_DTYPE_NAMES = {
    "float32": float32, "float16": float16, "bfloat16": bfloat16,
    "float64": float64, "int32": int32, "int64": int64, "int": int32,
    "uint8": uint8, "bool": bool_, "kFloat32": float32, "kFloat16": float16,
    "kInt": int32, "kDouble": float64, "kChar": uint8,
}
_TORCH_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _resolve_dtype(dtype):
    """A dtype (a torch dtype, a numpy type or a name) as the torch
    dtype it means, 64-bit types narrowed; None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        dtype = _DTYPE_NAMES[dtype]
    elif not isinstance(dtype, torch.dtype):
        np_dt = np.dtype(dtype)
        dtype = torch.from_numpy(np.zeros(0, _NARROW.get(np_dt, np_dt))).dtype
    return _TORCH_NARROW.get(dtype, dtype)


class Tensor:
    """N-d array on a :class:`Device` (reference ``python/singa/tensor.py``).

    ``device=None`` takes the device of ``data`` when it is a
    ``torch.Tensor``, and otherwise the default device (the card unless
    ``set_default_device`` named another, raising without one).
    ``stores_grad`` marks a parameter: its floating ``data`` becomes a
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
            arr = torch.zeros(tuple(shape), dtype=_resolve_dtype(dtype)
                              or float32, device=tdev)
        elif isinstance(data, torch.Tensor):
            arr = data if data.device == tdev else data.to(tdev)
        else:
            arr = _host_to_torch(data, tdev)
        if stores_grad and not arr.requires_grad and \
                arr.is_floating_point():
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

    @property
    def ndim(self):
        return self.data.dim()

    def size(self) -> int:
        return self.data.numel()

    def memsize(self) -> int:
        return self.size() * self.data.element_size()

    def is_empty(self) -> bool:
        return self.size() == 0

    def __len__(self):
        return self.shape[0] if self.ndim else 0

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

    def _like(self, data, **kw) -> "Tensor":
        """A new Tensor on this device with this tensor's autograd flags."""
        kw.setdefault("requires_grad", self.requires_grad)
        kw.setdefault("stores_grad", self.stores_grad)
        return Tensor(data=data, device=self.device, **kw)

    def as_type(self, dtype) -> "Tensor":
        """Reference: ``Tensor::AsType`` — a converted copy."""
        with torch.no_grad():
            return self._like(self.data.to(_resolve_dtype(dtype), copy=True))

    def to_device(self, dev) -> "Tensor":
        """Reference: ``Tensor::ToDevice`` — move in place.  A parameter
        becomes a fresh leaf on the new device (same values); on its own
        device it stays the leaf it was."""
        dev = get_device(dev)
        if self.data.device != dev.torch_device:
            arr = self.data.detach().to(dev.torch_device)
            if self.stores_grad and arr.is_floating_point():
                arr.requires_grad_(True)
            self.data = arr
        self.device = dev
        return self

    def to_host(self) -> "Tensor":
        """Move to the CPU (the reference's default device, which the
        port's is not)."""
        return self.to_device(get_device("cpu"))

    def clone(self) -> "Tensor":
        """Reference: ``Tensor::Clone`` — a deep copy, as ``data + 0``
        (a bool tensor's is int32)."""
        data = self.data.detach()
        with torch.no_grad():
            return self._like(data.to(torch.int32) if data.dtype == bool_
                              else data.clone(), name=self.name)

    def reset_like(self, t: "Tensor") -> "Tensor":
        """Reference: ``Tensor::ResetLike`` — zeros of ``t``'s shape and
        dtype (in place where they are this tensor's)."""
        _set_data(self, torch.zeros(t.shape, dtype=t.dtype,
                                    device=self.device.torch_device))
        return self

    # ---- shape ops (new tensors with their own storage) -----------------
    def reshape(self, shape) -> "Tensor":
        with torch.no_grad():
            return self._like(_own(self.data.reshape(tuple(shape))))

    def transpose(self, axes=None) -> "Tensor":
        """``axes=None`` reverses them all, as ``jnp.transpose``."""
        with torch.no_grad():
            return self._like(_own(_permute(self.data, axes)))

    @property
    def T(self):
        return self.transpose()

    # ---- mutation (in place where dtype and shape stay) -----------------
    def set_value(self, x) -> "Tensor":
        """Reference: ``Tensor::SetValue`` — fill with a scalar."""
        with torch.no_grad():
            self.data.fill_(_raw(x))
        return self

    def copy_data(self, t: "Tensor") -> "Tensor":
        """Reference: ``Tensor::CopyData`` — overwrite the values (cast
        to this tensor's dtype, reshaped to its shape)."""
        with torch.no_grad():
            self.data.copy_(_raw(t).reshape(self.shape))
        return self

    def copy_from_numpy(self, arr) -> "Tensor":
        """Reference: ``CopyDataFromHostPtr`` — overwrite the values in
        place (cast to this tensor's dtype, reshaped to its shape)."""
        src = torch.from_numpy(np.array(arr)).reshape(self.shape)
        with torch.no_grad():
            self.data.copy_(src)
        return self

    def _draw(self, fill) -> "Tensor":
        """Fill in place from this device's generator: ``fill(out)``
        draws into ``out``, float32 where this dtype is not floating
        (then cast, as the reference's ``astype``)."""
        with torch.no_grad():
            if self.data.is_floating_point():
                fill(self.data)
            else:
                tmp = torch.empty(self.shape, dtype=torch.float32,
                                  device=self.data.device)
                fill(tmp)
                self.data.copy_(tmp)
        return self

    def uniform(self, low=0.0, high=1.0) -> "Tensor":
        g = self.device.generator
        return self._draw(lambda out: out.uniform_(low, high, generator=g))

    def gaussian(self, mean=0.0, std=1.0) -> "Tensor":
        g = self.device.generator
        return self._draw(lambda out: out.normal_(mean, std, generator=g))

    def bernoulli(self, p=0.5) -> "Tensor":
        g = self.device.generator

        def fill(out):
            u = torch.rand(self.shape, generator=g, device=out.device)
            out.copy_(u < p)
        return self._draw(fill)

    # ---- python protocol -------------------------------------------------
    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device.lang})")

    def __getitem__(self, idx):
        idx, _ = _index(idx, self.shape)
        with torch.no_grad():
            return Tensor(data=_own(self.data[idx]), device=self.device,
                          requires_grad=self.requires_grad)

    def __setitem__(self, idx, value):
        idx, outside = _index(idx, self.shape)
        if outside:
            return                       # jnp drops the update
        with torch.no_grad():
            self.data[idx] = _operand(value, self.data.device)

    # arithmetic — raw math, not recorded by autograd (the reference's
    # tensor.py; autograd records in autograd.py's ops)
    def __add__(self, o):
        return Add(self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return Sub(self, o)

    def __rsub__(self, o):
        return Sub(_wrap(o, self), self)

    def __mul__(self, o):
        return EltwiseMult(self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Div(self, o)

    def __rtruediv__(self, o):
        return Div(_wrap(o, self), self)

    def __pow__(self, o):
        return Pow(self, o)

    def __neg__(self):
        return Neg(self)

    def __matmul__(self, o):
        return Mult(self, o)

    def __iadd__(self, o):
        _set_data(self, _bin(torch.add, self.data, o))
        return self

    def __isub__(self, o):
        _set_data(self, _bin(_sub, self.data, o))
        return self

    def __imul__(self, o):
        _set_data(self, _bin(torch.mul, self.data, o))
        return self

    def __itruediv__(self, o):
        _set_data(self, _bin(torch.div, self.data, o, floating=True))
        return self

    def __lt__(self, o):
        return LT(self, o)

    def __le__(self, o):
        return LE(self, o)

    def __gt__(self, o):
        return GT(self, o)

    def __ge__(self, o):
        return GE(self, o)


# --------------------------------------------------------------------------
# helpers: operands, jnp's promotion, results
# --------------------------------------------------------------------------

def _raw(x):
    return x.data if isinstance(x, Tensor) else x


def _index(idx, shape):
    """An index with its Tensors unwrapped and its Python integers
    clamped into their axes, and whether any integer lay outside its
    axis (see the module docstring)."""
    entries = [_raw(i) for i in (idx if isinstance(idx, tuple) else (idx,))]
    ell = next((k for k, i in enumerate(entries) if i is Ellipsis),
               len(entries))
    axes = {}
    axis = 0
    for k in range(ell):                 # left of an Ellipsis: from axis 0
        axes[k] = axis
        axis += _index_width(entries[k])
    axis = len(shape)
    for k in range(len(entries) - 1, ell, -1):   # right of it: from the end
        axis -= _index_width(entries[k])
        axes[k] = axis
    outside = False
    for k, i in enumerate(entries):
        if (isinstance(i, (int, np.integer))
                and not isinstance(i, (bool, np.bool_))
                and 0 <= axes.get(k, -1) < len(shape)):
            n = shape[axes[k]]
            if not -n <= i < n:
                outside = True
                entries[k] = min(max(int(i), -n), n - 1)
    return (tuple(entries) if isinstance(idx, tuple) else entries[0]), outside


def _index_width(i) -> int:
    """The axes an index entry consumes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, (np.ndarray, torch.Tensor)) and i.dtype in (
            np.bool_, torch.bool):
        return i.ndim
    return 1


def _own(x: torch.Tensor) -> torch.Tensor:
    """``x`` in storage of its own (a view of the input is copied)."""
    return x.clone(memory_format=torch.contiguous_format)


def _permute(x: torch.Tensor, axes) -> torch.Tensor:
    return x.permute(tuple(range(x.dim() - 1, -1, -1)) if axes is None
                     else tuple(axes))


def _wrap(x, like: Tensor) -> Tensor:
    """A scalar as a Tensor of ``like``'s dtype (the reference's
    ``jnp.asarray(x, like.dtype)``)."""
    if isinstance(x, Tensor):
        return x
    return Tensor(data=torch.tensor(x).to(like.dtype).to(like.data.device),
                  device=like.device, requires_grad=False)


def _out(data, like: Tensor) -> Tensor:
    return Tensor(data=data, device=like.device, requires_grad=False)


def _set_data(t: Tensor, new: torch.Tensor) -> None:
    """``t``'s values become ``new``: in place (same storage, same leaf)
    where ``new`` has ``t``'s dtype and shape; otherwise ``t`` is rebound
    to ``new``, as the reference rebinds."""
    with torch.no_grad():
        if new.dtype == t.data.dtype and new.shape == t.data.shape:
            t.data.copy_(new)
            return
    new = new.detach()
    if t.stores_grad and new.is_floating_point():
        new.requires_grad_(True)
    t.data = new


def _operand(x, device) -> torch.Tensor | int | float:
    """A Tensor, torch tensor or host array as a torch tensor on
    ``device`` (64-bit host data narrowed); a Python int or float stays
    a (weakly typed) scalar; a Python bool becomes a bool tensor."""
    x = _raw(x)
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (int, float)) and not isinstance(x, (bool, np.generic)):
        return x
    return _host_to_torch(x, device)


def _promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """``jnp``'s result type of two strongly typed dtypes (torch's
    ``promote_types`` agrees on these), 64-bit types off."""
    dt = torch.promote_types(a, b)
    return _TORCH_NARROW.get(dt, dt)


def _result_type(a: torch.Tensor, b) -> torch.dtype:
    """``jnp``'s result type of ``a`` with ``b`` (a tensor, or a weakly
    typed Python int or float), 64-bit types off."""
    if isinstance(b, torch.Tensor):
        return _promote(a.dtype, b.dtype)
    if isinstance(b, float):
        return a.dtype if a.is_floating_point() else torch.float32
    return torch.int32 if a.dtype == torch.bool else a.dtype


def _as(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor or a scalar) as a tensor of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _floating(dt: torch.dtype) -> torch.dtype:
    """The dtype a float op computes in: its own if floating, else
    float32 (``jnp``'s promotion of integers and bools)."""
    return dt if dt.is_floating_point else torch.float32


def _sub(a, b):
    if a.dtype == torch.bool:
        raise TypeError("jnp.subtract does not take two booleans")
    return torch.sub(a, b)


def _pow(a, b):
    if a.dtype == torch.bool:          # jnp's power of bools is int32
        a, b = a.to(torch.int32), b.to(torch.int32)
    return torch.pow(a, b)


def _mod(a, b):
    """Python's modulo (``jnp.mod``); an integer modulo 0 gives 0."""
    if a.dtype == torch.bool:
        a, b = a.to(torch.int32), b.to(torch.int32)
    if a.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


def _bin(fn, a: torch.Tensor, b, floating: bool = False):
    """``fn(a, b)`` on operands promoted to ``jnp``'s result type
    (``floating``: an integer result type computes in float32)."""
    with torch.no_grad():
        b = _operand(b, a.device)
        rt = _result_type(a, b)
        if floating:
            rt = _floating(rt)
        return fn(a.to(rt), _as(b, rt, a.device))


def _binary(fn, floating=False):
    def op(a: Tensor, b) -> Tensor:
        return _out(_bin(fn, a.data, b, floating), a)
    return op


# --------------------------------------------------------------------------
# constructors / numpy interop
# --------------------------------------------------------------------------

def as_array(x) -> torch.Tensor:
    """A Tensor's ``data``; a torch tensor as it is; host data as a
    tensor on the default device."""
    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return _host_to_torch(x, device_mod.get_default_device().torch_device)


def from_numpy(arr, device=None, requires_grad: bool = True) -> Tensor:
    return Tensor(data=arr, device=device, requires_grad=requires_grad)


def to_numpy(t: Tensor) -> np.ndarray:
    return t.numpy()


def from_raw_tensor(data, device=None) -> Tensor:
    return Tensor(data=data, device=device)


def zeros_like(t: Tensor) -> Tensor:
    return _out(torch.zeros(t.shape, dtype=t.dtype, device=t.data.device), t)


def ones_like(t: Tensor) -> Tensor:
    return _out(torch.ones(t.shape, dtype=t.dtype, device=t.data.device), t)


def _made(fn, dtype, device, *args) -> Tensor:
    dev = get_device(device)
    return Tensor(data=fn(*args, dtype=_resolve_dtype(dtype),
                          device=dev.torch_device), device=dev)


def zeros(shape, dtype=float32, device=None) -> Tensor:
    return Tensor(shape=shape, dtype=dtype, device=device)


def ones(shape, dtype=float32, device=None) -> Tensor:
    return _made(torch.ones, dtype, device, tuple(shape))


def full(shape, value, dtype=float32, device=None) -> Tensor:
    return _made(torch.full, dtype, device, tuple(shape), value)


def arange(*args, dtype=float32, device=None) -> Tensor:
    return _made(torch.arange, dtype, device, *args)


def eye(n, dtype=float32, device=None) -> Tensor:
    return _made(torch.eye, dtype, device, n)


# --------------------------------------------------------------------------
# elementwise unary (reference: EltwiseUnaryTensorFn family)
# --------------------------------------------------------------------------

def _unary(fn, kind="float"):
    """``kind``: ``"float"`` computes in the input's floating dtype
    (integers and bools in float32); ``"float-only"`` raises on integers
    and bools; ``"same"`` keeps the dtype and raises on bools; ``"int"``
    computes bools as int32; ``"keep"`` returns bools as they are."""
    def op(t: Tensor) -> Tensor:
        x = t.data
        with torch.no_grad():
            if x.is_floating_point() or kind == "float":
                y = fn(x.to(_floating(x.dtype)))
            elif kind == "float-only":
                raise TypeError(f"takes a floating tensor, not {x.dtype} "
                                f"(as jnp)")
            elif x.dtype != torch.bool:
                y = fn(x)
            elif kind == "int":
                y = fn(x.to(torch.int32))
            elif kind == "keep":
                y = x.clone()
            else:
                raise TypeError("does not take a bool tensor (as jnp)")
        return _out(y, t)
    return op


Abs = _unary(torch.abs, "keep")
Exp = _unary(torch.exp)
Log = _unary(torch.log)
Sign = _unary(torch.sign, "same")
Sqrt = _unary(torch.sqrt)
Square = _unary(torch.square, "int")
Cos = _unary(torch.cos)
Sin = _unary(torch.sin)
Tan = _unary(torch.tan)
Cosh = _unary(torch.cosh)
Sinh = _unary(torch.sinh)
Acos = _unary(torch.acos)
Asin = _unary(torch.asin)
Atan = _unary(torch.atan)
Acosh = _unary(torch.acosh)
Asinh = _unary(torch.asinh)
Atanh = _unary(torch.atanh)
Ceil = _unary(torch.ceil, "keep")
Floor = _unary(torch.floor, "keep")
Round = _unary(torch.round, "same")     # half to even, as jnp.round
Reciprocal = _unary(torch.reciprocal)
Neg = _unary(torch.neg, "same")
Erf = _unary(torch.erf, "float-only")
Gelu = _unary(lambda x: F.gelu(x, approximate="tanh"))
SoftPlus = _unary(F.softplus)
SoftSign = _unary(lambda x: x / (1 + torch.abs(x)))
ReLU = _unary(lambda x: torch.clamp_min(x, 0), "int")
Sigmoid = _unary(torch.sigmoid, "float-only")
Tanh = _unary(torch.tanh)


# --------------------------------------------------------------------------
# elementwise binary / scalar, comparisons (numpy broadcasting)
# --------------------------------------------------------------------------

Add = _binary(torch.add)
Sub = _binary(_sub)
EltwiseMult = _binary(torch.mul)
Div = _binary(torch.div, floating=True)
_pow_op = _binary(_pow)


def Pow(a: Tensor, b) -> Tensor:
    """``jnp.power``; an integer tensor to a negative Python int raises,
    as there."""
    if type(b) is int and b < 0 and not a.data.is_floating_point():
        raise ValueError("integers cannot be raised to negative powers")
    return _pow_op(a, b)


Mod = _binary(_mod)
Atan2 = _binary(torch.atan2, floating=True)
Maximum = _binary(torch.maximum)
Minimum = _binary(torch.minimum)

LT = _binary(torch.lt)
LE = _binary(torch.le)
GT = _binary(torch.gt)
GE = _binary(torch.ge)
EQ = _binary(torch.eq)
NE = _binary(torch.ne)


def _clip(x: torch.Tensor, low, high) -> torch.Tensor:
    """``jnp.clip``: ``maximum`` with ``low``, then ``minimum`` with
    ``high`` (either may be None), each promoted as ``jnp``'s."""
    if low is not None:
        x = _bin(torch.maximum, x, low)
    if high is not None:
        x = _bin(torch.minimum, x, high)
    return x


def Clamp(t: Tensor, low, high) -> Tensor:
    return _out(_clip(t.data, low, high), t)


def Threshold(t: Tensor, th) -> Tensor:
    """Reference: ``cuda::threshold`` — 1 where x < th else 0."""
    return _out(_bin(torch.lt, t.data, th).to(t.dtype), t)


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------

def _axes(x: torch.Tensor, axis) -> tuple:
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (tuple, list)):
        return tuple(a % x.dim() for a in axis)
    return (axis % x.dim(),)


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    """``jnp.sum``'s accumulation type: int32 for bools and narrower
    signed integers, the dtype itself otherwise."""
    if dt in (torch.bool, torch.int8, torch.int16):
        return torch.int32
    return _TORCH_NARROW.get(dt, dt)


def _sum(x, axis=None, keepdims=False):
    """``jnp.sum`` (no axis is the identity, as ``jnp``'s)."""
    with torch.no_grad():
        dt = _sum_dtype(x.dtype)
        axes = _axes(x, axis)
        if not axes:
            return x.to(dt, copy=True)
        return torch.sum(x, dim=axes, keepdim=keepdims, dtype=dt)


def Sum(t: Tensor, axis=None, keepdims=False) -> Tensor:
    return _out(_sum(t.data, axis, keepdims), t)


def Average(t: Tensor, axis=None, keepdims=False) -> Tensor:
    x = t.data
    with torch.no_grad():
        x = x.to(_floating(x.dtype))
        axes = _axes(x, axis)
        y = torch.mean(x, dim=axes, keepdim=keepdims) if axes else x.clone()
    return _out(y, t)


def _extreme(fn, x, axis, keepdims):
    with torch.no_grad():
        axes = _axes(x, axis)
        if not axes:
            return x.clone()
        return fn(x, dim=axes, keepdim=keepdims)


def Max(t: Tensor, axis=None, keepdims=False) -> Tensor:
    return _out(_extreme(torch.amax, t.data, axis, keepdims), t)


def Min(t: Tensor, axis=None, keepdims=False) -> Tensor:
    return _out(_extreme(torch.amin, t.data, axis, keepdims), t)


def Prod(t: Tensor, axis=None, keepdims=False) -> Tensor:
    """``jnp.prod``, one axis at a time (16-bit floats in float32,
    rounded once)."""
    x = t.data
    dt = _sum_dtype(x.dtype)
    acc = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
    with torch.no_grad():
        axes = _axes(x, axis)
        y = x.to(acc, copy=True)
        for a in sorted(axes, reverse=True):
            y = torch.prod(y, a, keepdim=keepdims, dtype=acc)
        return _out(y.to(dt), t)


def SumAll(t: Tensor) -> float:
    return float(_sum(t.data))


def MaxAll(t: Tensor) -> float:
    return float(_extreme(torch.amax, t.data, None, False))


def MinAll(t: Tensor) -> float:
    return float(_extreme(torch.amin, t.data, None, False))


def SumRows(t: Tensor) -> Tensor:
    return Sum(t, axis=0)


def SumColumns(t: Tensor) -> Tensor:
    return Sum(t, axis=1)


def AverageRows(t: Tensor) -> Tensor:
    return Average(t, axis=0)


def AverageColumns(t: Tensor) -> Tensor:
    return Average(t, axis=1)


def _arg(fn, t: Tensor, axis) -> Tensor:
    x = t.data
    with torch.no_grad():
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return _out(fn(x, dim=axis).to(torch.int32), t)


def ArgMax(t: Tensor, axis=-1) -> Tensor:
    return _arg(torch.argmax, t, axis)


def ArgMin(t: Tensor, axis=-1) -> Tensor:
    return _arg(torch.argmin, t, axis)


def _l2(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.linalg.vector_norm(x.to(_floating(x.dtype)))


def Norm(t: Tensor) -> float:
    return float(_l2(t.data))


def L2Norm(t: Tensor) -> Tensor:
    return _out(_l2(t.data), t)


def L1Norm(t: Tensor) -> Tensor:
    return _out(_sum(Abs(t).data), t)


# --------------------------------------------------------------------------
# BLAS face (torch.matmul: the reference computes these outside any
# Pallas kernel); integer products stay exact integers on every device
# --------------------------------------------------------------------------

def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul`` of integer or bool operands (same dtype), summed in
    int32 by broadcasting (CUDA has no integer matmul)."""
    dt = a.dtype
    a, b = a.to(torch.int32), b.to(torch.int32)
    va, vb = a.dim() == 1, b.dim() == 1
    a = a.unsqueeze(0) if va else a
    b = b.unsqueeze(-1) if vb else b
    out = (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2, dtype=torch.int32)
    out = out.squeeze(-2) if va else out
    out = out.squeeze(-1) if vb else out
    return out != 0 if dt == torch.bool else out.to(dt)


def _matmul(a: torch.Tensor, b) -> torch.Tensor:
    with torch.no_grad():
        b = _operand(b, a.device)
        rt = _result_type(a, b)
        a, b = a.to(rt), b.to(rt)
        if rt.is_floating_point:
            return torch.matmul(a, b)
        return _int_matmul(a, b)


def Mult(a: Tensor, b) -> Tensor:
    """Matrix multiply (reference ``Mult``: GEMM/GEMV dispatch)."""
    return _out(_matmul(a.data, b), a)


def _scaled_sum(alpha, prod, beta, c):
    """``alpha * prod`` (+ ``beta * c`` when ``c`` is given and ``beta``
    is not 0), promoted as ``jnp``'s."""
    out = _bin(torch.mul, prod, alpha)
    if c is not None and beta != 0.0:
        out = _bin(torch.add, out, _bin(torch.mul, _operand(c, prod.device),
                                        beta))
    return out


def GEMM(a: Tensor, b, c=None, alpha=1.0, beta=0.0, transA=False,
         transB=False) -> Tensor:
    A = _permute(a.data, None) if transA else a.data
    B = _operand(b, a.data.device)
    B = _permute(B, None) if transB else B
    return _out(_scaled_sum(alpha, _matmul(A, B), beta, c), a)


def GEMV(a: Tensor, x, y=None, alpha=1.0, beta=0.0) -> Tensor:
    return _out(_scaled_sum(alpha, _matmul(a.data, x), beta, y), a)


def Dot(a: Tensor, b) -> Tensor:
    return _out(_matmul(a.data.reshape(-1),
                        _operand(b, a.data.device).reshape(-1)), a)


def Axpy(alpha, x: Tensor, y: Tensor) -> Tensor:
    """y += alpha * x, in place on ``y`` (reference: cublasSaxpy)."""
    _set_data(y, _bin(torch.add, y.data, _bin(torch.mul, x.data, alpha)))
    return y


def Scale(alpha, t: Tensor) -> Tensor:
    """t *= alpha, in place (reference: cublasSscal)."""
    _set_data(t, _bin(torch.mul, t.data, alpha))
    return t


def _einsum_spec(spec: str, ndims) -> tuple:
    """The input subscripts and the output of ``spec`` with every
    ellipsis spelled out in letters of its own (right-aligned, as numpy
    broadcasts), and the implicit output made explicit."""
    spec = spec.replace(" ", "")
    lhs, arrow, out = spec.partition("->")
    ins = lhs.split(",")
    spare = [c for c in string.ascii_letters if c not in spec]
    n_ell = max([nd - len(s.replace("...", "")) for s, nd in zip(ins, ndims)
                 if "..." in s] or [0])
    ell = "".join(spare[:n_ell])
    ins = [s.replace("...", ell[n_ell - (nd - len(s.replace("...", ""))):])
           for s, nd in zip(ins, ndims)]
    if arrow:
        out = out.replace("...", ell)
    else:
        once = sorted(c for c in set("".join(ins))
                      if "".join(ins).count(c) == 1 and c not in ell)
        out = ell + "".join(once)
    return ins, out


def _int_einsum(spec: str, ops) -> torch.Tensor:
    """``jnp.einsum`` of integer or bool operands (one dtype), in int32
    by broadcasting every operand over all the indices, multiplying, and
    summing the indices the output drops."""
    dt = ops[0].dtype
    ins, out = _einsum_spec(spec, [x.dim() for x in ops])
    letters = list(dict.fromkeys("".join(ins)))
    prod = None
    for s, x in zip(ins, ops):
        x, s = x.to(torch.int32), list(s)
        while len(set(s)) < len(s):      # a repeated index: its diagonal
            c = next(c for c in s if s.count(c) > 1)
            i = s.index(c)
            j = s.index(c, i + 1)
            x = torch.diagonal(x, dim1=i, dim2=j)
            s = [v for k, v in enumerate(s) if k not in (i, j)] + [c]
        x = x.permute([s.index(c) for c in letters if c in s])
        sizes = iter(x.shape)
        x = x.reshape([next(sizes) if c in s else 1 for c in letters])
        prod = x if prod is None else prod * x
    drop = [i for i, c in enumerate(letters) if c not in out]
    if drop:
        prod = prod.sum(dim=drop, dtype=torch.int32)
    kept = [c for c in letters if c in out]
    prod = prod.permute([kept.index(c) for c in out])
    return prod != 0 if dt == torch.bool else prod.to(dt)


def Einsum(spec: str, *tensors: Tensor) -> Tensor:
    with torch.no_grad():
        ops = [t.data for t in tensors]
        rt = ops[0].dtype
        for x in ops[1:]:
            rt = _promote(rt, x.dtype)
        ops = [x.to(rt) for x in ops]
        y = torch.einsum(spec, *ops) if rt.is_floating_point \
            else _int_einsum(spec, ops)
    return _out(y, tensors[0])


# the reference exposes this lowercase at module level
# (python/singa/tensor.py einsum)
einsum = Einsum


# --------------------------------------------------------------------------
# nn-flavoured math the reference keeps at tensor level
# --------------------------------------------------------------------------

def _softmax(fn, t: Tensor, axis) -> Tensor:
    x = t.data
    if x.dtype == torch.bool:
        raise TypeError("jax.nn.softmax does not take a bool tensor")
    with torch.no_grad():
        return _out(fn(x.to(_floating(x.dtype)), dim=axis), t)


def SoftMax(t: Tensor, axis: int = -1) -> Tensor:
    return _softmax(torch.softmax, t, axis)


def LogSoftMax(t: Tensor, axis: int = -1) -> Tensor:
    return _softmax(torch.log_softmax, t, axis)


def CrossEntropyFwd(p: Tensor, target) -> Tensor:
    """Reference: ``CrossEntropyFwd`` kernel — -log p[target] with p already
    softmax-ed (clipped to [1e-10, 1]); integer or one-hot targets."""
    pd = p.data
    with torch.no_grad():
        td = _operand(target, pd.device)
        if td.dim() == pd.dim():  # one-hot
            td = torch.argmax(td, dim=-1)
        picked = torch.take_along_dim(pd, td.long().unsqueeze(-1), dim=-1)
        y = -torch.log(_clip(picked, 1e-10, 1.0)).squeeze(-1)
    return _out(y, p)


def SoftmaxCrossEntropyBwd(p: Tensor, target) -> Tensor:
    """Reference kernel: grad = p - onehot(target) (an id outside
    [0, n) is a row of zeros, as ``jax.nn.one_hot``)."""
    pd = p.data
    with torch.no_grad():
        td = _operand(target, pd.device)
        if td.dim() != pd.dim():
            classes = torch.arange(pd.shape[-1], device=pd.device)
            td = (td.unsqueeze(-1) == classes).to(pd.dtype)
    return _out(_bin(torch.sub, pd, td), p)


# --------------------------------------------------------------------------
# shape manipulation (every result in storage of its own)
# --------------------------------------------------------------------------

def Reshape(t: Tensor, shape) -> Tensor:
    return t.reshape(shape)


def Transpose(t: Tensor, axes=None) -> Tensor:
    return t.transpose(axes)


def Broadcast(t: Tensor, shape) -> Tensor:
    with torch.no_grad():
        return _out(_own(torch.broadcast_to(t.data, tuple(shape))), t)


def _common(tensors) -> list:
    """The tensors' data in their common ``jnp`` result type."""
    rt = tensors[0].dtype
    for t in tensors[1:]:
        rt = _promote(rt, t.dtype)
    return [t.data.to(rt) for t in tensors]


def ConcatOn(tensors, axis: int) -> Tensor:
    with torch.no_grad():
        return _out(torch.cat(_common(tensors), dim=axis), tensors[0])


def SliceOn(t: Tensor, start: int, end: int, axis: int) -> Tensor:
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(start, end)
    with torch.no_grad():
        return _out(_own(t.data[tuple(idx)]), t)


def ConcatenateRows(tensors) -> Tensor:
    return ConcatOn(tensors, 0)


def ConcatenateColumns(tensors) -> Tensor:
    return ConcatOn(tensors, 1)


def CopyRows(t: Tensor, start: int, end: int) -> Tensor:
    return SliceOn(t, start, end, 0)


def CopyColumns(t: Tensor, start: int, end: int) -> Tensor:
    return SliceOn(t, start, end, 1)


def Stack(tensors, axis: int = 0) -> Tensor:
    with torch.no_grad():
        return _out(torch.stack(_common(tensors), dim=axis), tensors[0])


def Repeat(t: Tensor, repeats, axis=None) -> Tensor:
    x = t.data
    with torch.no_grad():
        if not isinstance(repeats, int):
            repeats = _operand(repeats, x.device).long()
        return _out(torch.repeat_interleave(x, repeats, dim=axis), t)


def Tile(t: Tensor, reps) -> Tensor:
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    with torch.no_grad():
        return _out(torch.tile(t.data, reps), t)


def Squeeze(t: Tensor, axis=None) -> Tensor:
    x = t.data
    axes = _axes(x, axis)
    if axis is not None and any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"cannot squeeze axes {axis} of shape {t.shape}: "
                         f"not of size one")
    axes = tuple(a for a in axes if x.shape[a] == 1)
    with torch.no_grad():
        return _out(_own(x.squeeze(axes) if axes else x), t)


def Unsqueeze(t: Tensor, axis) -> Tensor:
    x = t.data
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    nd = x.dim() + len(axes)
    with torch.no_grad():
        for a in sorted(a % nd for a in axes):
            x = x.unsqueeze(a)
        return _out(_own(x), t)


def Flatten(t: Tensor, start_axis: int = 1) -> Tensor:
    return t.reshape(t.shape[:start_axis] + (-1,))


def _fill_value(dtype):
    """``jnp.take``'s fill for an id out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _take(x: torch.Tensor, indices, axis: int,
          select=torch.index_select) -> torch.Tensor:
    """``jnp.take`` along ``axis`` in its fill mode (see the module
    docstring), on ``x``'s device with no host sync: the negative ids
    are wrapped, the ids clamped for ``select`` (``index_select``'s
    signature) and the invalid rows replaced by ``torch.where`` against
    the validity mask, so no id ever reaches a bound check."""
    i = _raw(indices)
    i = (i if isinstance(i, torch.Tensor)
         else _host_to_torch(i, x.device)).to(x.device).long()
    if not -x.dim() <= axis < x.dim():
        raise ValueError(f"axis {axis} is out of bounds for array of "
                         f"dimension {x.dim()}")
    ax = axis % x.dim()
    n = x.shape[ax]
    valid = (i >= -n) & (i < n)
    safe = torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0))
    out = select(x, ax, safe.reshape(-1))
    out = out.reshape(x.shape[:ax] + i.shape + x.shape[ax + 1:])
    mask = valid.reshape((1,) * ax + i.shape + (1,) * (x.dim() - ax - 1))
    return torch.where(mask, out, _fill_value(x.dtype))


def Gather(t: Tensor, indices, axis: int = 0) -> Tensor:
    with torch.no_grad():
        return _out(_take(t.data, indices, axis), t)


# --------------------------------------------------------------------------
# random fills (from the tensor's device generator), in place
# --------------------------------------------------------------------------

def Uniform(low, high, t: Tensor) -> Tensor:
    return t.uniform(low, high)


def Gaussian(mean, std, t: Tensor) -> Tensor:
    return t.gaussian(mean, std)


def Bernoulli(p, t: Tensor) -> Tensor:
    return t.bernoulli(p)


def Fill(t: Tensor, value) -> Tensor:
    return t.set_value(value)


# --------------------------------------------------------------------------
# row/column broadcast ops (reference: AddColumn/AddRow/... on 2-D
# tensors), in place on ``m`` where its dtype stays
# --------------------------------------------------------------------------

def _colop(fn, floating=False):
    def op(v: Tensor, m: Tensor) -> Tensor:
        _set_data(m, _bin(fn, m.data, v.data[:, None], floating))
        return m
    return op


def _rowop(fn, floating=False):
    def op(v: Tensor, m: Tensor) -> Tensor:
        _set_data(m, _bin(fn, m.data, v.data[None, :], floating))
        return m
    return op


AddColumn = _colop(torch.add)
SubColumn = _colop(_sub)
MultColumn = _colop(torch.mul)
DivColumn = _colop(torch.div, floating=True)
AddRow = _rowop(torch.add)
SubRow = _rowop(_sub)
MultRow = _rowop(torch.mul)
DivRow = _rowop(torch.div, floating=True)
