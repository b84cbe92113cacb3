"""The elementwise catalogue: a hand-written CUDA kernel and its plain
PyTorch versions.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``ew_unary``,
``ew_binary`` and ``clamp`` (the entries), ``_ew_call`` with
``_unary_kernel`` / ``_binary_kernel`` (the Pallas TPU kernels) and the
dicts ``EW_UNARY`` / ``EW_BINARY`` of plain functions.  The kernel source
is ``csrc/elementwise.cu``: one kernel per arity, templated on the op and
on the input and output types, over 16-byte vectors.  ``_vector_split``
cuts the flat operands into a head of single values, a body of 16-byte
units (``16 / smaller element size`` values, so float32 to bfloat16 is
two loads to one store) and a tail, from the operands' addresses;
operands whose misalignments differ run element by element in the same
kernel.  The output is a plain ``torch.empty``.

Names, as the reference's: unary ``relu abs exp log sqrt square sign
sigmoid tanh gelu`` (``gelu`` is the tanh form, ``jax.nn.gelu``'s
default, not the erf form of ``autograd.gelu``), plus ``copy``, which with
``out_dtype`` is the dtype converter; binary ``add sub mult div pow max min
threshold`` (``threshold(x, t)`` is ``x < t`` as 1 or 0); ``clamp(x, low,
high)``.  ``max``, ``min``, ``relu`` and ``clamp`` propagate NaN as
``jnp.maximum`` / ``jnp.minimum`` do.

Types: float32, bfloat16 and float16, in and out; any other dtype raises.
Values are computed in float32 and rounded once to the output type.
Binary operands share shape and dtype.  Routing: the tensor's device
decides.  CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["EW_UNARY", "EW_BINARY", "ew_unary", "ew_binary", "clamp",
           "ew_unary_reference", "ew_binary_reference", "clamp_reference"]

# kernel launches made by ew_unary / ew_binary / clamp (plain-version
# calls and CPU calls do not count)
launches = 0

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _relu(x):
    return torch.where((x > 0) | torch.isnan(x), x, torch.zeros_like(x))


def _sign(x):
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _gelu(x):
    # jax.nn.gelu(approximate=True), in its order of operations
    k = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(k * (x + 0.044715 * (x * x * x)))))


# name -> plain function of float32 tensors (the reference's EW_UNARY)
EW_UNARY = {
    "relu": _relu,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "square": lambda x: x * x,
    "sign": _sign,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": _gelu,
}

EW_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mult": torch.mul,
    "div": torch.div,
    "pow": torch.pow,
    "max": torch.maximum,
    "min": torch.minimum,
    # reference cuda::threshold: out[i] = in[i] < t[i] ? 1 : 0
    "threshold": lambda x, t: (x < t).to(torch.float32),
}

# the kernel's codes (csrc/elementwise.cu)
_UNARY_CODE = {n: i for i, n in enumerate(list(EW_UNARY) + ["copy"])}
_CLAMP_CODE = len(_UNARY_CODE)
_BINARY_CODE = {n: i for i, n in enumerate(EW_BINARY)}
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _dtype_of(t, out_dtype):
    """The output dtype; raises on a dtype the catalogue does not take."""
    out = t.dtype if out_dtype is None else out_dtype
    for d in (t.dtype, out):
        if d not in _TYPE_CODE:
            raise TypeError(f"the elementwise catalogue takes float32, "
                            f"bfloat16 and float16, got {d}")
    return out


def ew_unary_reference(name, x, out_dtype=None):
    """Plain version of :func:`ew_unary`, on any device."""
    out = _dtype_of(x, out_dtype)
    xf = x.to(torch.float32)
    return (xf if name == "copy" else EW_UNARY[name](xf)).to(out)


def ew_binary_reference(name, a, b, out_dtype=None):
    """Plain version of :func:`ew_binary`, on any device."""
    out = _dtype_of(a, out_dtype)
    return EW_BINARY[name](a.to(torch.float32), b.to(torch.float32)).to(out)


def clamp_reference(x, low, high):
    """Plain version of :func:`clamp`: NaN stays NaN, as ``jnp.clip``."""
    _dtype_of(x, None)
    lo, hi = (torch.tensor(float(v), dtype=torch.float32, device=x.device)
              for v in (low, high))
    return torch.minimum(torch.maximum(x.to(torch.float32), lo),
                         hi).to(x.dtype)


def _lib():
    lib = _build.load("elementwise")
    if lib.singa_ew_unary.argtypes is None:
        ll = ctypes.c_longlong
        lib.singa_ew_unary.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ll, ll, ll,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p])
        lib.singa_ew_unary.restype = ctypes.c_int
        lib.singa_ew_binary.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ll, ll, ll, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.singa_ew_binary.restype = ctypes.c_int
    return lib


def _vector_split(n, operands):
    """``(head, units, tail)`` for ``n`` values of the operands ``[(address,
    element size), ...]``: ``head`` single values until every operand
    sits on a 16-byte boundary at once, then ``units`` units of ``W = 16
    / (smallest element size)`` values, then ``tail`` single values.
    When no such boundary exists within the first ``W`` values (the
    operands' misalignments differ), ``(n, 0, 0)``: element by element."""
    W = 16 // min(e for _, e in operands)
    for head in range(W):
        if all((p + head * e) % 16 == 0 for p, e in operands):
            break
    else:
        return n, 0, 0
    if head >= n:
        return n, 0, 0
    units = (n - head) // W
    return head, units, n - head - units * W


def _route(ops, what):
    """``"cpu"`` or ``"cuda"`` by the operands' device; raises on mixed
    devices, another device type, or a non-contiguous CUDA operand."""
    dev = ops[0].device
    if any(t.device != dev for t in ops):
        raise ValueError(f"{what}: operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{what} kernel takes contiguous operands")
    return dev.type


def _launch_unary(code, x, out, lo=0.0, hi=0.0):
    global launches
    y = torch.empty(x.shape, dtype=out, device=x.device)
    n = x.numel()
    if n == 0:
        return y
    head, units, _ = _vector_split(n, [(x.data_ptr(), x.element_size()),
                                       (y.data_ptr(), y.element_size())])
    err = _lib().singa_ew_unary(
        code, x.data_ptr(), y.data_ptr(), n, head, units,
        _TYPE_CODE[x.dtype], _TYPE_CODE[out], lo, hi,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elementwise kernel launch failed (cudaError "
                           f"{err})")
    launches += 1
    return y


def ew_unary(name, x, out_dtype=None):
    """One catalogue unary op (``ew_unary("relu", x)``); ``name="copy"``
    with ``out_dtype`` converts the dtype.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/elementwise.cu`` or raise."""
    if name not in _UNARY_CODE:
        raise KeyError(f"unknown elementwise unary op {name!r}")
    out = _dtype_of(x, out_dtype)
    if _route([x], "ew_unary") == "cpu":
        return ew_unary_reference(name, x, out_dtype)
    return _launch_unary(_UNARY_CODE[name], x, out)


def ew_binary(name, a, b, out_dtype=None):
    """One catalogue binary op on same-shape, same-dtype ``a`` and ``b``.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/elementwise.cu`` or raise."""
    global launches
    if name not in _BINARY_CODE:
        raise KeyError(f"unknown elementwise binary op {name!r}")
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"ew_binary: operands {tuple(a.shape)} {a.dtype} "
                         f"and {tuple(b.shape)} {b.dtype} differ")
    out = _dtype_of(a, out_dtype)
    if _route([a, b], "ew_binary") == "cpu":
        return ew_binary_reference(name, a, b, out_dtype)
    y = torch.empty(a.shape, dtype=out, device=a.device)
    n = a.numel()
    if n == 0:
        return y
    head, units, _ = _vector_split(n, [(t.data_ptr(), t.element_size())
                                       for t in (a, b, y)])
    err = _lib().singa_ew_binary(
        _BINARY_CODE[name], a.data_ptr(), b.data_ptr(), y.data_ptr(), n,
        head, units, _TYPE_CODE[a.dtype], _TYPE_CODE[out],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elementwise kernel launch failed (cudaError "
                           f"{err})")
    launches += 1
    return y


def clamp(x, low, high):
    """``x`` clipped to ``[low, high]`` in its own dtype (reference
    ``cuda::clamp``).  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/elementwise.cu`` or raise."""
    _dtype_of(x, None)
    if _route([x], "clamp") == "cpu":
        return clamp_reference(x, low, high)
    return _launch_unary(_CLAMP_CODE, x, x.dtype, float(low), float(high))
