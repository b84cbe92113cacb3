"""Define-by-run autograd of the port, on ``torch.autograd``.

Counterpart: ``singa_tpu/autograd.py`` — the module-level ``training``
flag, ``backward(y, dy)`` (:208), ``gradients(y)`` and the operators the
training path runs, by the reference's names and semantics: ``add``,
``mul``, ``matmul``, ``add_bias``, ``reshape``, ``transpose``,
``gather``, ``relu``, ``gelu`` (the exact erf form), ``softmax``
(float32 pin), ``softmax_cross_entropy`` (mean; integer or one-hot
targets), ``cast``,
``reduce_mean`` and ``onehot`` (no gradient, as the reference's
``_nograd`` ops).

The reference derives each op's backward with ``jax.vjp`` and walks its
own graph of cotangents; here an op is a torch expression on the
inputs' ``.data`` recorded by ``torch.autograd`` while ``training`` is
on (and computed without a graph while it is off).  Each output's
``creator`` is an :class:`Operation` that names the parameter leaves
(``stores_grad`` tensors) the output depends on, so :func:`backward`
knows which gradients to ask ``torch.autograd.grad`` for.  The rest of
the reference's catalogue belongs to a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .tensor import Tensor

__all__ = ["training", "Operation", "backward", "gradients", "add", "mul",
           "matmul", "add_bias", "reshape", "transpose", "gather", "relu",
           "gelu", "softmax", "softmax_cross_entropy", "cast", "reduce_mean",
           "onehot", "op"]

# module-level training flag (parity: ``autograd.training``); ops record
# a graph only while it is on
training = False


class Operation:
    """Provenance of an op's outputs: the op's name and the parameter
    leaves (``stores_grad`` tensors, by id) its inputs reach."""

    __slots__ = ("name", "leaves")

    def __init__(self, name: str, leaves: dict):
        self.name = name
        self.leaves = leaves


def op(name, fn, *xs):
    """An operator defined by a torch forward (the counterpart of the
    reference's ``JaxOp``): run ``fn`` on the ``.data`` of the Tensor
    arguments (other arguments pass as they are), record it while
    ``training`` is on, and wrap the result.  A forward that returns a
    tuple gives a tuple of Tensors, one recorded op with several outputs
    (the RNN's ``(y, hy, cy)``); each output that carries a gradient
    shares the op's creator."""
    raw = [x.data if isinstance(x, Tensor) else x for x in xs]
    with torch.set_grad_enabled(training):
        out = fn(*raw)
    dev = next(x.device for x in xs if isinstance(x, Tensor))
    outs = out if isinstance(out, tuple) else (out,)
    creator = None
    if training and any(o.requires_grad for o in outs):
        leaves = {}
        for x in xs:
            if not isinstance(x, Tensor):
                continue
            if x.stores_grad:
                leaves[id(x)] = x
            elif x.creator is not None:
                leaves.update(x.creator.leaves)
        creator = Operation(name, leaves)
    wrapped = tuple(
        Tensor(data=o, device=dev, requires_grad=o.requires_grad and
               creator is not None,
               creator=creator if o.requires_grad else None)
        for o in outs)
    return wrapped if isinstance(out, tuple) else wrapped[0]


def _nograd(fn, *xs):
    """A function of the Tensor arguments' data that records no gradient
    (reference ``_nograd``: comparisons, ``argmax``, ``onehot``)."""
    raw = [x.data if isinstance(x, Tensor) else x for x in xs]
    with torch.no_grad():
        out = fn(*raw)
    dev = next((x.device for x in xs if isinstance(x, Tensor)), None)
    return Tensor(data=out, device=dev, requires_grad=False)


# --------------------------------------------------------------------------
# backward (parity: reference ``backward`` / ``gradients``)
# --------------------------------------------------------------------------

def backward(y: Tensor, dy=None):
    """Gradients of ``y`` (with initial cotangent ``dy``, ones by
    default) for every parameter leaf ``y`` reaches: yields
    ``(param, grad)`` pairs, as the reference does.  One call of
    ``torch.autograd.grad``; leaves that get no gradient are skipped."""
    if not training:
        raise RuntimeError("call autograd.backward() under training mode")
    if y.creator is None:
        raise RuntimeError("y has no creator (not produced by an op)")
    if dy is None:
        dy = torch.ones_like(y.data)
    elif isinstance(dy, Tensor):
        dy = dy.data
    leaves = list(y.creator.leaves.values())
    grads = torch.autograd.grad(y.data, [t.data for t in leaves],
                                grad_outputs=torch.as_tensor(dy).to(y.data),
                                allow_unused=True)
    for t, g in zip(leaves, grads):
        if g is not None:
            yield t, Tensor(data=g, device=t.device, requires_grad=False)


def gradients(y: Tensor, dy=None) -> dict:
    """Run backward and return ``{param_tensor: grad_tensor}``."""
    return dict(backward(y, dy))


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------

def add(a, b):
    return op("Add", torch.add, a, b)


def mul(a, b):
    return op("Mul", torch.mul, a, b)


def matmul(a, b):
    return op("MatMul", torch.matmul, a, b)


def add_bias(x, b, axis=-1):
    """Broadcast-add a bias vector (reference: ``AddBias`` op)."""
    def fn(v, bias):
        if axis in (-1, v.dim() - 1) or v.dim() == 1:
            return v + bias
        shape = [1] * v.dim()
        shape[axis if axis >= 0 else v.dim() + axis] = bias.shape[0]
        return v + bias.reshape(shape)
    return op("AddBias", fn, x, b)


def reshape(x, shape):
    return op("Reshape", lambda v: v.reshape(tuple(shape)), x)


def transpose(x, axes=None):
    def fn(v):
        return v.permute(*axes) if axes is not None else \
            v.permute(*reversed(range(v.dim())))
    return op("Transpose", fn, x)


def gather(x, indices, axis=0):
    """``take`` along ``axis`` (the embedding lookup): the output has
    ``indices``' shape in place of that axis; repeated ids scatter-add
    their gradients.

    Ids follow ``jnp.take``'s default (fill) mode, as the reference's
    ``gather`` does: an id in ``[-n, 0)`` counts from the end (``-1`` is
    the last row); an id outside ``[-n, n)`` gives a row of NaN (of the
    dtype's minimum for signed integers, its maximum for unsigned ones,
    True for booleans), and no gradient flows from that row to any row
    of ``x``.  All of it on the tensor's device, with no host sync: the
    negatives are wrapped, the ids clamped for ``index_select`` and the
    invalid rows replaced by ``torch.where`` against the validity mask,
    so no id ever reaches a bound check."""
    def fn(v, i):
        i = torch.as_tensor(i, device=v.device).long()
        ax = axis if axis >= 0 else v.dim() + axis
        n = v.shape[ax]
        valid = (i >= -n) & (i < n)
        safe = torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0))
        out = torch.index_select(v, ax, safe.reshape(-1))
        out = out.reshape(v.shape[:ax] + i.shape + v.shape[ax + 1:])
        mask = valid.reshape((1,) * ax + i.shape + (1,) * (v.dim() - ax - 1))
        return torch.where(mask, out, _fill_value(v.dtype))
    return op("Gather", fn, x, indices)


def _fill_value(dtype):
    """``jnp.take``'s fill for an id out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def relu(x):
    # jax.nn.relu's derivative at 0 is 0, as torch.relu's
    return op("Relu", torch.relu, x)


def gelu(x):
    # exact (erf) form, as the reference; not the tanh approximation
    return op("Gelu", lambda v: F.gelu(v, approximate="none"), x)


def softmax(x, axis=-1):
    # float32 accumulation pin (the reference's mixed-precision contract)
    return op("Softmax", lambda v: torch.softmax(
        v.to(torch.float32), dim=axis).to(v.dtype), x)


def softmax_cross_entropy(logits, target):
    """Mean softmax cross-entropy over the rows; integer or one-hot
    targets (parity: reference ``SoftMaxCrossEntropy``).  The target
    carries no gradient."""
    t = target.data if isinstance(target, Tensor) else target

    def fn(lg):
        tt = torch.as_tensor(t, device=lg.device)
        logp = torch.log_softmax(lg.to(torch.float32), dim=-1)
        if tt.dim() == lg.dim():
            nll = -(tt.to(torch.float32) * logp).sum(dim=-1)
        else:
            nll = -torch.gather(logp, -1, tt.long()[..., None])[..., 0]
        return nll.mean()
    return op("SoftmaxCrossEntropy", fn, logits)


def cast(x, dtype):
    return op("Cast", lambda v: v.to(dtype), x)


def reduce_mean(x, axes=None, keepdims=False):
    """Mean over ``axes`` (all when None; none when empty, so ``axes=[]``
    returns ``x`` unchanged, as ``jnp.mean(axis=())`` does, where torch
    would read ``dim=()`` as every axis)."""
    def fn(v):
        if axes is None:
            return v.mean(dim=tuple(range(v.dim())), keepdim=keepdims)
        ax = axes if isinstance(axes, (list, tuple)) else (axes,)
        if len(ax) == 0:
            return v
        return v.mean(dim=tuple(ax), keepdim=keepdims)
    return op("ReduceMean", fn, x)


def onehot(x, depth, dtype=torch.float32):
    """One-hot of integer ids along a new last axis of size ``depth``
    (``jax.nn.one_hot``: an id outside ``[0, depth)`` gives a row of
    zeros).  Records no gradient.  Computed by comparison with
    ``arange(depth)``, so int32 ids need no widening to int64 as
    ``F.one_hot`` would."""
    def fn(v):
        v = torch.as_tensor(v)
        cls = torch.arange(depth, dtype=v.dtype, device=v.device)
        return (v[..., None] == cls).to(dtype)
    return _nograd(fn, x)
