"""Define-by-run autograd of the port, on ``torch.autograd``.

Counterpart: ``singa_tpu/autograd.py`` — the module-level ``training``
flag, ``backward(y, dy)`` (:208), ``gradients(y)`` and the reference's
operator surface (:283-786) by its names, signatures and semantics: the
arithmetic and unary math (``add`` to ``erf``), the activations
(``relu``, ``leakyrelu``, ``elu``, ``selu``, ``sigmoid``, ``tanh``,
``gelu`` in the exact erf form, ``softplus``, ``softsign``,
``hardsigmoid``, ``softmax`` and ``logsoftmax`` with their float32
pin), ``matmul``, ``gemm``, ``add_bias``, ``linear``, ``einsum``, the
shape ops (``reshape``, ``transpose``, ``flatten``, ``cat``/``concat``,
``stack``, ``squeeze``, ``unsqueeze``, ``slice_``, ``split``,
``gather``, ``tile``, ``expand``, ``pad``, ``where``, ``cast``), the
reductions (``reduce_sum``, ``reduce_mean``, ``reduce_max``,
``reduce_min``, ``reduce_prod``, ``mean``), the losses
(``softmax_cross_entropy``/``cross_entropy``, ``binary_cross_entropy``,
``mse_loss``, ``nll_loss``), ``dropout``, the comparisons and
``argmax`` and ``onehot`` (no gradient, as the reference's ``_nograd``
ops), and ``checkpoint``.

The reference derives each op's backward with ``jax.vjp`` and walks its
own graph of cotangents; here an op is a torch expression on the
inputs' ``.data`` recorded by ``torch.autograd`` while ``training`` is
on (and computed without a graph while it is off).  Each output's
``creator`` is an :class:`Operation` that names the parameter leaves
(``stores_grad`` tensors) the output depends on, so :func:`backward`
knows which gradients to ask ``torch.autograd.grad`` for.  Host data
(numpy arrays, Python lists) among an op's operands is moved to the
device of its first Tensor operand.  The reference's graph engine
(``Dummy``, ``JaxOp``, ``infer_dependency``) and its ONNX export tags
have no counterpart: ``torch.autograd`` is the engine, and ONNX export
belongs to a later slice.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .tensor import Tensor, _host_to_torch, _take

__all__ = ["training", "Operation", "backward", "gradients", "op",
           "add", "sub", "mul", "div", "pow_", "negative", "abs_", "exp",
           "log", "sqrt", "square", "reciprocal", "sign", "clip", "maximum",
           "minimum", "sin", "cos", "tan", "sinh", "cosh", "asin", "acos",
           "atan", "asinh", "acosh", "atanh", "ceil", "floor", "erf",
           "relu", "leakyrelu", "elu", "selu", "sigmoid", "tanh", "gelu",
           "softplus", "softsign", "hardsigmoid", "softmax", "logsoftmax",
           "matmul", "gemm", "add_bias", "linear", "einsum", "reshape",
           "transpose", "flatten", "cat", "concat", "stack", "squeeze",
           "unsqueeze", "slice_", "split", "gather", "tile", "expand",
           "pad", "where", "cast", "reduce_sum", "reduce_mean",
           "reduce_max", "reduce_min", "reduce_prod", "mean",
           "softmax_cross_entropy", "cross_entropy", "binary_cross_entropy",
           "mse_loss", "nll_loss", "dropout", "less", "greater", "equal",
           "argmax", "onehot", "checkpoint"]

# module-level training flag (parity: ``autograd.training``); ops record
# a graph only while it is on
training = False


class Operation:
    """Provenance of an op's outputs: the op's name, the parameter leaves
    (``stores_grad`` tensors, by id) its inputs reach, and ``src``: for
    each Tensor input in argument order that is a parameter or an op's
    output, ``(its creator or None, the Tensor when it is a parameter
    or None)`` (the reference's ``Operation.src``, autograd.py:41-71,
    less the ids), the graph :func:`backward` walks for its order."""

    __slots__ = ("name", "leaves", "src")

    def __init__(self, name: str, leaves: dict, src=()):
        self.name = name
        self.leaves = leaves
        self.src = src


def op(name, fn, *xs):
    """An operator defined by a torch forward (the counterpart of the
    reference's ``JaxOp``): run ``fn`` on the ``.data`` of the Tensor
    arguments (other arguments pass as they are), record it while
    ``training`` is on, and wrap the result.  A forward that returns a
    tuple gives a tuple of Tensors, one recorded op with several outputs
    (the RNN's ``(y, hy, cy)``); each output that carries a gradient
    shares the op's creator.  A numpy array among the arguments moves
    to the first Tensor argument's device."""
    dev, raw = _raw(xs)
    with torch.set_grad_enabled(training):
        out = fn(*raw)
    outs = out if isinstance(out, tuple) else (out,)
    creator = None
    if training and any(o.requires_grad for o in outs):
        leaves, src = {}, []
        for x in xs:
            if not isinstance(x, Tensor):
                continue
            if x.stores_grad:
                leaves[id(x)] = x
            elif x.creator is not None:
                leaves.update(x.creator.leaves)
            if x.stores_grad or x.creator is not None:
                src.append((x.creator, x if x.stores_grad else None))
        creator = Operation(name, leaves, src)
    wrapped = tuple(
        Tensor(data=o, device=dev, requires_grad=o.requires_grad and
               creator is not None,
               creator=creator if o.requires_grad else None)
        for o in outs)
    return wrapped if isinstance(out, tuple) else wrapped[0]


def _raw(xs):
    """The first Tensor argument's device, and every argument as an op's
    function takes it: a Tensor's data, a numpy array moved to that
    device, anything else as it is."""
    dev = next((x.device for x in xs if isinstance(x, Tensor)), None)
    return dev, [x.data if isinstance(x, Tensor) else
                 _host_to_torch(x, dev.torch_device)
                 if isinstance(x, np.ndarray) and dev is not None else x
                 for x in xs]


def _nograd(fn, *xs):
    """A function of the Tensor arguments' data that records no gradient
    (reference ``_nograd``: comparisons, ``argmax``, ``onehot``)."""
    dev, raw = _raw(xs)
    with torch.no_grad():
        out = fn(*raw)
    return Tensor(data=out, device=dev, requires_grad=False)


# --------------------------------------------------------------------------
# backward (parity: reference ``backward`` / ``gradients``)
# --------------------------------------------------------------------------

def _emission_order(root: Operation) -> list:
    """The parameter leaves ``root`` reaches, in the order the
    reference's backward emits their gradients (autograd.py:181-273): a
    breadth-first walk from ``root`` that releases an op when its last
    consumer has been walked, and a leaf when its last consuming op has.
    ``DistOpt`` buckets and selects grads in this order, so it fixes the
    layout of the ZeRO-1 state and the rotation of ``partial``; an
    update of each parameter on its own needs no order and skips the
    walk."""
    counts, leaf_counts = {}, {}
    queue, seen = deque([root]), {id(root)}
    while queue:
        for src_op, leaf in queue.popleft().src:
            if leaf is not None:
                leaf_counts[id(leaf)] = leaf_counts.get(id(leaf), 0) + 1
            if src_op is None:
                continue
            counts[id(src_op)] = counts.get(id(src_op), 0) + 1
            if id(src_op) not in seen:
                seen.add(id(src_op))
                queue.append(src_op)
    order, ready, visited = [], deque([root]), set()
    while ready:
        cur = ready.popleft()
        if id(cur) in visited:
            continue
        visited.add(id(cur))
        for src_op, leaf in cur.src:
            if leaf is not None:
                leaf_counts[id(leaf)] -= 1
                if leaf_counts[id(leaf)] == 0:
                    order.append(leaf)
            elif src_op is not None:
                counts[id(src_op)] -= 1
                if counts[id(src_op)] == 0:
                    ready.append(src_op)
    return order


def backward(y: Tensor, dy=None, ordered: bool = False):
    """Gradients of ``y`` (with initial cotangent ``dy``, ones by
    default) for every parameter leaf ``y`` reaches: yields
    ``(param, grad)`` pairs, with ``ordered`` in the reference's order
    (:func:`_emission_order`), else in the order the forward first
    reached each leaf.  One call of ``torch.autograd.grad``; leaves that
    get no gradient are skipped."""
    if not training:
        raise RuntimeError("call autograd.backward() under training mode")
    if y.creator is None:
        raise RuntimeError("y has no creator (not produced by an op)")
    if dy is None:
        dy = torch.ones_like(y.data)
    elif isinstance(dy, Tensor):
        dy = dy.data
    leaves = (_emission_order(y.creator) if ordered
              else list(y.creator.leaves.values()))
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
# operators (parity: the reference's lowercase helpers, :283-786)
# --------------------------------------------------------------------------

def _unary(name, fn):
    def f(x):
        return op(name, fn, x)
    f.__name__ = name
    return f


def _binary(name, fn):
    def f(a, b):
        return op(name, fn, a, b)
    f.__name__ = name
    return f


# ---- arithmetic ----
add = _binary("add", torch.add)
sub = _binary("sub", torch.sub)
mul = _binary("mul", torch.mul)
div = _binary("div", torch.div)
pow_ = _binary("pow_", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
negative = _unary("negative", torch.neg)
abs_ = _unary("abs_", torch.abs)
exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", lambda v: 1.0 / v)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
erf = _unary("erf", torch.erf)


def clip(x, low, high):
    return op("Clip", lambda v: torch.clamp(v, low, high), x)


# ---- activations ----
# jax.nn.relu's derivative at 0 is 0, as torch.relu's
relu = _unary("relu", torch.relu)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
# exact (erf) form, as the reference; not the tanh approximation
gelu = _unary("gelu", lambda v: F.gelu(v, approximate="none"))
# jax.nn.softplus: logaddexp(x, 0)
softplus = _unary("softplus", lambda v: torch.logaddexp(v, torch.zeros_like(v)))
softsign = _unary("softsign", lambda v: v / (1 + torch.abs(v)))

# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def leakyrelu(x, a=0.01):
    return op("LeakyRelu", lambda v: torch.where(v >= 0, v, a * v), x)


def elu(x, alpha=1.0):
    return op("Elu", lambda v: torch.where(v > 0, v, alpha * (torch.exp(v)
                                                               - 1)), x)


def selu(x):
    return op("Selu", lambda v: _SELU_SCALE * torch.where(
        v > 0, v, _SELU_ALPHA * torch.expm1(v)), x)


def hardsigmoid(x, alpha=0.2, beta=0.5):
    return op("HardSigmoid", lambda v: torch.clamp(alpha * v + beta, 0.0,
                                                   1.0), x)


def softmax(x, axis=-1):
    # float32 accumulation pin (the reference's mixed-precision contract)
    return op("Softmax", lambda v: torch.softmax(
        v.to(torch.float32), dim=axis).to(v.dtype), x)


def logsoftmax(x, axis=-1):
    return op("LogSoftmax", lambda v: torch.log_softmax(
        v.to(torch.float32), dim=axis).to(v.dtype), x)


# ---- linear algebra ----
matmul = _binary("matmul", torch.matmul)


def _T(v):
    """``jnp``'s ``.T``: every axis reversed."""
    return v.permute(*reversed(range(v.dim())))


def gemm(a, b, c=None, alpha=1.0, beta=1.0, transA=0, transB=0):
    def fn(A, B, *rest):
        A = _T(A) if transA else A
        B = _T(B) if transB else B
        out = alpha * (A @ B)
        if rest:
            out = out + beta * rest[0]
        return out
    return op("Gemm", fn, a, b, *((c,) if c is not None else ()))


def add_bias(x, b, axis=-1):
    """Broadcast-add a bias vector (reference: ``AddBias`` op)."""
    def fn(v, bias):
        if axis in (-1, v.dim() - 1) or v.dim() == 1:
            return v + bias
        shape = [1] * v.dim()
        shape[axis if axis >= 0 else v.dim() + axis] = bias.shape[0]
        return v + bias.reshape(shape)
    return op("AddBias", fn, x, b)


def linear(x, w, b=None):
    y = matmul(x, w)
    if b is not None:
        y = add_bias(y, b)
    return y


def einsum(spec, *xs):
    return op("Einsum", lambda *vs: torch.einsum(spec, *vs), *xs)


# ---- shape ----
def reshape(x, shape):
    return op("Reshape", lambda v: v.reshape(tuple(shape)), x)


def transpose(x, axes=None):
    return op("Transpose", lambda v: v.permute(*axes) if axes is not None
              else _T(v), x)


def flatten(x, start_axis=1):
    """Flatten the trailing dims from ``start_axis``."""
    return op("Flatten", lambda v: v.reshape(tuple(v.shape[:start_axis])
                                             + (-1,)), x)


def cat(xs, axis=0):
    return op("Concat", lambda *vs: torch.cat(vs, dim=axis), *xs)


concat = cat


def stack(xs, axis=0):
    return op("Stack", lambda *vs: torch.stack(vs, dim=axis), *xs)


def squeeze(x, axis=None):
    return op("Squeeze", lambda v: v.squeeze() if axis is None
              else v.squeeze(axis), x)


def unsqueeze(x, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)

    def fn(v):
        for a in sorted(axes):
            v = v.unsqueeze(a)
        return v
    return op("Unsqueeze", fn, x)


def slice_(x, starts, ends, axes=None, steps=None):
    """``x[starts:ends:steps]`` along ``axes`` (all from 0 when None);
    a negative step reverses, as in numpy."""
    ax = axes if axes is not None else list(range(len(starts)))
    st = steps if steps is not None else [1] * len(starts)

    def fn(v):
        for a, s, e, p in zip(ax, starts, ends, st):
            if p > 0:
                idx = [slice(None)] * v.dim()
                idx[a] = slice(s, e, p)
                v = v[tuple(idx)]
            else:
                rows = list(range(v.shape[a])[slice(s, e, p)])
                v = v.index_select(a, torch.tensor(rows, dtype=torch.long,
                                                   device=v.device))
        return v
    return op("Slice", fn, x)


def split(x, parts, axis=0):
    """Split into ``len(parts)`` pieces of the given sizes (a multi-output
    op)."""
    return op("Split", lambda v: tuple(torch.split(v, list(parts), dim=axis)),
              x)


class _Take(torch.autograd.Function):
    """``index_select`` along ``ax`` whose backward adds repeated ids with
    ``index_put_(accumulate=True)``, which on CUDA sorts the ids and sums
    each id's rows in one order: ``index_select``'s own backward
    (``index_add_``) adds them with atomics in whatever order the threads
    arrive, so the embedding gradient, and everything a step computes
    after it, would differ in the last bits from run to run.  No host
    sync either way."""

    @staticmethod
    def forward(ctx, v, ax, idx):
        ctx.save_for_backward(idx)
        ctx.ax, ctx.shape = ax, v.shape
        return torch.index_select(v, ax, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rows = g.movedim(ctx.ax, 0)
        out = rows.new_zeros((ctx.shape[ctx.ax],) + rows.shape[1:])
        out.index_put_((idx,), rows, accumulate=True)
        return out.movedim(0, ctx.ax), None, None


def gather(x, indices, axis=0):
    """``take`` along ``axis`` (the embedding lookup): the output has
    ``indices``' shape in place of that axis; repeated ids scatter-add
    their gradients.

    Ids follow ``jnp.take``'s default (fill) mode, as the reference's
    ``gather`` does: an id in ``[-n, 0)`` counts from the end (``-1`` is
    the last row); an id outside ``[-n, n)`` gives a row of NaN (of the
    dtype's minimum for signed integers, its maximum for unsigned ones,
    True for booleans), and no gradient flows from that row to any row
    of ``x``; on the tensor's device with no host sync (``tensor._take``,
    the same take as ``tensor.Gather``).  The gradient sums repeated ids
    in a fixed order (:class:`_Take`), so a training step gives the same
    result run after run."""
    return op("Gather", lambda v, i: _take(v, i, axis, _Take.apply), x,
              indices)


def tile(x, reps):
    reps = tuple(reps) if hasattr(reps, "__len__") else (reps,)
    return op("Tile", lambda v: v.tile(reps), x)


def expand(x, shape):
    return op("Expand", lambda v: v.broadcast_to(tuple(shape)), x)


def _pad_index(n, before, after, mode, device):
    """Source index along one axis of ``jnp.pad``'s non-constant
    ``mode``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        m = i % (2 * n - 2)
        return torch.where(m >= n, 2 * n - 2 - m, m)
    if mode == "symmetric":
        m = i % (2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    raise NotImplementedError(f"pad mode {mode!r} (constant, edge, wrap, "
                              f"reflect, symmetric)")


def pad(x, pads, mode="constant", value=0.0):
    """ONNX-style pads ``[b0, b1, ..., e0, e1, ...]``; ``mode`` as
    ``jnp.pad``'s (constant, edge, wrap, reflect, symmetric)."""
    def fn(v):
        n = v.dim()
        width = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
        if mode == "constant":
            flat = [w for b, e in reversed(width) for w in (b, e)]
            return F.pad(v, flat, mode="constant", value=value)
        for a, (b, e) in enumerate(width):
            if b or e:
                v = v.index_select(a, _pad_index(v.shape[a], b, e, mode,
                                                 v.device))
        return v
    return op("Pad", fn, x)


def where(cond, a, b):
    c = cond.data if isinstance(cond, Tensor) else cond
    return op("Where", lambda u, w: torch.where(
        torch.as_tensor(c, device=u.device), u, w), a, b)


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, its name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str)
                   else np.dtype(dtype).name)


def cast(x, dtype):
    dt = _torch_dtype(dtype)
    return op("Cast", lambda v: v.to(dt), x)


# ---- reductions ----
def _reduce(name, fn, x, axes, keepdims):
    """``fn(v, dims, keepdims)`` over ``axes`` (every axis when None;
    none when empty, so ``axes=[]`` returns ``x``'s values unchanged,
    as ``jnp``'s ``axis=()`` does, where torch would read ``dim=()`` as
    every axis)."""
    def f(v):
        if axes is None:
            dims = tuple(range(v.dim()))
        else:
            dims = tuple(axes) if isinstance(axes, (list, tuple)) \
                else (axes,)
        if not dims:
            return v
        return fn(v, dims, keepdims)
    return op(name, f, x)


def reduce_sum(x, axes=None, keepdims=False):
    return _reduce("ReduceSum", lambda v, d, k: v.sum(dim=d, keepdim=k), x,
                   axes, keepdims)


def reduce_mean(x, axes=None, keepdims=False):
    return _reduce("ReduceMean", lambda v, d, k: v.mean(dim=d, keepdim=k), x,
                   axes, keepdims)


def reduce_max(x, axes=None, keepdims=False):
    return _reduce("ReduceMax", lambda v, d, k: torch.amax(v, dim=d,
                                                           keepdim=k),
                   x, axes, keepdims)


def reduce_min(x, axes=None, keepdims=False):
    return _reduce("ReduceMin", lambda v, d, k: torch.amin(v, dim=d,
                                                           keepdim=k),
                   x, axes, keepdims)


def _prod(v, dims, keepdims):
    for d in sorted((d % v.dim() for d in dims), reverse=True):
        v = v.prod(dim=d, keepdim=keepdims)
    return v


def reduce_prod(x, axes=None, keepdims=False):
    return _reduce("ReduceProd", _prod, x, axes, keepdims)


def mean(xs_or_x, axis=None):
    """Reference ``autograd.mean``: the mean of a list of tensors, or
    ``reduce_mean`` of one."""
    if isinstance(xs_or_x, (list, tuple)):
        return op("Mean", lambda *vs: sum(vs) / len(vs), *xs_or_x)
    return reduce_mean(xs_or_x, axis)


# ---- losses ----
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


cross_entropy = softmax_cross_entropy


def binary_cross_entropy(probs, target):
    t = target.data if isinstance(target, Tensor) else target

    def fn(p):
        tt = torch.as_tensor(t, device=p.device).to(torch.float32)
        p_ = torch.clamp(p.to(torch.float32), 1e-7, 1 - 1e-7)
        return torch.mean(-(tt * torch.log(p_)
                            + (1 - tt) * torch.log(1 - p_)))
    return op("BinaryCrossEntropy", fn, probs)


def mse_loss(x, target):
    # float32 pin on the squared-error mean
    def fn(v, t):
        t = torch.as_tensor(t, device=v.device)
        return torch.mean(torch.square(v.to(torch.float32)
                                       - t.to(torch.float32)))
    return op("MSELoss", fn, x, target)


def nll_loss(logp, target):
    t = target.data if isinstance(target, Tensor) else target

    def fn(v):
        tt = torch.as_tensor(t, device=v.device).long()
        return -torch.mean(torch.gather(v.to(torch.float32), -1,
                                        tt[..., None]))
    return op("NLLLoss", fn, logp)


# ---- regularisation ----
def dropout(x, p=0.5):
    """Inverted dropout: outside training, or at ``p`` 0, ``x`` itself;
    otherwise each value is kept with probability ``keep = 1 - p`` and
    scaled to ``v / keep``, the mask drawn from the generator of
    ``x``'s device (the reference draws from the device's RNG key).  In
    a captured step that generator is registered with the graph, so
    every replay draws a fresh mask, as the eager step does."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    gen = x.device.generator

    def fn(v):
        mask = torch.rand(v.shape, generator=gen, device=v.device) < keep
        return torch.where(mask, v / keep, 0.0).to(v.dtype)
    return op("Dropout", fn, x)


# ---- comparison (no grad) ----
def less(a, b):
    return _nograd(torch.lt, a, b)


def greater(a, b):
    return _nograd(torch.gt, a, b)


def equal(a, b):
    return _nograd(torch.eq, a, b)


def argmax(x, axis=-1):
    # int32, as jnp.argmax's
    return _nograd(lambda v: torch.argmax(v, dim=axis).to(torch.int32), x)


def onehot(x, depth, dtype=torch.float32):
    """One-hot of integer ids along a new last axis of size ``depth``
    (``jax.nn.one_hot``: an id outside ``[0, depth)`` gives a row of
    zeros).  Records no gradient.  Computed by comparison with
    ``arange(depth)``, so int32 ids need no widening to int64 as
    ``F.one_hot`` would."""
    dt = _torch_dtype(dtype)

    def fn(v):
        v = torch.as_tensor(v)
        cls = torch.arange(depth, dtype=v.dtype, device=v.device)
        return (v[..., None] == cls).to(dt)
    return _nograd(fn, x)


def checkpoint(fn, *xs, name: str | None = None):
    """Run a block of torch code on the Tensors' data as ONE
    rematerialised op: ``y = autograd.checkpoint(lambda a, b: ..., x1,
    x2)``.  Its backward recomputes the block's intermediates from its
    inputs (``torch.utils.checkpoint``) instead of storing them, as the
    reference's ``jax.checkpoint``."""
    def run(*vs):
        if not torch.is_grad_enabled():
            return fn(*vs)
        return torch.utils.checkpoint.checkpoint(fn, *vs,
                                                 use_reentrant=False)
    return op(name or "Checkpoint", run, *xs)
