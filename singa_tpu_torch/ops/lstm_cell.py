"""The fused LSTM cell: hand-written CUDA kernels (forward and backward)
and their plain PyTorch versions.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``lstm_cell_fused``
(the entry, a ``custom_vjp``), ``_lstm_fwd_impl`` / ``_lstm_kernel`` (the
Pallas TPU kernel) and ``_lstm_cell_bwd`` (the backward, a recompute in
plain XLA).  The kernel source is ``csrc/lstm_cell.cu``.

One step of an LSTM on UNPACKED operands: ``xw (B, 4H)`` (the hoisted
input product ``x @ W_ih``), ``h, c (B, H)``, ``W_hh (H, 4H)``, ``b
(4H,)``, the gate blocks in the order i, f, g, o::

    gates = xw + h @ W_hh + b
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')

All five operands are upcast to float32, the step is computed in float32
and ``h'``, ``c'`` are rounded once to their dtypes, as the reference
kernel does; float32, bfloat16 and float16 operands run on the card.
The reference packs each gate block to a 128-lane boundary and pads the
batch to 8 for the TPU's tiles; the port does neither, so the layout is
``ops/rnn.py``'s own.

:func:`lstm_cell_fused` is differentiable.  Its backward is the
reference's: the gates are recomputed from the saved operands and the
cotangents follow in closed form.  The recompute and the pointwise part
are one kernel launch (:func:`lstm_cell_backward`, which writes
``dgates``, ``dc_prev`` and ``h1 = [h, 1]``); ``dh = dgates @ W_hh^T``
and ``[dW_hh; db] = h1^T @ dgates`` are the plain products the reference
leaves to XLA (the row of ones turns its sum over the batch into the
product's last row).  Routing: the tensor's device decides.  CPU
tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lstm_cell_fused", "lstm_cell_reference", "lstm_cell_forward",
           "lstm_cell_backward", "lstm_cell_backward_reference",
           "cell_backward", "grid", "grid_blocks"]

# kernel launches made by lstm_cell_forward (launches) and by
# lstm_cell_backward (launches_bwd); plain-version and CPU calls do not
# count
launches = 0
launches_bwd = 0

# operand dtypes the kernels take, by their code in csrc/lstm_cell.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels' tile (csrc/lstm_cell.cu): batch rows and units a block
_BT, _JT = 16, 8


def _gates(xw, h, W_hh, b):
    """``(i, f, g, o)`` activated, in float32."""
    f32 = torch.float32
    gates = xw.to(f32) + h.to(f32) @ W_hh.to(f32) + b.to(f32)
    i, f, g, o = gates.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)


def lstm_cell_reference(xw, h, c, W_hh, b):
    """Plain PyTorch version, on any device: ``(h', c')``, computed in
    float32 and rounded once to ``h``'s and ``c``'s dtypes."""
    i, f, g, o = _gates(xw, h, W_hh, b)
    c_new = f * c.to(torch.float32) + i * g
    return (o * torch.tanh(c_new)).to(h.dtype), c_new.to(c.dtype)


def lstm_cell_backward_reference(xw, h, c, W_hh, b, dh_out, dc_out):
    """Plain PyTorch version of the backward kernel, on any device:
    ``(dgates (B, 4H), dc_prev (B, H), h1 (B, H + 1))`` in float32 (the
    reference's ``_lstm_cell_bwd``; ``dxw`` is ``dgates``; ``h1`` is
    ``h`` with a column of ones appended)."""
    f32 = torch.float32
    i, f, g, o = _gates(xw, h, W_hh, b)
    cf = c.to(f32)
    tc = torch.tanh(f * cf + i * g)
    dh, dc = dh_out.to(f32), dc_out.to(f32)
    dc_tot = dc + dh * o * (1 - tc * tc)
    dgates = torch.cat([dc_tot * g * i * (1 - i),
                        dc_tot * cf * f * (1 - f),
                        dc_tot * i * (1 - g * g),
                        dh * tc * o * (1 - o)], dim=-1)
    h1 = torch.cat([h.to(f32), torch.ones_like(cf[:, :1])], dim=-1)
    return dgates, dc_tot * f, h1


def _lib(name):
    fn = getattr(_build.load("lstm_cell"), name)
    if fn.argtypes is None:
        n_ptr = 7 if name == "singa_lstm_cell" else 10
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_operands(xw, h, c, W_hh, b):
    """Raise on anything the kernel does not take."""
    if h.dim() != 2:
        raise ValueError(f"lstm_cell: h must be (B, H), got {tuple(h.shape)}")
    B, H = h.shape
    want = {"xw": (xw, (B, 4 * H)), "c": (c, (B, H)),
            "W_hh": (W_hh, (H, 4 * H)), "b": (b, (4 * H,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_cell: {name} is {tuple(t.shape)}, "
                             f"expected {shape} for h {(B, H)}")
    ops = (xw, h, c, W_hh, b)
    if h.dtype not in _DTYPES or any(t.dtype != h.dtype for t in ops):
        raise TypeError(f"lstm_cell kernel takes float32, bfloat16 or "
                        f"float16 operands of one dtype, got "
                        f"{[t.dtype for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("lstm_cell kernel takes contiguous operands")


def _route(ops):
    """The operands' common device, a CPU or a CUDA one; raises on
    anything else."""
    dev = ops[1].device
    if any(t.device != dev for t in ops):
        raise ValueError("lstm_cell: operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_cell: unsupported device {dev}")
    return dev


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"lstm_cell {what} kernel launch failed "
                           f"(cudaError {err})")


def lstm_cell_forward(xw, h, c, W_hh, b):
    """One cell step without autograd: ``(h', c')`` in fresh buffers.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/lstm_cell.cu`` or raise."""
    global launches
    dev = _route((xw, h, c, W_hh, b))
    if dev.type == "cpu":
        return lstm_cell_reference(xw, h, c, W_hh, b)
    _check_kernel_operands(xw, h, c, W_hh, b)
    B, H = h.shape
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    _raise_on(_lib("singa_lstm_cell")(
        xw.data_ptr(), h.data_ptr(), c.data_ptr(), W_hh.data_ptr(),
        b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, H,
        _DTYPES[h.dtype], torch.cuda.current_stream(dev).cuda_stream),
        "forward")
    launches += 1
    return h_out, c_out


def lstm_cell_backward(xw, h, c, W_hh, b, dh_out, dc_out):
    """The backward's recompute and pointwise part without autograd:
    ``(dgates, dc_prev, h1)`` in float32 (see
    :func:`lstm_cell_backward_reference`).  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/lstm_cell.cu``'s backward kernel
    or raise.  The cotangents are taken in the operands' dtype."""
    global launches_bwd
    dev = _route((xw, h, c, W_hh, b, dh_out, dc_out))
    if dev.type == "cpu":
        return lstm_cell_backward_reference(xw, h, c, W_hh, b, dh_out,
                                            dc_out)
    _check_kernel_operands(xw, h, c, W_hh, b)
    B, H = h.shape
    if dh_out.shape != h.shape or dc_out.shape != h.shape:
        raise ValueError(f"lstm_cell: cotangents {tuple(dh_out.shape)}, "
                         f"{tuple(dc_out.shape)}, expected {(B, H)}")
    dh_out = dh_out.to(h.dtype).contiguous()
    dc_out = dc_out.to(h.dtype).contiguous()
    dgates = torch.empty(B, 4 * H, dtype=torch.float32, device=dev)
    dc_prev = torch.empty(B, H, dtype=torch.float32, device=dev)
    h1 = torch.empty(B, H + 1, dtype=torch.float32, device=dev)
    _raise_on(_lib("singa_lstm_cell_bwd")(
        xw.data_ptr(), h.data_ptr(), c.data_ptr(), W_hh.data_ptr(),
        b.data_ptr(), dh_out.data_ptr(), dc_out.data_ptr(),
        dgates.data_ptr(), dc_prev.data_ptr(), h1.data_ptr(), B, H,
        _DTYPES[h.dtype], torch.cuda.current_stream(dev).cuda_stream),
        "backward")
    launches_bwd += 1
    return dgates, dc_prev, h1


def grid(B: int, H: int) -> tuple:
    """The grid of one launch, forward or backward
    (``csrc/lstm_cell.cu``: 8 units by 16 batch rows a block)."""
    return -(-H // _JT), -(-B // _BT)


def grid_blocks(B: int, H: int) -> int:
    """Thread blocks of one launch."""
    gx, gy = grid(B, H)
    return gx * gy


def smem_bytes(dtype) -> int:
    """Dynamic shared memory of one launch for operands of ``dtype``
    (builds the library)."""
    fn = _build.load("lstm_cell").singa_lstm_cell_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(_DTYPES[dtype])


def cell_backward(saved, dh_out, dc_out, need=(True,) * 5):
    """The gradients of ``(xw, h, c, W_hh, b)`` (None where ``need`` is
    false) from the saved operands and the cotangents of ``(h', c')``:
    the backward kernel, then two products in float32 (``dh``, and
    ``dW_hh`` with ``db`` as the last row of ``h1^T @ dgates``), each
    gradient cast to its operand's dtype."""
    xw, h, c, W_hh, b = saved
    H = h.shape[-1]
    dgates, dc_prev, h1 = lstm_cell_backward(xw, h, c, W_hh, b, dh_out,
                                             dc_out)
    dxw = dgates.to(xw.dtype) if need[0] else None
    dh = (dgates @ W_hh.to(torch.float32).T).to(h.dtype) if need[1] \
        else None
    dc = dc_prev.to(c.dtype) if need[2] else None
    dWb = h1.T @ dgates if need[3] or need[4] else None
    dW = dWb[:H].to(W_hh.dtype) if need[3] else None
    db = dWb[H].to(b.dtype) if need[4] else None
    return dxw, dh, dc, dW, db


class LSTMCellFunction(torch.autograd.Function):
    """The cell with the reference's backward (``_lstm_cell_bwd``): the
    gates are recomputed from the saved operands in float32 — one extra
    product, inside the backward kernel — and the cotangents follow in
    closed form."""

    @staticmethod
    def forward(ctx, xw, h, c, W_hh, b):
        ctx.save_for_backward(xw, h, c, W_hh, b)
        return lstm_cell_forward(xw, h, c, W_hh, b)

    @staticmethod
    def backward(ctx, dh_out, dc_out):
        return cell_backward(ctx.saved_tensors, dh_out, dc_out,
                             ctx.needs_input_grad)


def lstm_cell_fused(xw, h, c, W_hh, b):
    """One differentiable LSTM step (see the module docstring):
    ``(h', c')``."""
    return LSTMCellFunction.apply(xw, h, c, W_hh, b)
