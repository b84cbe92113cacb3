"""The fused LSTM cell: a hand-written CUDA kernel and its plain PyTorch
version.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``lstm_cell_fused``
(the entry, a ``custom_vjp``), ``_lstm_fwd_impl`` / ``_lstm_kernel`` (the
Pallas TPU kernel) and ``_lstm_cell_bwd`` (the backward, a recompute in
plain XLA).  The kernel source is ``csrc/lstm_cell.cu``.

One step of an LSTM on UNPACKED operands: ``xw (B, 4H)`` (the hoisted
input product ``x @ W_ih``), ``h, c (B, H)``, ``W_hh (H, 4H)``, ``b
(4H,)``, the gate blocks in the order i, f, g, o::

    gates = xw + h @ W_hh + b
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')

The reference packs each gate block to a 128-lane boundary and pads the
batch to 8 for the TPU's tiles; the port does neither, so the layout is
``ops/rnn.py``'s own.

:func:`lstm_cell_fused` is differentiable: its backward is the
reference's recompute formula in torch ops (the JAX package has no
backward kernel, so the port writes none).  Routing: the tensor's device
decides.  CPU tensors take the plain version; CUDA tensors launch the
kernel (float32 only) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lstm_cell_fused", "lstm_cell_reference", "lstm_cell_forward"]

# kernel launches made by lstm_cell_forward (plain-version calls and CPU
# calls do not count)
launches = 0


def lstm_cell_reference(xw, h, c, W_hh, b):
    """Plain PyTorch version, on any device: ``(h', c')``."""
    gates = xw + h @ W_hh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _lib():
    fn = _build.load("lstm_cell").singa_lstm_cell
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
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
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"lstm_cell kernel takes float32 operands, got "
                        f"{[t.dtype for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("lstm_cell kernel takes contiguous operands")


def lstm_cell_forward(xw, h, c, W_hh, b):
    """One cell step without autograd: ``(h', c')`` in fresh buffers.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/lstm_cell.cu`` or raise."""
    global launches
    ops = (xw, h, c, W_hh, b)
    dev = h.device
    if any(t.device != dev for t in ops):
        raise ValueError("lstm_cell: operands on different devices")
    if dev.type == "cpu":
        return lstm_cell_reference(xw, h, c, W_hh, b)
    if dev.type != "cuda":
        raise ValueError(f"lstm_cell: unsupported device {dev}")
    _check_kernel_operands(xw, h, c, W_hh, b)
    B, H = h.shape
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    err = _lib()(xw.data_ptr(), h.data_ptr(), c.data_ptr(), W_hh.data_ptr(),
                 b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, H,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed (cudaError "
                           f"{err})")
    launches += 1
    return h_out, c_out


def grid_blocks(B: int, H: int) -> int:
    """Thread blocks of one launch (``csrc/lstm_cell.cu``: 64 units by 4
    batch rows a block)."""
    return -(-H // 64) * -(-B // 4)


class LSTMCellFunction(torch.autograd.Function):
    """The cell with the reference's backward (``_lstm_cell_bwd``): the
    gates are recomputed from the saved inputs in float32 — one extra
    product — and the cotangents follow in closed form."""

    @staticmethod
    def forward(ctx, xw, h, c, W_hh, b):
        ctx.save_for_backward(xw, h, c, W_hh, b)
        return lstm_cell_forward(xw, h, c, W_hh, b)

    @staticmethod
    def backward(ctx, dh_out, dc_out):
        xw, h, c, W_hh, b = ctx.saved_tensors
        f32 = torch.float32
        xf, hf, cf, wf = (t.to(f32) for t in (xw, h, c, W_hh))
        gates = xf + hf @ wf + b.to(f32)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        tc = torch.tanh(f * cf + i * g)
        dh_out, dc_out = dh_out.to(f32), dc_out.to(f32)
        dc_tot = dc_out + dh_out * o * (1 - tc * tc)
        dgates = torch.cat([dc_tot * g * i * (1 - i),
                            dc_tot * cf * f * (1 - f),
                            dc_tot * i * (1 - g * g),
                            dh_out * tc * o * (1 - o)], dim=-1)
        need = ctx.needs_input_grad
        dxw = dgates.to(xw.dtype) if need[0] else None
        dh = (dgates @ wf.T).to(h.dtype) if need[1] else None
        dc = (dc_tot * f).to(c.dtype) if need[2] else None
        dW = (hf.T @ dgates).to(W_hh.dtype) if need[3] else None
        db = dgates.sum(dim=0).to(b.dtype) if need[4] else None
        return dxw, dh, dc, dW, db


def lstm_cell_fused(xw, h, c, W_hh, b):
    """One differentiable LSTM step (see the module docstring):
    ``(h', c')``."""
    return LSTMCellFunction.apply(xw, h, c, W_hh, b)
