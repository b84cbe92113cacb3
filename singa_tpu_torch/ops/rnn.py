"""RNN ops of the port.  Counterpart: ``singa_tpu/ops/rnn.py``.

``RNNHandle`` (the static configuration: mode ``lstm``, ``gru``, ``tanh``
or ``relu``, layers, directions, ``batch_first``, ``use_fused_cell``),
the cells, one layer in one direction (:func:`_single_layer`), the whole
multi-layer, bidirectional stack (:func:`_rnn_fwd`) and the autograd op
:func:`rnn_forward` that returns ``(y, hy, cy)``.  Sequences are
``(T, B, D)`` (``(B, T, D)`` with ``batch_first``); states ``(L*D, B,
H)``; per (layer, direction) the weights are ``W_ih (I, gH)``, ``W_hh
(H, gH)`` and ``b (gH,)``, gates in the order i, f, g, o (LSTM) and r,
z, n (GRU), the bias folded into the input product — the reference's
layouts, so its weights cross unchanged.

The reference's recurrence is a ``lax.scan``; here it is a Python loop
over T whose backward is torch's autograd (BPTT).  The input product
``x @ W_ih`` is hoisted out of the loop as one ``torch.matmul`` over the
whole sequence, as the reference computes it outside its Pallas body.
With ``use_fused_cell`` an LSTM step is one launch of the hand-written
cell kernel (:mod:`.lstm_cell`), whose body computes the recurrent
``h @ W_hh``, the gates and the state update; otherwise the step is the
plain cell in torch ops.  ``_rnn_onnx_expand`` waits for ``sonnx``
(``ROADMAP.md`` queue 1, item 12).
"""

from __future__ import annotations

import torch

from .. import autograd
from .lstm_cell import lstm_cell_fused

__all__ = ["RNNHandle", "rnn_forward", "lstm", "gru", "vanilla_rnn"]


class RNNHandle:
    """Static RNN configuration (reference: ``CudnnRNNHandle`` without the
    cuDNN descriptor and workspace state)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 mode: str = "lstm", bidirectional: bool = False,
                 batch_first: bool = False, use_fused_cell: bool = False):
        if mode not in ("lstm", "gru", "tanh", "relu"):
            raise ValueError(f"unknown RNN mode {mode!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.mode = mode
        self.bidirectional = bidirectional
        self.batch_first = batch_first
        self.num_directions = 2 if bidirectional else 1
        # an LSTM step = one launch of the fused cell kernel
        self.use_fused_cell = use_fused_cell and mode == "lstm"

    @property
    def gates(self) -> int:
        return {"lstm": 4, "gru": 3, "tanh": 1, "relu": 1}[self.mode]

    def weight_shapes(self):
        """Per (layer, direction): the ``(W_ih, W_hh, b)`` shapes — the
        unpacked equivalent of cuDNN's packed weight blob."""
        shapes = []
        g, H = self.gates, self.hidden_size
        for layer in range(self.num_layers):
            in_dim = self.input_size if layer == 0 else H * self.num_directions
            for _ in range(self.num_directions):
                shapes.append(((in_dim, g * H), (H, g * H), (g * H,)))
        return shapes


def _lstm_cell(carry, xw, W_hh, b):
    h, c = carry
    gates = xw + h @ W_hh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c + i * g
    h = o * torch.tanh(c)
    return (h, c), h


def _gru_cell(carry, x, W_ih, W_hh, b):
    (h,) = carry
    xr, xz, xn = (x @ W_ih + b).chunk(3, dim=-1)
    hr, hz, hn = (h @ W_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h = (1 - z) * n + z * h
    return (h,), h


def _scan(cell, carry, xs):
    """``lax.scan`` as a loop over the leading axis: ``(carry, ys)``."""
    ys = []
    for xt in xs:
        carry, y = cell(carry, xt)
        ys.append(y)
    return carry, torch.stack(ys)


def _fused_lstm_layer(x, h0, c0, W_ih, W_hh, b):
    """An LSTM layer whose step is one launch of the fused cell: the input
    product for the whole sequence first, then T cell steps."""
    xw = torch.matmul(x, W_ih)                      # (T, B, 4H)
    h, c = h0.contiguous(), c0.contiguous()
    W_hh, b = W_hh.contiguous(), b.contiguous()
    ys = []
    # unbind, not xw[t]: its backward stacks the T step gradients once,
    # where T selects would each scatter into a zeroed (T, B, 4H) buffer
    for xt in xw.unbind(0):
        h, c = lstm_cell_fused(xt, h, c, W_hh, b)
        ys.append(h)
    return torch.stack(ys), h, c


def _single_layer(mode, x, h0, c0, W_ih, W_hh, b, reverse=False,
                  fused=False):
    """One direction of one layer; ``x`` is ``(T, B, D)``."""
    if reverse:
        x = torch.flip(x, dims=(0,))
    if mode == "lstm" and fused:
        ys, h, c = _fused_lstm_layer(x, h0, c0, W_ih, W_hh, b)
    elif mode == "lstm":
        xw = x @ W_ih                               # hoisted input product
        (h, c), ys = _scan(lambda carry, xt: _lstm_cell(carry, xt, W_hh, b),
                           (h0, c0), xw)
    elif mode == "gru":
        (h,), ys = _scan(
            lambda carry, xt: _gru_cell(carry, xt, W_ih, W_hh, b), (h0,), x)
        c = c0
    else:
        act = torch.tanh if mode == "tanh" else torch.relu
        xw = x @ W_ih

        def cell(carry, xt):
            (h,) = carry
            h = act(xt + h @ W_hh + b)
            return (h,), h
        (h,), ys = _scan(cell, (h0,), xw)
        c = c0
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, h, c


def _rnn_fwd(x, hx, cx, *weights, handle: RNNHandle):
    """The full multi-layer (bi)directional RNN: ``(y, hy, cy)``; hx and
    cx are ``(L*D, B, H)``."""
    if x.dtype != hx.dtype or any(w.dtype != x.dtype for w in weights):
        # the activation dtype wins, as in the reference
        hx, cx = hx.to(x.dtype), cx.to(x.dtype)
        weights = tuple(w.to(x.dtype) for w in weights)
    if handle.batch_first:
        x = x.transpose(0, 1)
    D = handle.num_directions
    hs, cs = [], []
    inp = x
    for layer in range(handle.num_layers):
        outs = []
        for d in range(D):
            li = layer * D + d
            W_ih, W_hh, b = weights[3 * li:3 * li + 3]
            ys, h, c = _single_layer(handle.mode, inp, hx[li], cx[li],
                                     W_ih, W_hh, b, reverse=(d == 1),
                                     fused=handle.use_fused_cell)
            outs.append(ys)
            hs.append(h)
            cs.append(c)
        inp = outs[0] if D == 1 else torch.cat(outs, dim=-1)
    y = inp
    if handle.batch_first:
        y = y.transpose(0, 1)
    return y, torch.stack(hs), torch.stack(cs)


def rnn_forward(handle: RNNHandle, x, hx, cx, weights):
    """The multi-output RNN op on :class:`~singa_tpu_torch.tensor.Tensor`
    arguments: returns Tensors ``(y, hy, cy)`` (reference:
    ``GpuRNNForwardTraining``; BPTT through torch's autograd)."""
    return autograd.op(f"RNN-{handle.mode}",
                       lambda *a: _rnn_fwd(*a, handle=handle),
                       x, hx, cx, *weights)


def lstm(handle, x, hx, cx, weights):
    return rnn_forward(handle, x, hx, cx, weights)


def gru(handle, x, hx, cx, weights):
    return rnn_forward(handle, x, hx, cx, weights)


def vanilla_rnn(handle, x, hx, cx, weights):
    return rnn_forward(handle, x, hx, cx, weights)
