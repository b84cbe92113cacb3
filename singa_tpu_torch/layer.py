"""Layers of the port.  Counterpart: ``singa_tpu/layer.py``.

``Layer`` (lazy parameter creation on the first call, on the first
input's device; ``get_params`` / ``get_states`` / ``set_states`` under
dotted attribute-path names, as the reference), ``Linear`` (:123, ``W``
is ``(in, out)``, ``y = x @ W + b``), ``ReLU`` (:265), ``Embedding``
(:312), ``LayerNorm`` (:330, ``scale`` / ``bias``, float32 statistics),
``Gelu``,
``MultiHeadAttention`` (:441: the naive decomposition of
layer.py:559-583 or the differentiable flash-attention kernels), ``RNN``,
``LSTM``, ``GRU`` and ``CudnnRNN`` (:359-419, optionally through the
fused LSTM cell kernel), plus :func:`apply_rope`.  Initial weights come
from the device's seeded ``torch.Generator``.  Conv, batch-norm and
pooling layers, sequence parallelism and attention dropout in training
belong to later slices (``ROADMAP.md`` queue 1, items 3 and 12).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import autograd
from .device import get_device
from .ops.flash_attention import flash_attention
from .ops.rnn import RNNHandle, rnn_forward
from .tensor import Tensor

__all__ = ["Layer", "Linear", "Embedding", "LayerNorm", "ReLU", "Gelu",
           "MultiHeadAttention", "RNN", "LSTM", "GRU", "CudnnRNN",
           "apply_rope"]


class Layer:
    sep = "."

    def __init__(self, name: str | None = None):
        self.name = name or type(self).__name__
        self._initialized = False

    # -- lazy init ---------------------------------------------------------
    def initialize(self, *xs):
        """Create params from the first input's shapes."""

    def __call__(self, *xs, **kw):
        if not self._initialized:
            # params materialise on the first input's device
            self._init_device = next(
                (x.device for x in xs if isinstance(x, Tensor)), None)
            self.initialize(*xs)
            self._initialized = True
        return self.forward(*xs, **kw)

    def forward(self, *xs, **kw):
        raise NotImplementedError

    # -- introspection ----------------------------------------------------
    def _sublayers(self):
        for attr, val in vars(self).items():
            if isinstance(val, Layer):
                yield attr, val
            elif isinstance(val, (list, tuple)):
                for i, v in enumerate(val):
                    if isinstance(v, Layer):
                        yield f"{attr}{i}", v

    def _own_tensors(self, states: bool):
        for attr, val in vars(self).items():
            if isinstance(val, Tensor):
                if val.stores_grad or (states and not val.requires_grad):
                    yield attr, val

    def get_params(self) -> dict:
        """Trainable params, recursively, under dotted attribute-path
        names."""
        return self._collect(states=False)

    def get_states(self) -> dict:
        """Params + non-trainable buffers."""
        return self._collect(states=True)

    def _collect(self, states: bool, prefix: str = "") -> dict:
        out = {}
        for attr, t in self._own_tensors(states):
            out[f"{prefix}{attr}"] = t
        for attr, sub in self._sublayers():
            out.update(sub._collect(states, f"{prefix}{attr}{self.sep}"))
        return out

    def set_params(self, params: dict):
        self._assign(params, states=False)

    def set_states(self, states: dict):
        self._assign(states, states=True)

    def _assign(self, values: dict, states: bool):
        """Copy every named value (numpy array, torch tensor or
        :class:`Tensor`) into the matching tensor in place, cast to its
        dtype and reshaped to its shape."""
        for name, t in self._collect(states).items():
            if name in values:
                v = values[name]
                if isinstance(v, Tensor):
                    v = v.data
                elif not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v))
                with torch.no_grad():
                    t.data.copy_(v.reshape(t.shape))

    def _param(self, data, name: str) -> Tensor:
        return Tensor(data=data, requires_grad=True, stores_grad=True,
                      device=getattr(self, "_init_device", None),
                      name=f"{self.name}{self.sep}{name}")

    def _generator(self):
        return get_device(getattr(self, "_init_device", None)).generator


class Linear(Layer):
    """``y = x W + b`` with ``W`` of shape ``(in, out)`` (reference:
    ``layer.Linear``); ``W ~ U(-1/sqrt(in), 1/sqrt(in))``, ``b = 0``."""

    def __init__(self, out_features: int, bias: bool = True, name=None):
        super().__init__(name)
        self.out_features = out_features
        self.use_bias = bias

    def initialize(self, x):
        in_features = x.shape[-1]
        bound = 1.0 / math.sqrt(in_features)
        dev = get_device(self._init_device).torch_device
        w = torch.empty(in_features, self.out_features, device=dev)
        w.uniform_(-bound, bound, generator=self._generator())
        self.W = self._param(w, "W")
        if self.use_bias:
            self.b = self._param(torch.zeros(self.out_features, device=dev),
                                 "b")

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self.use_bias:
            y = autograd.add_bias(y, self.b)
        return y


class ReLU(Layer):
    def forward(self, x):
        return autograd.relu(x)


class Gelu(Layer):
    """Exact (erf) GELU."""

    def forward(self, x):
        return autograd.gelu(x)


class Embedding(Layer):
    """Token embedding lookup (gather; repeated ids scatter-add their
    gradients).  Created eagerly on ``device`` (the card by default, as
    every entry point), ``W ~ N(0, 0.02)``, so weights can be loaded
    before the first forward."""

    def __init__(self, vocab_size: int, embed_dim: int, name=None,
                 device=None):
        super().__init__(name)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        dev = get_device(device)
        self._init_device = dev
        w = torch.randn(vocab_size, embed_dim, generator=dev.generator,
                        device=dev.torch_device) * 0.02
        self.W = self._param(w, "W")
        self._initialized = True

    def forward(self, idx):
        return autograd.gather(self.W, idx, axis=0)


class LayerNorm(Layer):
    """LayerNorm over the last axis with ``scale`` / ``bias``; the mean
    and variance accumulate in float32 and the output returns in the
    input's dtype."""

    def __init__(self, eps: float = 1e-5, name=None):
        super().__init__(name)
        self.eps = eps

    def initialize(self, x):
        d = x.shape[-1]
        dev = get_device(self._init_device).torch_device
        self.scale = self._param(torch.ones(d, device=dev), "scale")
        self.bias = self._param(torch.zeros(d, device=dev), "bias")

    def forward(self, x):
        eps = self.eps

        def fn(v, g, b):
            vf = v.to(torch.float32)
            var, mu = torch.var_mean(vf, dim=-1, keepdim=True, correction=0)
            out = ((vf - mu) * torch.reciprocal(torch.sqrt(var + eps))
                   * g.to(torch.float32) + b.to(torch.float32))
            return out.to(v.dtype)
        return autograd.op("LayerNormalization", fn, x, self.scale,
                            self.bias)


class RNN(Layer):
    """Multi-layer (bi)directional RNN over :mod:`~singa_tpu_torch.ops.rnn`
    (reference: ``layer.RNN`` / ``CudnnRNN``; state layout as cuDNN's).

    Lazy init: per (layer, direction) ``W_ih``, ``W_hh`` and ``b`` drawn
    from U(-1/sqrt(H), 1/sqrt(H)) with the device's generator, held in the
    attributes ``_w0``, ``_w1``, ... so the states are named
    ``<layer>._w0`` and so on, as the reference's.  ``use_fused_cell``
    (LSTM only, read when the layer initialises): each step is one launch
    of the fused cell kernel.  ``forward(x, hx=None, cx=None)`` starts
    from zero states by default and returns ``(y, hy, cy)`` for an LSTM,
    ``(y, hy)`` otherwise."""

    mode = "tanh"

    def __init__(self, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, batch_first: bool = False,
                 use_fused_cell: bool = False, name=None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.batch_first = batch_first
        self.use_fused_cell = use_fused_cell

    def initialize(self, x, *args):
        self.handle = RNNHandle(x.shape[-1], self.hidden_size,
                                self.num_layers, self.mode,
                                self.bidirectional, self.batch_first,
                                use_fused_cell=self.use_fused_cell)
        bound = 1.0 / math.sqrt(self.hidden_size)
        dev = get_device(self._init_device).torch_device
        self.weights = []
        for li, shapes in enumerate(self.handle.weight_shapes()):
            for suffix, shape in zip(("W_ih", "W_hh", "b"), shapes):
                w = torch.empty(shape, device=dev)
                w.uniform_(-bound, bound, generator=self._generator())
                self.weights.append(self._param(w, f"l{li}{self.sep}{suffix}"))
        for i, t in enumerate(self.weights):
            setattr(self, f"_w{i}", t)

    def _zeros_state(self, x):
        B = x.shape[0] if self.batch_first else x.shape[1]
        L = self.num_layers * self.handle.num_directions
        return Tensor(data=torch.zeros((L, B, self.hidden_size),
                                       dtype=x.dtype,
                                       device=x.device.torch_device),
                      device=x.device, requires_grad=False)

    def forward(self, x, hx=None, cx=None):
        if hx is None:
            hx = self._zeros_state(x)
        if cx is None:
            cx = self._zeros_state(x)
        y, hy, cy = rnn_forward(self.handle, x, hx, cx, self.weights)
        if self.mode == "lstm":
            return y, hy, cy
        return y, hy


class LSTM(RNN):
    mode = "lstm"


class GRU(RNN):
    mode = "gru"


# reference-named alias
CudnnRNN = LSTM


def apply_rope(x, positions=None, base: float = 10000.0):
    """Rotary position embedding (rotate-half convention) on
    ``(B, H, T, dh)`` tensors; ``positions`` defaults to ``0..T-1``
    (pass explicit positions for cached decode).
    ``theta_i = base^(-2i/dh)``, angles in float32."""
    B, H, T, dh = x.shape
    if dh % 2:
        raise ValueError(f"rope needs an even head dim, got {dh}")
    half = dh // 2
    if positions is None:
        positions = torch.arange(T, device=x.device)
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None]      # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MultiHeadAttention(Layer):
    """Multi-head self/cross attention (reference:
    ``layer.MultiHeadAttention``).

    ``use_flash``: True runs the differentiable flash-attention kernels
    (:func:`~singa_tpu_torch.ops.flash_attention.flash_attention`: the
    CUDA kernels on the card, their plain versions on the CPU); False
    runs the naive decomposition (scores, scale, the additive
    ``triu(-1e9)`` causal constant, the mask, softmax, product); None
    picks by the input's device — flash on CUDA, naive on the CPU, as
    the reference picks flash on an accelerator.  ``rope`` rotates q and
    k after the head split."""

    def __init__(self, num_heads: int, dropout: float = 0.0,
                 use_flash: bool | None = False, seq_mesh=None,
                 causal: bool = False, rope: bool = False,
                 rope_base: float = 10000.0, name=None):
        super().__init__(name)
        if seq_mesh is not None:
            raise NotImplementedError(
                "sequence-parallel attention (seq_mesh) belongs to the "
                "parallel slice (ROADMAP.md queue 1, item 12)")
        self.num_heads = num_heads
        self.dropout_p = dropout
        self.use_flash = use_flash
        self.causal = causal
        self.rope = rope
        self.rope_base = float(rope_base)

    def _flash_resolved(self, x) -> bool:
        if self.use_flash is None:
            return x.device.lang == "cuda"
        return bool(self.use_flash)

    def initialize(self, x, *rest):
        d_model = x.shape[-1]
        if d_model % self.num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{self.num_heads} heads")
        self.d_model = d_model
        self.d_head = d_model // self.num_heads
        self.Wq = Linear(d_model, name=f"{self.name}.q")
        self.Wk = Linear(d_model, name=f"{self.name}.k")
        self.Wv = Linear(d_model, name=f"{self.name}.v")
        self.Wo = Linear(d_model, name=f"{self.name}.o")

    def _heads(self, t, B, T):
        # (B,T,D) -> (B,H,T,dh)
        t = autograd.reshape(t, (-1, T, self.num_heads, self.d_head))
        return autograd.transpose(t, (0, 2, 1, 3))

    def forward(self, x, mask=None, kv=None):
        """x: (B,T,D); mask: additive float mask broadcastable to
        (B,H,T,S) or None; kv: cross-attention source (defaults to x)."""
        B, T = x.shape[0], x.shape[1]
        src = kv if kv is not None else x
        S = src.shape[1]
        q = self._heads(self.Wq(x), B, T)
        k = self._heads(self.Wk(src), B, S)
        v = self._heads(self.Wv(src), B, S)
        if self.rope:
            if kv is not None:
                raise NotImplementedError(
                    "rope is self-attention only (cross-attention kv= "
                    "would need separate position streams)")
            base = self.rope_base
            q = autograd.op("RoPE", lambda a: apply_rope(a, base=base), q)
            k = autograd.op("RoPE", lambda a: apply_rope(a, base=base), k)
        if self.dropout_p and autograd.training:
            raise NotImplementedError(
                "attention dropout in training belongs to the slice of "
                "layer.py's Dropout and the Transformer layers (ROADMAP.md "
                "queue 1, item 3); set dropout=0")
        if self._flash_resolved(x):
            causal = self.causal
            ctx = autograd.op(
                "FlashAttention",
                lambda a, b, c, m: flash_attention(a, b, c, m, causal=causal),
                q, k, v, mask)
        else:
            scores = autograd.matmul(q, autograd.transpose(k, (0, 1, 3, 2)))
            sdt, tdev = scores.dtype, scores.data.device
            # made on the device: a host-to-device copy would synchronise,
            # which a captured step cannot
            scores = autograd.mul(scores, Tensor(
                data=torch.full((), 1.0 / math.sqrt(self.d_head), dtype=sdt,
                                device=tdev),
                device=x.device, requires_grad=False))
            if self.causal:
                ck = (T, S, sdt, id(x.device))
                if getattr(self, "_causal_cache", None) is None \
                        or self._causal_cache[0] != ck:
                    tri = torch.triu(torch.full((T, S), -1e9, dtype=sdt,
                                                device=tdev), diagonal=1)
                    self._causal_cache = (ck, Tensor(
                        data=tri, device=x.device, requires_grad=False))
                scores = autograd.add(scores, self._causal_cache[1])
            if mask is not None:
                if mask.dtype != sdt:
                    mask = autograd.cast(mask, sdt)
                scores = autograd.add(scores, mask)
            probs = autograd.softmax(scores, axis=-1)
            ctx = autograd.matmul(probs, v)
        ctx = autograd.transpose(ctx, (0, 2, 1, 3))
        ctx = autograd.reshape(ctx, (-1, T, self.d_model))
        return self.Wo(ctx)
