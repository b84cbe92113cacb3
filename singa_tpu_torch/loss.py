"""The reference's v2-era loss API.  Counterpart: ``singa_tpu/loss.py``
(``python/singa/loss.py`` upstream).

The classes keep the v2 calling convention: ``forward(flag, x, y)``
returns the per-sample loss as a :class:`~singa_tpu_torch.tensor.Tensor`
and, when ``flag`` is true, caches the analytic gradient that
``backward()`` returns: d(sum of the per-sample losses)/dx, not averaged
over the batch; ``evaluate(flag, x, y)`` is the batch mean as a float.
``x`` and ``y`` may be Tensors, torch tensors or numpy arrays.  The v3
path is ``autograd.softmax_cross_entropy`` / ``mse_loss``.
"""

from __future__ import annotations

import numpy as np
import torch

from .tensor import Tensor

__all__ = ["Loss", "SoftmaxCrossEntropy", "SquaredError", "MeanSquareError",
           "DistillationKL", "soften_logits"]


def _data(x) -> torch.Tensor:
    """A Tensor's data, a torch tensor as it is, host data as a tensor
    (float64 narrowed to float32, as :class:`Tensor` does)."""
    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                            else a)


def soften_logits(logits, temperature: float = 1.0) -> torch.Tensor:
    """Temperature-softened probabilities ``softmax(logits / T)`` in
    float32: the teacher's half of the distillation objective."""
    t = float(temperature)
    if t <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    return torch.softmax(_data(logits).to(torch.float32) / t, dim=-1)


def _wrap(a, like):
    dev = like.device if isinstance(like, Tensor) else a.device
    return Tensor(data=a, device=dev, requires_grad=False)


def _onehot(y, depth, dtype):
    """``jax.nn.one_hot``: an id outside ``[0, depth)`` gives zeros."""
    cls = torch.arange(depth, device=y.device)
    return (y.long()[..., None] == cls).to(dtype)


class Loss:
    """v2 API: ``l = loss.forward(flag, x, y); dx = loss.backward()``."""

    def forward(self, flag, x, y) -> Tensor:
        raise NotImplementedError

    def backward(self) -> Tensor:
        raise NotImplementedError

    def evaluate(self, flag, x, y) -> float:
        return float(self.forward(False, x, y).data.mean())


class SoftmaxCrossEntropy(Loss):
    """Softmax + cross entropy on the last axis; integer or one-hot
    targets (reference: ``loss.py::SoftmaxCrossEntropy``)."""

    def __init__(self):
        self._grad = None
        self._like = None

    def forward(self, flag, x, y) -> Tensor:
        xv, yv = _data(x), _data(y).to(_data(x).device)
        logp = torch.log_softmax(xv, dim=-1)
        if yv.dim() == xv.dim():                    # one-hot / soft targets
            onehot = yv.to(logp.dtype)
        else:
            onehot = _onehot(yv, xv.shape[-1], logp.dtype)
        nll = -torch.sum(onehot * logp, dim=-1)
        if flag:  # training pass: cache the analytic gradient
            self._grad = torch.exp(logp) - onehot
            self._like = x
        return _wrap(nll, x)

    def backward(self) -> Tensor:
        if self._grad is None:
            raise RuntimeError("backward() before forward(flag=True, ...)")
        return _wrap(self._grad, self._like)


class DistillationKL(Loss):
    """Hinton-style distillation: ``T^2 * KL(softmax(t/T) || softmax(s/T))``
    per sample, ``s`` the student's logits (``x``) and ``t`` the
    teacher's (``y``); ``backward`` is the analytic
    ``T * (softmax(s/T) - softmax(t/T))`` (reference:
    ``loss.py::DistillationKL``)."""

    def __init__(self, temperature: float = 2.0):
        t = float(temperature)
        if t <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = t
        self._grad = None
        self._like = None

    def forward(self, flag, x, y) -> Tensor:
        t = self.temperature
        s = _data(x).to(torch.float32) / t
        tch = _data(y).to(s.device, torch.float32) / t
        logq = torch.log_softmax(s, dim=-1)
        logp = torch.log_softmax(tch, dim=-1)
        p = torch.exp(logp)
        kl = (t * t) * torch.sum(p * (logp - logq), dim=-1)
        axes = tuple(range(1, kl.dim()))
        per_sample = torch.sum(kl, dim=axes) if axes else kl
        if flag:
            self._grad = t * (torch.exp(logq) - p)
            self._like = x
        return _wrap(per_sample, x)

    def backward(self) -> Tensor:
        if self._grad is None:
            raise RuntimeError("backward() before forward(flag=True, ...)")
        return _wrap(self._grad, self._like)


class SquaredError(Loss):
    """Per-sample ``0.5 * sum((x - y)^2)`` over the non-batch axes;
    backward is ``x - y`` (reference: ``loss.py::SquaredError``)."""

    def __init__(self):
        self._diff = None
        self._like = None

    def forward(self, flag, x, y) -> Tensor:
        xv = _data(x)
        diff = xv - _data(y).to(xv.device, xv.dtype)
        axes = tuple(range(1, diff.dim()))
        per_sample = 0.5 * (torch.sum(torch.square(diff), dim=axes) if axes
                            else torch.square(diff))
        if flag:
            self._diff = diff
            self._like = x
        return _wrap(per_sample, x)

    def backward(self) -> Tensor:
        if self._diff is None:
            raise RuntimeError("backward() before forward(flag=True, ...)")
        return _wrap(self._diff, self._like)


# common alias in downstream code
MeanSquareError = SquaredError
