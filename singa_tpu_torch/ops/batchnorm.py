"""Batch normalization of the port.  Counterpart:
``singa_tpu/ops/batchnorm.py`` (the reference's ``CudnnBatchNormHandle``
and ``GpuBatchNormForwardTraining / Inference``, spatial mode).

The reference computes it as plain ``jnp`` moment math that XLA fuses,
with no Pallas kernel; here it is the same math in torch ops, and the
backward is torch's autograd over the training-mode normalization.  Not
``F.batch_norm``: its running-stat update keeps the unbiased variance
and weights the batch by ``momentum``, where the reference keeps the
biased variance (``jnp.var``) and updates ``new = factor * old + (1 -
factor) * batch`` with ``factor`` 0.9.

* Training: the moments over the batch (and the spatial axes) in float32
  for any activation dtype, the output back in the activation's dtype,
  and the running buffers updated in place (``mul_`` / ``add_`` under
  ``no_grad``), so a captured step's replays write the storage the
  graph was captured against.
* Inference: ``(x - running_mean) / sqrt(running_var + eps) * scale +
  bias`` (the float32 buffers promote a 16-bit ``x``), back in the
  activation's dtype.

Rank 4 (``NCHW`` or ``NHWC``) normalizes per channel over the batch and
spatial axes; rank 2 (``NC``) per feature over the batch.
"""

from __future__ import annotations

import torch

from .. import autograd
from ..tensor import Tensor

__all__ = ["BatchNormHandle", "batchnorm2d"]


class BatchNormHandle:
    def __init__(self, momentum: float = 0.9, eps: float = 1e-5,
                 layout: str = "NCHW"):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout {layout!r} is neither NCHW nor NHWC")
        self.factor = momentum  # the reference names this `factor`
        self.eps = eps
        self.layout = layout


def _bn_geom(x, layout):
    """(reduce axes, channel broadcast shape) for this rank and layout."""
    if x.dim() != 4:
        return (0,), (1, -1)
    if layout == "NHWC":
        return (0, 1, 2), (1, 1, 1, -1)
    return (0, 2, 3), (1, -1, 1, 1)


def _bn_train_fwd(x, gamma, beta, rm, rv, *, handle):
    axes, shape = _bn_geom(x, handle.layout)
    xf = x.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=axes, correction=0)
    with torch.no_grad():
        f = handle.factor
        rm.mul_(f).add_(mean.detach().to(rm.dtype) * (1 - f))
        rv.mul_(f).add_(var.detach().to(rv.dtype) * (1 - f))
    xhat = (xf - mean.reshape(shape)) * torch.reciprocal(
        torch.sqrt(var.reshape(shape) + handle.eps))
    return (xhat * gamma.reshape(shape) + beta.reshape(shape)).to(x.dtype)


def _bn_infer_fwd(x, gamma, beta, rm, rv, *, handle):
    _, shape = _bn_geom(x, handle.layout)
    xhat = (x - rm.reshape(shape)) * torch.reciprocal(
        torch.sqrt(rv.reshape(shape) + handle.eps))
    return (xhat * gamma.reshape(shape) + beta.reshape(shape)).to(x.dtype)


def batchnorm2d(handle: BatchNormHandle, x: Tensor, gamma: Tensor,
                beta: Tensor, running_mean: Tensor, running_var: Tensor,
                training: bool) -> Tensor:
    """Batch normalization (see the module docstring); in training mode
    the batch statistics normalize and update the running buffers in
    place."""
    fwd = _bn_train_fwd if training else _bn_infer_fwd
    return autograd.op("BatchNormalization",
                       lambda *v: fwd(*v, handle=handle), x, gamma, beta,
                       running_mean, running_var)
