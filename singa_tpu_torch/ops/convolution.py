"""Convolution of the port.  Counterpart: ``singa_tpu/ops/convolution.py``
(the reference's ``ConvHandle`` / ``CudnnConvHandle`` and
``GpuConvForward``).

The reference computes the convolution as one XLA op
(``jax.lax.conv_general_dilated``), with no Pallas kernel; its port is
``torch.nn.functional.conv2d`` (cuDNN on the card), and the backward
pair is torch's autograd.  The handle keeps the static geometry only.

Layouts: ``NCHW`` takes and returns ``(N, C, H, W)`` tensors;
``layout="NHWC"`` takes and returns channels-last ``(N, H, W, C)``
tensors (the convolution runs on the channels-last view, so cuDNN picks
its NHWC kernels).  Weights are OIHW in both, so checkpoints do not
depend on the layout.  A filter of another dtype than ``x`` is cast to
``x``'s (a float32 master under a bf16 activation), as in the
reference's ``_conv_fwd`` (:53); the bias is added after the
convolution and the sum returns in ``x``'s dtype.
"""

from __future__ import annotations

import torch.nn.functional as F

from .. import autograd
from ..tensor import Tensor
from .pooling import _pair

__all__ = ["ConvHandle", "conv2d", "GpuConvForward"]


class ConvHandle:
    """Static conv geometry (reference: ConvHandle and CudnnConvHandle
    merged; cuDNN picks its algorithm and workspace per call)."""

    def __init__(self, in_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), bias: bool = True, groups: int = 1,
                 dilation=(1, 1), layout: str = "NCHW"):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout {layout!r} is neither NCHW nor NHWC")
        self.in_channels = in_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.bias = bias
        self.groups = groups
        self.layout = layout


def _conv_fwd(x, w, b=None, *, handle: ConvHandle):
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    nhwc = handle.layout == "NHWC"
    out = F.conv2d(x.permute(0, 3, 1, 2) if nhwc else x, w, None,
                   handle.stride, handle.padding, handle.dilation,
                   handle.groups)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + (b if nhwc else b[:, None, None])
    return out.to(x.dtype)


def conv2d(handle: ConvHandle, x: Tensor, w: Tensor,
           b: Tensor | None = None) -> Tensor:
    """Autograd conv (reference: autograd ``_Conv2d`` -> GpuConvForward)."""
    args = (x, w) if b is None else (x, w, b)
    return autograd.op("Conv", lambda *v: _conv_fwd(*v, handle=handle),
                       *args)


def GpuConvForward(x: Tensor, w: Tensor, b: Tensor | None,
                   handle: ConvHandle) -> Tensor:
    """Reference-named free function (the raw forward, no gradient)."""
    out = _conv_fwd(x.data, w.data, None if b is None else b.data,
                    handle=handle)
    return Tensor(data=out.detach(), device=x.device, requires_grad=False)
