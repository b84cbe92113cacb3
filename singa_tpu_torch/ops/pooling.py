"""Pooling of the port.  Counterpart: ``singa_tpu/ops/pooling.py`` (the
reference's ``CudnnPoolingHandle`` and ``GpuPoolingForward``, max and
average).

The reference computes a pool as one XLA ``reduce_window``, with no
Pallas kernel; its port is ``torch.nn.functional.max_pool2d`` /
``avg_pool2d`` (cuDNN or torch's own kernels on the card), and the
backward is torch's autograd.  The reference's conventions hold: the
stride defaults to the kernel size; max pooling pads with ``-inf``;
average pooling leaves the padding out of each window's count unless
``count_include_pad`` (torch's default is the opposite, so it is passed
explicitly).  ``layout="NHWC"`` takes and returns channels-last
tensors.  Torch's pools take a padding of at most half the kernel; a
larger one is padded explicitly first (``-inf`` for max, zeros and a
count of the real values for average), the reference's own formulation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd
from ..tensor import Tensor

__all__ = ["PoolingHandle", "pooling2d", "GpuPoolingForward",
           "global_avg_pool", "out_shape"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class PoolingHandle:
    def __init__(self, kernel_size, stride=None, padding=(0, 0),
                 is_max: bool = True, count_include_pad: bool = False,
                 layout: str = "NCHW"):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout {layout!r} is neither NCHW nor NHWC")
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = _pair(padding)
        self.is_max = is_max
        self.count_include_pad = count_include_pad
        self.layout = layout


def _pool_nchw(x, handle):
    k, s, (ph, pw) = handle.kernel_size, handle.stride, handle.padding
    if 2 * ph <= k[0] and 2 * pw <= k[1]:
        if handle.is_max:
            return F.max_pool2d(x, k, s, (ph, pw))
        return F.avg_pool2d(x, k, s, (ph, pw),
                            count_include_pad=handle.count_include_pad)
    if handle.is_max:
        return F.max_pool2d(F.pad(x, (pw, pw, ph, ph), value=-float("inf")),
                            k, s)
    summed = F.avg_pool2d(F.pad(x, (pw, pw, ph, ph)), k, s) * (k[0] * k[1])
    if handle.count_include_pad:
        return summed / (k[0] * k[1])
    ones = F.pad(torch.ones_like(x[:1, :1]), (pw, pw, ph, ph))
    return summed / (F.avg_pool2d(ones, k, s) * (k[0] * k[1]))


def _pool_fwd(x, *, handle: PoolingHandle):
    if handle.layout == "NHWC":
        return _pool_nchw(x.permute(0, 3, 1, 2), handle).permute(0, 2, 3, 1)
    return _pool_nchw(x, handle)


def pooling2d(handle: PoolingHandle, x: Tensor) -> Tensor:
    """Autograd pooling (reference: autograd ``_Pooling2d`` op)."""
    return autograd.op("MaxPool" if handle.is_max else "AveragePool",
                       lambda v: _pool_fwd(v, handle=handle), x)


def GpuPoolingForward(handle: PoolingHandle, x: Tensor) -> Tensor:
    """Reference-named free function (the raw forward, no gradient)."""
    return Tensor(data=_pool_fwd(x.data, handle=handle).detach(),
                  device=x.device, requires_grad=False)


def global_avg_pool(x: Tensor, layout: str = "NCHW") -> Tensor:
    """The mean over the spatial axes, which it drops."""
    axes = (1, 2) if layout == "NHWC" else (2, 3)
    return autograd.op("GlobalAveragePool", lambda v: v.mean(dim=axes), x)


def out_shape(handle: PoolingHandle, in_hw) -> tuple:
    h, w = in_hw
    kh, kw = handle.kernel_size
    sh, sw = handle.stride
    ph, pw = handle.padding
    return (int(np.floor((h + 2 * ph - kh) / sh)) + 1,
            int(np.floor((w + 2 * pw - kw) / sw)) + 1)
