"""The reference's v2-era metric API.  Counterpart:
``singa_tpu/metric.py`` (``python/singa/metric.py`` upstream).

``forward(x, y)`` returns the per-sample metric as a
:class:`~singa_tpu_torch.tensor.Tensor`; ``evaluate(x, y)`` the batch
mean as a float.  ``x`` and ``y`` may be Tensors, torch tensors or numpy
arrays.
"""

from __future__ import annotations

import torch

from .loss import _data
from .tensor import Tensor

__all__ = ["Metric", "Accuracy"]


class Metric:
    def forward(self, x, y) -> Tensor:
        raise NotImplementedError

    def evaluate(self, x, y) -> float:
        return float(self.forward(x, y).data.mean())


class Accuracy(Metric):
    """Top-k accuracy over the last axis; integer or one-hot targets
    (reference: ``metric.py::Accuracy``)."""

    def __init__(self, top_k: int = 1):
        self.top_k = int(top_k)

    def forward(self, x, y) -> Tensor:
        xv = _data(x)
        yv = _data(y).to(xv.device)
        if yv.dim() == xv.dim():                    # one-hot -> labels
            yv = torch.argmax(yv, dim=-1)
        labels = yv.long()
        if self.top_k == 1:
            hit = torch.argmax(xv, dim=-1) == labels
        else:
            k = min(self.top_k, xv.shape[-1])
            idx = torch.topk(xv, k, dim=-1).indices
            hit = (idx == labels[..., None]).any(dim=-1)
        dev = x.device if isinstance(x, Tensor) else xv.device
        return Tensor(data=hit.to(torch.float32), device=dev,
                      requires_grad=False)
