"""Layers of the port.  Counterpart: ``singa_tpu/layer.py``.

Only :func:`apply_rope` is ported so far (the serving slice needs it);
the rest of the layer catalogue belongs to the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["apply_rope"]


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
