"""Token sampling for the decode hot path.
Counterpart: ``singa_tpu/serving/sampling.py``.

``top_k == 0`` means "no top-k filter"; ``temperature <= 0`` means
greedy.  Where the JAX package threads ``jax.random`` keys, the port
draws from ``torch.Generator`` objects (Gumbel-max over the filtered
logits, the same distribution as ``jax.random.categorical``): one
``rand(V)`` draw a row and a token.  The two never produce the same bits
from one seed; a request's k-th token here takes the k-th draw of a
generator seeded with its seed, whatever the batch it shares the engine
with (how the engine keeps that while every slot of a captured step
draws: ``serving/engine.py``).  16-bit logits (a bf16 policy) are
divided by the temperature in float32, as the reference's float32
temperature promotes them; the float32 noise is added to that.

:func:`sample_logits` takes the temperature and top-k from the host (the
eager prefills); :func:`sample_logits_per_row` takes them as device
tensors and reads nothing from the host, so a captured step runs it (the
engine's steps, its admission token included, and ``generate``'s decode
loop).  Both give the same bits on the same logits and draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SamplingParams", "sample_logits", "sample_logits_per_row"]


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature=0`` is greedy;
    ``top_k=0`` disables the top-k filter."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def _topk_filter(lg, top_k):
    """Mask logits below the ``top_k``-th largest to -1e9; no-op where
    ``top_k <= 0``.  ``lg`` (..., V); ``top_k`` a Python int or a
    tensor broadcastable over the batch dims."""
    V = lg.shape[-1]
    if not torch.is_tensor(top_k):
        if top_k <= 0:
            return lg
        kth = torch.topk(lg, min(int(top_k), V), dim=-1).values[..., -1:]
        return torch.where(lg < kth, torch.full_like(lg, -1e9), lg)
    kk = (torch.clamp(top_k, 1, V) - 1).long()
    srt = torch.sort(lg, dim=-1, descending=True).values
    idx = torch.broadcast_to(kk, lg.shape[:-1])[..., None]
    kth = torch.gather(srt, -1, idx)                 # k-th largest value
    drop = (torch.broadcast_to(top_k, lg.shape[:-1])[..., None] > 0) \
        & (lg < kth)
    return torch.where(drop, torch.full_like(lg, -1e9), lg)


def _gumbel(gen, V, device):
    u = torch.rand(V, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u))


def sample_logits(logits, temperature: float, top_k: int, gen):
    """One sampling step for ``logits`` (B, V) with host-side
    ``temperature``/``top_k`` and one generator (the admission chunk's
    first token)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature <= 0:
        return greedy
    # float32 as the reference's traced float32 temperature promotes it
    lg = _topk_filter(logits.float() / float(temperature), top_k)
    noise = torch.stack([_gumbel(gen, lg.shape[-1], lg.device)
                         for _ in range(lg.shape[0])])
    return torch.argmax(lg + noise, dim=-1).to(torch.int32)


def sample_logits_per_row(logits, temperature, top_k, gens):
    """Per-row sampling (the serving engine's steps, ``generate``'s
    decode loop): ``logits`` (S, V), ``temperature`` (S,), ``top_k`` (S,)
    device tensors and ``gens`` a list of S generators (None for rows
    that draw nothing; one generator may stand for several rows, drawn
    in row order) or None when every row is greedy — then no noise is
    drawn at all.  A greedy row that draws has its noise discarded."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if gens is None or all(g is None for g in gens):
        return greedy
    S, V = logits.shape
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    lg = _topk_filter(logits / safe_t[:, None], top_k)
    zero = torch.zeros(V, dtype=lg.dtype, device=lg.device)
    noise = torch.stack([_gumbel(g, V, lg.device) if g is not None else zero
                         for g in gens])
    samp = torch.argmax(lg + noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, samp, greedy)
