"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart: ``singa_tpu/ops/paged_attention.py`` —
``paged_decode_attention`` (the entry) and ``_decode_kernel`` (the
Pallas TPU kernel).  The kernel source is ``csrc/paged_decode.cu``.

Contract, as in the reference: one query per slot, ``q (S, H, d)``;
page pools ``(N, H, P, d)``; block table ``(S, Ps)`` int32 of physical
page ids (NULL/stale entries are fine: their columns are masked);
``pos (S,)`` int32, the last logical position each slot attends —
columns ``> pos[s]`` carry zero weight.  Returns ``(S, H, d)``.  The
float path only: the int8 ``k_scales``/``v_scales`` variant belongs to
the quantized-serving slice.

Routing: the tensor's device decides.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_reference"]

_NEG_INF = -1e9
_MAX_D = 128
_MAX_P = 256

# kernel launches made by paged_decode_attention (plain-version calls
# and CPU calls do not count)
launches = 0


def paged_decode_attention_reference(q, k_pages, v_pages, table, pos,
                                     sm_scale=None):
    """Plain PyTorch version, on any device: gather each slot's pages
    into one row, mask columns past ``pos`` to ``-1e9``, softmax."""
    S, H, d = q.shape
    P = k_pages.shape[2]
    Ps = table.shape[1]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    idx = table.long()
    kr = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(S, H, Ps * P, d)
    vr = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(S, H, Ps * P, d)
    sc = torch.einsum("shd,shld->shl", q.float(), kr.float()) * scale
    cols = torch.arange(Ps * P, device=q.device)
    live = cols[None] <= pos.long()[:, None]                 # (S, L)
    sc = torch.where(live[:, None], sc, torch.full_like(sc, _NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("shl,shld->shd", w, vr.float()).to(q.dtype)


def _lib():
    lib = _build.load("paged_decode")
    fn = lib.singa_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_pages, v_pages, table, pos, sm_scale=None,
                           k_scales=None, v_scales=None):
    """Single-token attention over paged K/V (see the module docstring).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` or raise."""
    global launches
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 paged decode (k_scales/v_scales) belongs to the "
            "quantized-serving slice (ROADMAP.md queue 1, slice 10)")
    ops = (q, k_pages, v_pages, table, pos)
    dev = q.device
    if any(t.device != dev for t in ops):
        raise ValueError("paged_decode_attention: operands on different "
                         "devices")
    if dev.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, table,
                                                pos, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    S, H, d = q.shape
    N, Hk, P, dk = k_pages.shape
    if (Hk, dk) != (H, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: page pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if table.dim() != 2 or table.shape[0] != S or pos.shape != (S,):
        raise ValueError(f"paged_decode_attention: table "
                         f"{tuple(table.shape)} / pos {tuple(pos.shape)} "
                         f"do not match {S} slots")
    if not 1 <= d <= _MAX_D or not 1 <= P <= _MAX_P:
        raise ValueError(f"paged_decode_attention kernel takes d <= "
                         f"{_MAX_D} and page_tokens <= {_MAX_P}, got d={d},"
                         f" P={P}")
    for t in (q, k_pages, v_pages):
        if t.dtype != torch.float32:
            raise TypeError(f"paged_decode_attention kernel takes float32, "
                            f"got {t.dtype}")
    for t in (table, pos):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode_attention kernel takes int32 "
                            f"table/pos, got {t.dtype}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("paged_decode_attention kernel takes contiguous "
                         "operands")
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _lib()
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             table.data_ptr(), pos.data_ptr(), out.data_ptr(), S, H, P,
             table.shape[1], d, scale,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
