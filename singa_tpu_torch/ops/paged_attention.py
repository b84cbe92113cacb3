"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart: ``singa_tpu/ops/paged_attention.py`` —
``paged_decode_attention`` (the entry) and ``_decode_kernel`` (the
Pallas TPU kernel, float path and quantized branch).  The kernel source
is ``csrc/paged_decode.cu``.

Contract, as in the reference: one query per slot, ``q (S, H, d)``;
page pools ``(N, H, P, d)``; block table ``(S, Ps)`` int32 of physical
page ids (NULL/stale entries are fine: their columns are masked);
``pos (S,)`` int32, the last logical position each slot attends —
columns ``> pos[s]`` carry zero weight.  Returns ``(S, H, d)`` in q's
dtype.  Quantized pools pass ``k_scales``/``v_scales`` ``(N, H, P)``
(pass both or neither): the K scale multiplies the score column, the
softmax denominator sums the unscaled weights, and the V scale folds
into each weight before the V product.

The kernel takes float32 queries against float32 or bfloat16 pages
(the storage override), or int8 pages with bfloat16 or float32 scales.

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

# the kernel's type codes (csrc/paged_decode.cu)
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SCALE = {torch.bfloat16: 1, torch.float32: 2}

# kernel launches made by paged_decode_attention (plain-version calls
# and CPU calls do not count): ``launches`` over float32 / bfloat16
# pages, ``launches_q8`` over int8 pages
launches = 0
launches_q8 = 0


def paged_decode_attention_reference(q, k_pages, v_pages, table, pos,
                                     sm_scale=None, k_scales=None,
                                     v_scales=None):
    """Plain PyTorch version, on any device: gather each slot's pages
    (and scales) into one row, score, mask columns past ``pos`` to
    ``-1e9``, softmax, fold the V scales into the weights."""
    S, H, d = q.shape
    P = k_pages.shape[2]
    Ps = table.shape[1]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    idx = table.long()

    def rows(pool):                           # (N, H, P, ...) -> (S, H, L, ...)
        g = pool[idx]
        return g.transpose(1, 2).reshape(S, H, Ps * P, *pool.shape[3:])

    kr, vr = rows(k_pages), rows(v_pages)
    sc = torch.einsum("shd,shld->shl", q.float(), kr.float()) * scale
    if k_scales is not None:
        sc = sc * rows(k_scales).float()
    cols = torch.arange(Ps * P, device=q.device)
    live = cols[None] <= pos.long()[:, None]                 # (S, L)
    sc = torch.where(live[:, None], sc, torch.full_like(sc, _NEG_INF))
    w = torch.softmax(sc, dim=-1)
    if v_scales is not None:
        w = w * rows(v_scales).float()
    return torch.einsum("shl,shld->shd", w, vr.float()).to(q.dtype)


def _lib():
    lib = _build.load("paged_decode")
    fn = lib.singa_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_operands(q, k_pages, v_pages, table, pos, k_scales,
                           v_scales):
    """Raise on anything the kernel does not take."""
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
    if q.dtype != torch.float32:
        raise TypeError(f"paged_decode_attention kernel takes a float32 "
                        f"query, got {q.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode_attention: K pages {k_pages.dtype}, "
                        f"V pages {v_pages.dtype}")
    if k_scales is None:
        if k_pages.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"paged_decode_attention kernel takes float32 "
                            f"or bfloat16 pages without scales, got "
                            f"{k_pages.dtype}")
    else:
        if k_pages.dtype != torch.int8:
            raise TypeError(f"paged_decode_attention kernel takes scales "
                            f"with int8 pages only, got {k_pages.dtype}")
        for t in (k_scales, v_scales):
            if t.shape != (N, H, P):
                raise ValueError(f"paged_decode_attention: scales "
                                 f"{tuple(t.shape)}, expected {(N, H, P)}")
            if t.dtype != k_scales.dtype or t.dtype not in _SCALE:
                raise TypeError(f"paged_decode_attention kernel takes "
                                f"bfloat16 or float32 scales, got "
                                f"{k_scales.dtype}/{v_scales.dtype}")
    for t in (table, pos):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode_attention kernel takes int32 "
                            f"table/pos, got {t.dtype}")


def paged_decode_attention(q, k_pages, v_pages, table, pos, sm_scale=None,
                           k_scales=None, v_scales=None):
    """Single-token attention over paged K/V (see the module docstring).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` or raise."""
    global launches, launches_q8
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    ops = [q, k_pages, v_pages, table, pos]
    if k_scales is not None:
        ops += [k_scales, v_scales]
    dev = q.device
    if any(t.device != dev for t in ops):
        raise ValueError("paged_decode_attention: operands on different "
                         "devices")
    if dev.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, table,
                                                pos, sm_scale, k_scales,
                                                v_scales)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    _check_kernel_operands(q, k_pages, v_pages, table, pos, k_scales,
                           v_scales)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("paged_decode_attention kernel takes contiguous "
                         "operands")
    S, H, d = q.shape
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    quant = k_scales is not None
    out = torch.empty_like(q)
    fn = _lib()
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr() if quant else None,
             v_scales.data_ptr() if quant else None,
             table.data_ptr(), pos.data_ptr(), out.data_ptr(), S, H,
             k_pages.shape[2], table.shape[1], d, scale,
             _ELEM[k_pages.dtype], _SCALE[k_scales.dtype] if quant else 0,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {err})")
    if quant:
        launches_q8 += 1
    else:
        launches += 1
    return out
