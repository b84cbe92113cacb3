"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch versions.

Counterpart: ``singa_tpu/ops/paged_attention.py`` —
``paged_decode_attention`` (the entry) and ``_decode_kernel`` (the
Pallas TPU kernel, float path and quantized branch).  The kernel source
is ``csrc/paged_decode.cu``.

Contract, as in the reference: one query per slot, ``q (S, H, d)``;
page pools ``(N, H, P, d)``; block table ``(S, Ps)`` int32 of physical
page ids (NULL/stale entries are valid ids); ``pos (S,)`` int32, the
last logical position each slot attends.  Returns ``(S, H, d)`` in q's
dtype (float32, bfloat16 or float16; the query is upcast to float32 as
the pages are, as the reference's ``.astype(f32)`` does).  Quantized
pools pass ``k_scales``/``v_scales`` ``(N, H, P)``
(pass both or neither): the K scale multiplies the score column, the
softmax denominator sums the unscaled weights, and the V scale folds
into each weight before the V product.

What the reference computes: every column of a slot's ``Ps * P`` table
row is scored, a column ``> pos[s]`` is replaced by the finite ``-1e9``,
and the softmax runs over the whole row.  So columns past ``pos`` weigh
exactly zero while one column is live, and a slot with ``pos < 0`` has
every column at ``-1e9``: a uniform softmax, whose output is the mean of
``v_scale * v`` over the slot's whole table row (stale and NULL entries
included).  ``pos >= Ps * P - 1`` makes every column live.

The kernel takes a float32, bfloat16 or float16 query against float32,
bfloat16 or float16 pages, or int8 pages with bfloat16 or float32
scales, the page dtype independent of the query's (a bfloat16 engine
runs a bfloat16 query over bfloat16 pages, or over int8 or float32
pages with ``kv_dtype``); it writes the query's dtype.
It splits each slot's page walk: ``_split_plan`` cuts the ``Ps`` table
entries into ``R`` ranges of ``ppr`` pages from the shapes alone (never
from ``pos``, which stays on the device), at least two blocks a
multiprocessor and at most ``_MAX_PPR`` pages a range: at the serving
shape (8 slots, 12 heads, 64 pages) 8 ranges of 8 pages, 768 blocks.
A range wholly past ``pos`` reads nothing.  A slot with one live range
gets its output from that range's block; otherwise each live range
leaves its online-softmax state ``(m, l, acc)`` in a partials buffer,
and a second launch from the same C entry merges each slot's live
ranges in range order (deterministic, no atomics, one host call).
Nothing carries from one call to the next: the partials buffer
(``_scratch``) is allocated per call, which its merge reads in stream
order; a call that a CUDA graph records takes it from the graph's
private pool, which the graph holds for its lifetime.  ``paged_decode_partial_reference``
and ``paged_decode_merge_reference`` are the plain versions of the two
halves of that decomposition.

Routing: the tensor's device decides.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .flash_attention import _sm_count

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_decode_partial_reference", "paged_decode_merge_reference"]

_NEG_INF = -1e9
_MAX_D = 128
_MAX_P = 256
# pages a range at most, in the card's plan
_MAX_PPR = 8

# the kernel's type codes (csrc/paged_decode.cu)
_QELEM = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
         torch.float16: 3}
_SCALE = {torch.bfloat16: 1, torch.float32: 2}

# kernel launches made by paged_decode_attention (plain-version calls
# and CPU calls do not count): ``launches`` over float pages,
# ``launches_q8`` over int8 pages; ``launches_merge`` counts the merge
# launches of either (the split route, R > 1); ``launches_lowp`` counts
# the launches of either on a 16-bit query
launches = 0
launches_q8 = 0
launches_merge = 0
launches_lowp = 0


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


@functools.lru_cache(maxsize=None)
def _split_plan(S, H, Ps, n_sm):
    """``(R, ppr)``: each slot's ``Ps`` table entries cut into ``R``
    ranges of ``ppr`` pages (the last may be shorter, none is empty),
    from the shapes alone: at least ``2 * n_sm`` blocks of (range, head,
    slot) where the pages allow it, and at most ``_MAX_PPR`` pages a
    range."""
    R = max(-(-2 * n_sm // (S * H)), -(-Ps // _MAX_PPR))
    ppr = max(1, Ps // R)             # ceil(Ps / ppr) >= R
    return -(-Ps // ppr), ppr


def _live_ranges(pos, R, ppr, P, Ps):
    """``(S,)`` ranges a slot's launch reads: those up to the one holding
    column ``pos`` (``pos`` past the row counts as its last column), or
    all ``R`` for ``pos < 0``."""
    last = torch.clamp(pos.long(), max=Ps * P - 1)
    return torch.where(pos < 0, R, torch.div(last, P * ppr,
                                             rounding_mode="floor") + 1)


def paged_decode_partial_reference(q, k_pages, v_pages, table, pos, plan,
                                   sm_scale=None, k_scales=None,
                                   v_scales=None):
    """Plain version of the kernel's partial states under ``plan = (R,
    ppr)``: for each (slot, head, range) the online-softmax state over
    the range's live columns, ``ml (S, H, R, 2)`` (``m`` from ``-1e9``,
    ``l`` the sum of unscaled weights) and ``acc (S, H, R, d)``, float32.
    A slot with ``pos < 0`` scores every column ``-1e9`` (weight 1); a
    range past ``pos`` holds ``(-1e9, 0, 0)``, which the kernel never
    writes and the merge never reads."""
    R, ppr = plan
    S, H, d = q.shape
    P = k_pages.shape[2]
    Ps = table.shape[1]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    idx = table.long()
    L, Lp = Ps * P, R * ppr * P

    def rows(pool):                     # (N, H, P, ...) -> (S, H, Lp, ...)
        g = pool[idx].float().transpose(1, 2).reshape(S, H, L,
                                                      *pool.shape[3:])
        pad = [0, 0] * (g.dim() - 3) + [0, Lp - L]
        return torch.nn.functional.pad(g, pad)

    sc = torch.einsum("shd,shld->shl", q.float(), rows(k_pages)) * scale
    if k_scales is not None:
        sc = sc * rows(k_scales)
    neg = (pos < 0)[:, None, None]
    sc = torch.where(neg, torch.full_like(sc, _NEG_INF), sc)
    cols = torch.arange(Lp, device=q.device)
    live = ((cols[None] <= pos.long()[:, None]) | (pos < 0)[:, None]) \
        & (cols < L)[None]                                  # (S, Lp)
    sc = sc.view(S, H, R, ppr * P)
    live = live.view(S, 1, R, ppr * P)
    m = torch.where(live, sc, torch.full_like(sc, -math.inf)).amax(-1)
    m = torch.clamp(m, min=_NEG_INF)                        # (S, H, R)
    p = torch.where(live, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    if v_scales is not None:
        p = p * rows(v_scales).view(S, H, R, ppr * P)
    acc = torch.einsum("shrc,shrcd->shrd", p,
                       rows(v_pages).view(S, H, R, ppr * P, d))
    return torch.stack([m, l], -1), acc


def paged_decode_merge_reference(ml, acc, pos, plan, page_tokens,
                                 pages_per_slot):
    """Plain version of the split route's merge launch: each slot's live
    ranges (``_live_ranges``) merged,
    ``o = sum_r acc_r e^(m_r - M) / max(sum_r l_r e^(m_r - M), 1e-30)``.
    Returns ``(S, H, d)`` float32."""
    R, ppr = plan
    n_live = _live_ranges(pos, R, ppr, page_tokens, pages_per_slot)
    use = (torch.arange(R, device=pos.device)[None] < n_live[:, None])
    use = use[:, None, :]                                   # (S, 1, R)
    m = torch.where(use, ml[..., 0], torch.full_like(ml[..., 0], _NEG_INF))
    top = m.amax(-1, keepdim=True)
    f = torch.where(use, torch.exp(m - top), torch.zeros_like(m))
    # ranges past pos were never written: their slots hold anything
    den = torch.where(use, ml[..., 1] * f, torch.zeros_like(f)).sum(-1)
    num = torch.where(use[..., None], acc * f[..., None],
                      torch.zeros_like(acc)).sum(-2)
    return num / torch.clamp(den, min=1e-30)[..., None]


_FN = None


def _fn():
    """The kernel's C entry, resolved once."""
    global _FN
    if _FN is None:
        fn = _build.load("paged_decode").singa_paged_decode
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _stream(index):
    """The current stream of CUDA device ``index`` as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def _scratch(device, n):
    """``n`` float32 of scratch for one split call's partials (allocated
    on the current stream: the memory goes to no later work before the
    merge has read it)."""
    return torch.empty(n, dtype=torch.float32, device=device)


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
    if q.dtype not in _QELEM:
        raise TypeError(f"paged_decode_attention kernel takes a float32, "
                        f"bfloat16 or float16 query, got {q.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode_attention: K pages {k_pages.dtype}, "
                        f"V pages {v_pages.dtype}")
    if k_scales is None:
        if k_pages.dtype not in _QELEM:
            raise TypeError(f"paged_decode_attention kernel takes float32, "
                            f"bfloat16 or float16 pages without scales, got "
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
    return _kernel_call(q, k_pages, v_pages, table, pos, sm_scale, k_scales,
                        v_scales)


def _kernel_call(q, k_pages, v_pages, table, pos, sm_scale, k_scales,
                 v_scales):
    """The wrapper's CUDA path: check the operands, take the card's plan
    (from the shapes and the SM count, cached) and launch."""
    _check_kernel_operands(q, k_pages, v_pages, table, pos, k_scales,
                           v_scales)
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and table.is_contiguous()
            and pos.is_contiguous()
            and (k_scales is None or (k_scales.is_contiguous()
                                      and v_scales.is_contiguous()))):
        raise ValueError("paged_decode_attention kernel takes contiguous "
                         "operands")
    S, H, d = q.shape
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    return _launch(q, k_pages, v_pages, table, pos, scale, k_scales,
                   v_scales, _split_plan(S, H, table.shape[1],
                                         _sm_count(q.device.index)))


def _launch(q, k_pages, v_pages, table, pos, scale, k_scales, v_scales,
            plan):
    """The kernel's launches under ``plan = (R, ppr)``: the ranges, and
    their merge when ``R > 1``."""
    global launches, launches_q8, launches_merge, launches_lowp
    S, H, d = q.shape
    R, ppr = plan
    stream = _stream(q.device.index)
    scratch = _scratch(q.device, S * H * R * (d + 2)) if R > 1 else None
    out = torch.empty_like(q)
    quant = k_scales is not None
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr() if quant else None,
                v_scales.data_ptr() if quant else None,
                table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), S, H,
                k_pages.shape[2], table.shape[1], d, R, ppr, scale,
                _QELEM[q.dtype], _ELEM[k_pages.dtype],
                _SCALE[k_scales.dtype] if quant else 0, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {err})")
    if quant:
        launches_q8 += 1
    else:
        launches += 1
    if R > 1:
        launches_merge += 1
    if q.dtype != torch.float32:
        launches_lowp += 1
    return out


def _merge_launch(parts, pos, out, page_tokens, pages_per_slot, plan):
    """The merge launch alone, on the partials ``parts`` (S, H, R, d + 2)
    float32 that a split launch under ``plan`` left, into ``out`` (S, H,
    d) of the query's dtype: for checking and timing it by itself (not
    counted)."""
    S, H, R, d2 = parts.shape
    fn = _build.load("paged_decode").singa_paged_decode_merge
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(parts.data_ptr(), pos.data_ptr(), out.data_ptr(), S, H,
             page_tokens, pages_per_slot, d2 - 2, R, plan[1],
             _QELEM[out.dtype], _stream(out.device.index))
    if err != 0:
        raise RuntimeError(f"paged_decode merge launch failed (cudaError "
                           f"{err})")
    return out
