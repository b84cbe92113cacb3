"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``flash_attention``
(the entry), ``_flash_fwd_call`` / ``_fwd_kernel`` (the forward Pallas
TPU kernel), ``_flash_bwd_call`` / ``_dq_kernel`` / ``_dkv_kernel`` (the
backward ones) and ``flash_attention_op`` / ``_flash_nomask`` /
``_flash_masked`` (the gradient).  Kernel sources:
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``, on
the tile layer ``csrc/flash_mma.cuh``: float32 products on the tensor
cores as 3xTF32 ``mma.sync`` tiles (each operand split into a TF32 big
and small part, three products summed), which keeps float32-level
accuracy; :func:`matmul_3xtf32` emulates that product here and
:func:`matmul_1xtf32` the single TF32 product it avoids.

Operands: q, k, v (and the backward's dO) in float32, bfloat16 or
float16.  Every version computes the float32 function of the upcast
operands, as the reference's kernels do (pallas_kernels.py:108-203),
and returns ``o`` and ``dq`` in q's dtype and ``dk``/``dv`` in k's and
v's; the mask, ``lse``, ``delta`` and the split route's partials are
float32.  The kernels take operands of one dtype: where q, k and v
differ (bf16 queries over float32 cache rows), :func:`flash_attention`
promotes them to their common dtype (``torch.promote_types``: float32
for bf16 with float32) and runs that dtype's route, which computes what
the reference's kernels compute on the mixed operands, each upcast to
float32 as it is read; ``o`` comes back in q's dtype, the reference's
``out_shape`` (pallas_kernels.py:314), and each gradient in its
operand's.  The ``(BH, T, d)`` functions below it take one dtype and
raise ``TypeError`` otherwise.

Contract, as in the reference: ``(B, H, T, d)`` inputs; an additive
float mask broadcastable to ``(B, H, T, S)`` carried at its natural
rank (``none``; ``vec`` for a per-key ``(.., 1, S)`` mask; ``dense``
for a ``(.., T, S)`` one); ``causal`` computed from indices; masked
scores at ``-1e9``, never ``-inf``.  The reference runs its softmax over
the key axis zero-padded to 128 columns (score ``-1e9``, zero V): those
columns weigh nothing in an ordinary row, but a row whose every column
is masked averages V over all the swept columns, padding included, so
its output is ``sum(V) / swept`` rather than 0 (the ``1e-30`` clamp on
the denominator never fires, because a finite mask leaves ``l >= 1``).
Both versions here reproduce that.

Backward (``_flash_bwd_call``, the bodies of the reference's
``custom_vjp``): :func:`flash_attention_bwd` runs the dq pass and the
dk/dv pass (``csrc/flash_attention_bwd.cu``) from the forward's ``o``
and ``lse``.  Like the reference kernels it recomputes
``p = exp(s - lse)`` over every swept (row, column) pair and forms
``ds = p (dp - delta)`` there, masked pairs included, so on a fully
masked row (``lse == -1e9``, ``p == 1``) the causal-masked columns of
the diagonal 128-block carry gradient: this is the kernels' formula,
not the autodiff of the forward.  :func:`flash_attention` is
differentiable through a ``torch.autograd.Function`` whose backward is
those kernels; the mask gets no gradient.

Key split: where the forward's blocks (batch*head x 64-row query tiles)
would under-fill the card, :func:`_fwd_split_plan` cuts each tile's
swept key tiles into ranges; one launch computes every range's
unnormalised output, running max and denominator
(:func:`flash_attention_fwd_partial`) and a second merges them
(:func:`flash_attention_fwd_combine`).  Deterministic, no atomics.

Routing: the tensor's device decides.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_fwd_partial",
           "flash_attention_fwd_partial_reference",
           "flash_attention_fwd_combine",
           "flash_attention_fwd_combine_reference",
           "tf32_round", "matmul_3xtf32", "matmul_1xtf32",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "FlashAttentionFunction"]

_NEG_INF = -1e9
_REF_BLOCK = 128          # the reference kernel's key/query block
_MODES = {"none": 0, "vec": 1, "dense": 2}
_KERNEL_D = (16, 32, 64, 128)
# the kernels' operand type codes (csrc/flash_attention_*.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BM = 64                  # query rows a kernel block owns (flash_mma.cuh)
_BN = 64                  # keys in a streamed tile

# kernel launches: the forward kernel (launches, one a flash_attention_fwd
# call on either route), the split route's combine (launches_combine), the
# backward's dq and dk/dv kernels; plain-version and CPU calls do not count.
# The *_lowp counters count the launches of each on 16-bit operands (also
# counted in the counter without the suffix).
launches = 0
launches_combine = 0
launches_dq = 0
launches_dkv = 0
launches_lowp = 0
launches_combine_lowp = 0
launches_dq_lowp = 0
launches_dkv_lowp = 0


def tf32_round(x):
    """``cvt.rna.tf32.f32`` on float32 ``x``: the nearest value with a
    10-bit mantissa, ties away from zero (the low 13 bits cleared)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """``a @ b`` as the kernels compute it: each operand split into
    ``big = tf32(x)`` and ``small = tf32(x - big)``, and
    ``small @ big + big @ small + big @ big`` summed in float32."""
    ab = tf32_round(a)
    bb = tf32_round(b)
    a_small = tf32_round(a.float() - ab)
    b_small = tf32_round(b.float() - bb)
    return (torch.matmul(a_small, bb) + torch.matmul(ab, b_small)
            + torch.matmul(ab, bb))


def matmul_1xtf32(a, b):
    """``a @ b`` as one TF32 product: both operands rounded to TF32."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def _common(*ts):
    """``ts`` in their common dtype (``torch.promote_types``), each cast
    only where it differs."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def _prepare(q, k, v, mask, sm_scale):
    """Collapse ``(B, H, T, d)`` to ``(BH, T, d)`` and the mask to its
    kernel operand ``(MB, 1|T, S)`` with MB in {1, BH}, exactly as the
    reference's ``flash_attention`` does (minus its 128-padding)."""
    B, H, T, d = q.shape
    S = k.shape[2]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    q3 = q.reshape(B * H, T, d)
    k3 = k.reshape(B * H, S, d)
    v3 = v.reshape(B * H, S, d)
    if mask is None:
        return q3, k3, v3, None, scale, "none"
    m = mask.to(torch.float32)
    while m.dim() < 4:
        m = m.unsqueeze(0)
    mB, mH, mT, mS = m.shape
    if mB == 1 and mH == 1:
        m = m.reshape(1, mT, mS)
    else:
        m = m.expand(B, H, mT, mS).reshape(B * H, mT, mS)
    if mT == 1:
        mode = "vec"
        m = m.expand(m.shape[0], 1, S)
    else:
        mode = "dense"
        m = m.expand(m.shape[0], T, S)
    return q3, k3, v3, m.contiguous(), scale, mode


def _scores(q3, k3, mask3, scale, mode, causal, matmul):
    """``s = scale q k^T + mask`` on ``(BH, T, S)``, with ``causal``
    columns past the row at -1e9."""
    T, S = q3.shape[1], k3.shape[1]
    s = matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if mode != "none":
        s = s + mask3
    if causal:
        rows = torch.arange(T, device=q3.device)[:, None]
        cols = torch.arange(S, device=q3.device)[None]
        s = torch.where(cols > rows, torch.full_like(s, _NEG_INF), s)
    return s


def _sweep(T, S, causal, device):
    """Per query row, ``(hi, kend)`` as ``(T, 1)`` int64 tensors: the end
    of the reference's swept key columns (its zero padding included)
    and of the real ones."""
    Sp = -(-S // _REF_BLOCK) * _REF_BLOCK
    rows = torch.arange(T, device=device)[:, None]
    if causal:
        hi = torch.clamp((rows // _REF_BLOCK + 1) * _REF_BLOCK, max=Sp)
    else:
        hi = torch.full_like(rows, Sp)
    return hi, torch.clamp(hi, max=S)


def flash_attention_fwd_reference(q3, k3, v3, mask3, scale, mode, causal,
                                  matmul=torch.matmul):
    """Plain PyTorch version of the kernel on ``(BH, T, d)`` operands:
    returns ``(o, lse)``.  Closed form of the reference's online
    recurrence (start ``m = -1e9``; swept padding columns counted into
    the denominator; causal sweep bounded at the diagonal 128-block).
    ``matmul`` computes its two products (:func:`matmul_3xtf32` to
    emulate the kernel's tensor-core arithmetic)."""
    BH, T, d = q3.shape
    S = k3.shape[1]
    dev = q3.device
    vf = v3.float()
    s = _scores(q3, k3, mask3, scale, mode, causal, matmul)   # (BH, T, S)
    hi, kend = _sweep(T, S, causal, dev)
    cols = torch.arange(S, device=dev)[None]
    s = torch.where(cols < kend, s, torch.full_like(s, -math.inf))
    n_pad = (hi - kend).to(torch.float32)                       # (T, 1)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True) + n_pad * torch.exp(_NEG_INF - m)
    l = torch.clamp(l, min=1e-30)
    o = matmul(p, vf) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0]


class SplitPlan(NamedTuple):
    """The forward's key split: range ``r`` of a query tile covers its
    swept keys in 64-key units ``[r * per, (r + 1) * per)``;
    ``n_split == 1`` is the unsplit route."""
    n_split: int
    per: int


def _tile_kend(T, S, causal):
    """End of the real swept key columns of each 64-row query tile."""
    hi, kend = _sweep(T, S, causal, "cpu")
    return [int(x) for x in kend[::_BM, 0]]


def _fwd_split_plan(BH, T, S, causal, n_sm=132):
    """The key split for ``BH x T`` queries against ``S`` keys on a card
    of ``n_sm`` SMs.  Unsplit when the blocks (BH x 64-row query tiles)
    fill the card; else the fewest equal ranges of 64-key tiles that
    give at least ``2 n_sm`` blocks, at most one range a key tile."""
    # the last query tile sweeps the most real key columns
    kend = S
    if causal:
        last = (-(-T // _BM) - 1) * _BM
        kend = min(S, (last // _REF_BLOCK + 1) * _REF_BLOCK)
    max_tiles = -(-kend // _BN)
    blocks = BH * -(-T // _BM)
    if blocks >= n_sm or max_tiles <= 1:
        return SplitPlan(1, max(max_tiles, 1))
    n_split = min(-(-2 * n_sm // blocks), max_tiles)
    per = -(-max_tiles // n_split)
    return SplitPlan(-(-max_tiles // per), per)


def _split_ranges(plan, T, S, causal):
    """For each 64-row query tile, the key-column ranges ``(lo, hi)`` of
    its non-empty split ranges, in order."""
    out = []
    for kend in _tile_kend(T, S, causal):
        rs = []
        for r in range(plan.n_split):
            lo, hi = r * plan.per * _BN, min(kend, (r + 1) * plan.per * _BN)
            if lo < hi:
                rs.append((lo, hi))
        out.append(rs)
    return out


def flash_attention_fwd_partial_reference(q3, k3, v3, mask3, scale, mode,
                                          causal, plan,
                                          matmul=torch.matmul):
    """Plain version of the split route's forward kernel: for each range
    ``r`` of ``plan``, every row's unnormalised output, running max and
    denominator over its tile's range ``r`` of key columns.  Returns
    ``(o_part (R, BH, T, d), m_part (R, BH, T), l_part (R, BH, T))``; an
    empty range holds ``m = -1e9, l = 0, o = 0`` (the kernel leaves it
    unwritten and the combine skips it)."""
    BH, T, d = q3.shape
    S = k3.shape[1]
    s = _scores(q3, k3, mask3, scale, mode, causal, matmul)
    _, kend = _sweep(T, S, causal, q3.device)
    cols = torch.arange(S, device=q3.device)[None]
    width = plan.per * _BN
    o_part, m_part, l_part = [], [], []
    for r in range(plan.n_split):
        inside = (cols >= r * width) & (cols < torch.clamp(kend,
                                                          max=(r + 1) * width))
        sr = torch.where(inside, s, torch.full_like(s, -math.inf))
        m = torch.clamp(sr.amax(dim=-1, keepdim=True), min=_NEG_INF)
        p = torch.exp(sr - m)
        o_part.append(matmul(p, v3.float()))
        m_part.append(m[..., 0])
        l_part.append(p.sum(dim=-1))
    return torch.stack(o_part), torch.stack(m_part), torch.stack(l_part)


def _valid_ranges(R, T, S, causal, per, device):
    """``(R, 1, T)`` bool: which ranges of each row are non-empty."""
    _, kend = _sweep(T, S, causal, device)
    n_ranges = -(-(-(-kend[:, 0] // _BN)) // per)                # (T,)
    return torch.arange(R, device=device)[:, None, None] < n_ranges[None, None]


def flash_attention_fwd_combine_reference(o_part, m_part, l_part, T, S,
                                          causal, per,
                                          out_dtype=torch.float32):
    """Plain version of the combine kernel: merges each row's non-empty
    ranges (``M = max m``, ``l = sum l_i e^(m_i - M)``,
    ``o = sum o_i e^(m_i - M) / l``) with the padding term and the
    clamp.  Returns ``(o (BH, T, d) in out_dtype, lse (BH, T))``."""
    R = o_part.shape[0]
    valid = _valid_ranges(R, T, S, causal, per, o_part.device)
    m = torch.where(valid, m_part, torch.full_like(m_part, -math.inf))
    M = m.amax(dim=0)                                            # (BH, T)
    w = torch.where(valid, torch.exp(m - M), torch.zeros_like(m))
    l = (torch.where(valid, l_part, torch.zeros_like(l_part)) * w).sum(0)
    o = (torch.where(valid[..., None], o_part, torch.zeros_like(o_part))
         * w[..., None]).sum(0)
    hi, kend = _sweep(T, S, causal, o_part.device)
    l = l + (hi - kend)[:, 0].to(torch.float32) * torch.exp(_NEG_INF - M)
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).to(out_dtype), M + torch.log(l)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn(lib_name, sym, n_ptr, n_int=7, tail=(ctypes.c_float,)):
    """The ctypes function ``sym`` of library ``lib_name``: ``n_ptr``
    pointers, ``n_int`` ints (by default BH, T, S, d, mode, mask_bh,
    causal), then ``tail`` (by default the scale) and the stream."""
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + list(tail) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_operands(name, q3, k3, v3, mask3, mode, extra=()):
    """Check the operands a kernel takes (device, shapes, dtypes,
    contiguous): q, k, v and the 3-d ``extra`` (dO) of one dtype in
    float32, bfloat16 or float16 (checked on CPU tensors too), the mask
    and the 2-d ``extra`` (lse, delta) float32.  Returns ``(dev,
    mask_bh)``, ``dev`` None for CPU tensors (which take the plain
    version)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    ops = [q3, k3, v3] + ([mask3] if mode != "none" else []) + list(extra)
    dev = q3.device
    if any(t.device != dev for t in ops):
        raise ValueError(f"{name}: operands on different devices")
    rows = [q3, k3, v3] + [x for x in extra if x.dim() == 3]
    if rows[0].dtype not in _DTYPES or any(t.dtype != rows[0].dtype
                                           for t in rows):
        raise TypeError(f"{name} takes q, k, v and dO of one dtype in "
                        f"float32, bfloat16 or float16, got "
                        f"{[str(t.dtype) for t in rows]}")
    if dev.type == "cpu":
        return None, 0
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    BH, T, d = q3.shape
    S = k3.shape[1]
    if k3.shape != (BH, S, d) or v3.shape != (BH, S, d):
        raise ValueError(f"{name}: k/v shapes {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)} do not match q {tuple(q3.shape)}")
    if d not in _KERNEL_D:
        raise ValueError(f"{name} kernel takes head dims {_KERNEL_D}, "
                         f"got {d}")
    mask_bh = 0
    if mode != "none":
        want_t = 1 if mode == "vec" else T
        if (mask3.dim() != 3 or mask3.shape[0] not in (1, BH)
                or mask3.shape[1:] != (want_t, S)):
            raise ValueError(f"{name}: {mode} mask shape "
                             f"{tuple(mask3.shape)} is not (1|{BH}, "
                             f"{want_t}, {S})")
        mask_bh = int(mask3.shape[0] == BH and BH > 1)
    for t in ops:
        if all(t is not r for r in rows) and t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes a float32 mask, lse and "
                            f"delta, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous operands")
    for t in rows:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel stages rows with 16-byte "
                             f"cp.async: operands must be 16-byte aligned")
    return dev, mask_bh


def _launch_fwd(q3, k3, v3, mask3, scale, mode, mask_bh, causal, outs,
                parts, plan):
    BH, T, d = q3.shape
    dev = q3.device
    fn = _fn("flash_attention_fwd", "singa_flash_attention_fwd", 9, 10)
    ptrs = [t.data_ptr() if t is not None else None for t in outs + parts]
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None, *ptrs, BH, T,
             k3.shape[1], d, _MODES[mode], mask_bh, int(bool(causal)),
             plan.n_split, plan.per, _DTYPES[q3.dtype], float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {err})")
    _count("launches", q3.dtype)


def flash_attention_fwd(q3, k3, v3, mask3, scale, mode, causal):
    """The kernel wrapper on ``(BH, T, d)`` operands: returns
    ``(o, lse)``.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/flash_attention_fwd.cu`` or raise: one launch where
    the blocks fill the card, else the key split (a partial launch and a
    combine, :func:`_fwd_split_plan`).  ``o`` is in q's dtype on either
    route."""
    dev, mask_bh = _kernel_operands("flash_attention", q3, k3, v3, mask3,
                                    mode)
    if dev is None:
        return flash_attention_fwd_reference(q3, k3, v3, mask3, scale, mode,
                                             causal)
    BH, T, d = q3.shape
    S = k3.shape[1]
    plan = _fwd_split_plan(BH, T, S, causal,
                           _sm_count(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
    if plan.n_split > 1:
        return _fwd_split(q3, k3, v3, mask3, scale, mode, causal, plan)
    return _fwd_unsplit(q3, k3, v3, mask3, scale, mode, mask_bh, causal,
                        plan)


def _fwd_split(q3, k3, v3, mask3, scale, mode, causal, plan):
    """The split route under ``plan``: the partial launch, then the
    combine writing ``o`` in q's dtype (each the plain version on CPU
    tensors)."""
    parts = flash_attention_fwd_partial(q3, k3, v3, mask3, scale, mode,
                                        causal, plan)
    return flash_attention_fwd_combine(*parts, q3.shape[1], k3.shape[1],
                                       causal, plan.per, q3.dtype)


def _count(name, dtype):
    """One launch on the counter ``name``, and on its ``_lowp`` twin
    when the operands are 16-bit."""
    g = globals()
    g[name] += 1
    if dtype != torch.float32:
        g[name + "_lowp"] += 1


def _fwd_unsplit(q3, k3, v3, mask3, scale, mode, mask_bh, causal, plan):
    """The unsplit route's launch (``plan.n_split == 1``) on CUDA
    operands that :func:`_kernel_operands` has checked."""
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[:2], dtype=torch.float32, device=q3.device)
    _launch_fwd(q3, k3, v3, mask3, scale, mode, mask_bh, causal, [o, lse],
                [None] * 3, plan)
    return o, lse


def flash_attention_fwd_partial(q3, k3, v3, mask3, scale, mode, causal,
                                plan):
    """The split route's forward launch (``plan.n_split > 1``): returns
    ``(o_part, m_part, l_part)`` as
    :func:`flash_attention_fwd_partial_reference` does, except that an
    empty range is left unwritten.  CPU tensors run that plain version;
    CUDA tensors launch or raise."""
    dev, mask_bh = _kernel_operands("flash_attention", q3, k3, v3, mask3,
                                    mode)
    if dev is None:
        return flash_attention_fwd_partial_reference(q3, k3, v3, mask3, scale,
                                                     mode, causal, plan)
    if plan.n_split < 2:
        raise ValueError("flash_attention_fwd_partial needs a split plan")
    BH, T, d = q3.shape
    o_part = torch.empty((plan.n_split, BH, T, d), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((plan.n_split, BH, T), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    _launch_fwd(q3, k3, v3, mask3, scale, mode, mask_bh, causal, [None] * 2,
                [o_part, m_part, l_part], plan)
    return o_part, m_part, l_part


def flash_attention_fwd_combine(o_part, m_part, l_part, T, S, causal, per,
                                out_dtype=torch.float32):
    """The combine kernel's wrapper (``csrc/flash_attention_fwd.cu``):
    merges the ranges of :func:`flash_attention_fwd_partial` into
    ``(o, lse)``, ``o`` in ``out_dtype`` (float32, bfloat16 or float16;
    :func:`flash_attention_fwd` passes q's).  CPU tensors run
    :func:`flash_attention_fwd_combine_reference`; CUDA tensors launch
    or raise."""
    R, BH, T_, d = o_part.shape
    if out_dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd_combine writes float32, "
                        f"bfloat16 or float16, got {out_dtype}")
    dev = o_part.device
    if any(t.device != dev for t in (m_part, l_part)):
        raise ValueError("flash_attention_fwd_combine: operands on "
                         "different devices")
    if dev.type == "cpu":
        return flash_attention_fwd_combine_reference(o_part, m_part, l_part,
                                                     T, S, causal, per,
                                                     out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd_combine: unsupported device "
                         f"{dev}")
    if T_ != T or m_part.shape != (R, BH, T) or l_part.shape != (R, BH, T):
        raise ValueError(f"flash_attention_fwd_combine: shapes "
                         f"{tuple(o_part.shape)}, {tuple(m_part.shape)}, "
                         f"{tuple(l_part.shape)} do not match T {T}")
    for t in (o_part, m_part, l_part):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("flash_attention_fwd_combine takes contiguous "
                             "float32 operands")
    o = torch.empty((BH, T, d), dtype=out_dtype, device=dev)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    fn = _fn("flash_attention_fwd", "singa_flash_attention_fwd_combine", 5,
             7, ())
    err = fn(o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
             o.data_ptr(), lse.data_ptr(), BH, T, S, d, int(bool(causal)),
             int(per), _DTYPES[out_dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention combine kernel launch failed "
                           f"(cudaError {err})")
    _count("launches_combine", out_dtype)
    return o, lse


def _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode, causal,
               matmul):
    """``(p, ds)`` of the reference kernels on ``(BH, T, S)``:
    ``p = exp(s - lse)`` on every pair of the reference's sweep (all
    columns, or with ``causal`` those up to the row's diagonal
    128-block), 0 elsewhere; ``ds = p (dp - delta)``."""
    T, S = q3.shape[1], k3.shape[1]
    s = _scores(q3, k3, mask3, scale, mode, causal, matmul)
    p = torch.exp(s - lse[..., None])
    if causal:
        _, kend = _sweep(T, S, causal, q3.device)
        swept = torch.arange(S, device=q3.device)[None] < kend
        p = torch.where(swept, p, torch.zeros_like(p))
    dp = matmul(do3.float(), v3.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta, do3,
                                     scale, mode, causal,
                                     matmul=torch.matmul):
    """Plain PyTorch version of the dq kernel (the reference's
    ``_dq_kernel``): ``dq = scale * ds @ k``.  ``matmul`` computes the
    products, as in :func:`flash_attention_fwd_reference`."""
    _, ds = _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                       causal, matmul)
    return (matmul(ds, k3.float()) * scale).to(q3.dtype)


def flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse, delta, do3,
                                      scale, mode, causal,
                                      matmul=torch.matmul):
    """Plain PyTorch version of the dk/dv kernel (the reference's
    ``_dkv_kernel``): ``dk = scale * ds^T @ q``, ``dv = p^T @ dO``."""
    p, ds = _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                       causal, matmul)
    dk = matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = matmul(p.transpose(1, 2), do3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_reference(q3, k3, v3, mask3, o3, lse, do3, scale,
                                  mode, causal, matmul=torch.matmul):
    """Plain PyTorch version of :func:`flash_attention_bwd`, written from
    the reference kernels' formulas, not from autograd."""
    delta = (do3.float() * o3.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta, do3,
                                          scale, mode, causal, matmul)
    dk, dv = flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse, delta,
                                               do3, scale, mode, causal,
                                               matmul)
    return dq, dk, dv


def _bwd_operands(name, q3, k3, v3, mask3, lse, delta, do3, mode):
    dev, mask_bh = _kernel_operands(name, q3, k3, v3, mask3, mode,
                                    (lse, delta, do3))
    if dev is not None:
        BH, T, _ = q3.shape
        if do3.shape != q3.shape or lse.shape != (BH, T) or \
                delta.shape != (BH, T):
            raise ValueError(f"{name}: dO {tuple(do3.shape)}, lse "
                             f"{tuple(lse.shape)}, delta "
                             f"{tuple(delta.shape)} do not match q "
                             f"{tuple(q3.shape)}")
    return dev, mask_bh


def flash_attention_bwd_dq(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                           causal):
    """The dq kernel's wrapper (``csrc/flash_attention_bwd.cu``) on
    ``(BH, T, d)`` operands with ``lse`` and ``delta`` ``(BH, T)``.  CPU
    tensors run the plain version; CUDA tensors launch or raise."""
    dev, mask_bh = _bwd_operands("flash_attention_bwd", q3, k3, v3, mask3,
                                 lse, delta, do3, mode)
    if dev is None:
        return flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta,
                                                do3, scale, mode, causal)
    BH, T, d = q3.shape
    dq = torch.empty_like(q3)
    fn = _fn("flash_attention_bwd", "singa_flash_attention_bwd_dq", 8, 8)
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None, do3.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T,
             k3.shape[1], d, _MODES[mode], mask_bh, int(bool(causal)),
             _DTYPES[q3.dtype], float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dq kernel launch failed "
                           f"(cudaError {err})")
    _count("launches_dq", q3.dtype)
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                            causal):
    """The dk/dv kernel's wrapper (``csrc/flash_attention_bwd.cu``):
    returns ``(dk, dv)``.  CPU tensors run the plain version; CUDA
    tensors launch or raise."""
    dev, mask_bh = _bwd_operands("flash_attention_bwd", q3, k3, v3, mask3,
                                 lse, delta, do3, mode)
    if dev is None:
        return flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse,
                                                 delta, do3, scale, mode,
                                                 causal)
    BH, T, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    fn = _fn("flash_attention_bwd", "singa_flash_attention_bwd_dkv", 9, 8)
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None, do3.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             BH, T, k3.shape[1], d, _MODES[mode], mask_bh,
             int(bool(causal)), _DTYPES[q3.dtype], float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dk/dv kernel launch failed "
                           f"(cudaError {err})")
    _count("launches_dkv", q3.dtype)
    return dk, dv


def flash_attention_bwd(q3, k3, v3, mask3, o3, lse, do3, scale, mode,
                        causal):
    """Flash-attention backward on ``(BH, T, d)`` operands (``o3`` and
    ``lse`` from :func:`flash_attention_fwd`, ``do3`` the output's
    cotangent): returns ``(dq, dk, dv)``.  ``delta = rowsum(dO * O)`` is
    one PyTorch op on the float32-upcast operands, as in the reference
    (pallas_kernels.py:290); then the dq and the dk/dv kernels run (their
    plain versions for CPU tensors)."""
    if o3.shape != q3.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o3.shape)} does "
                         f"not match q {tuple(q3.shape)}")
    delta = (do3.float() * o3.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q3, k3, v3, mask3, lse, delta, do3, scale,
                                mode, causal)
    dk, dv = flash_attention_bwd_dkv(q3, k3, v3, mask3, lse, delta, do3,
                                     scale, mode, causal)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on ``(BH, T, d)`` operands — the
    counterpart of the reference's ``_flash_nomask`` / ``_flash_masked``
    ``custom_vjp``s.  Forward saves ``o`` and ``lse``; backward runs
    :func:`flash_attention_bwd`.  The mask and the settings get no
    gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, mask3, scale, mode, causal):
        o, lse = flash_attention_fwd(q3, k3, v3, mask3, scale, mode, causal)
        ctx.save_for_backward(q3, k3, v3, mask3, o, lse)
        ctx.settings = (scale, mode, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, mask3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, mask3, o, lse,
                                         do.contiguous(), *ctx.settings)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, sm_scale=None, causal=False):
    """Fused attention over ``(B, H, T, d)`` tensors (see the module
    docstring for the mask contract).  Returns ``(B, H, T, d)`` in q's
    dtype; q, k and v of different dtypes run in their common dtype.
    Differentiable in q, k and v (each gradient in its operand's dtype);
    called without grad (or on inputs that need none) it runs the
    forward kernel alone and saves nothing."""
    B, H, T, d = q.shape
    out_dtype = q.dtype
    q, k, v = _common(q, k, v)
    q3, k3, v3, m3, scale, mode = _prepare(q, k, v, mask, sm_scale)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttentionFunction.apply(q3, k3, v3, m3, scale, mode,
                                         bool(causal))
    else:
        o, _ = flash_attention_fwd(q3, k3, v3, m3, scale, mode, causal)
    return o.reshape(B, H, T, d).to(out_dtype)


def flash_attention_reference(q, k, v, mask=None, sm_scale=None,
                              causal=False):
    """Plain PyTorch version of :func:`flash_attention`'s forward, on any
    device."""
    B, H, T, d = q.shape
    out_dtype = q.dtype
    q3, k3, v3, m3, scale, mode = _prepare(*_common(q, k, v), mask, sm_scale)
    o, _ = flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode, causal)
    return o.reshape(B, H, T, d).to(out_dtype)
