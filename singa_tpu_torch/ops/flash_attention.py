"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``flash_attention``
(the entry), ``_flash_fwd_call`` / ``_fwd_kernel`` (the forward Pallas
TPU kernel), ``_flash_bwd_call`` / ``_dq_kernel`` / ``_dkv_kernel`` (the
backward ones) and ``flash_attention_op`` / ``_flash_nomask`` /
``_flash_masked`` (the gradient).  Kernel sources:
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``.

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

Routing: the tensor's device decides.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "FlashAttentionFunction"]

_NEG_INF = -1e9
_REF_BLOCK = 128          # the reference kernel's key/query block
_MODES = {"none": 0, "vec": 1, "dense": 2}
_KERNEL_D = (16, 32, 64, 128)

# kernel launches made by flash_attention_fwd (launches) and by
# flash_attention_bwd (launches_dq, launches_dkv); plain-version calls and
# CPU calls do not count
launches = 0
launches_dq = 0
launches_dkv = 0


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


def flash_attention_fwd_reference(q3, k3, v3, mask3, scale, mode, causal):
    """Plain PyTorch version of the kernel on ``(BH, T, d)`` operands:
    returns ``(o, lse)``.  Closed form of the reference's online
    recurrence (start ``m = -1e9``; swept padding columns counted into
    the denominator; causal sweep bounded at the diagonal 128-block)."""
    BH, T, d = q3.shape
    S = k3.shape[1]
    dev = q3.device
    qf, kf, vf = q3.float(), k3.float(), v3.float()
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale          # (BH, T, S)
    if mode != "none":
        s = s + mask3
    Sp = -(-S // _REF_BLOCK) * _REF_BLOCK
    cols = torch.arange(S, device=dev)[None]
    if causal:
        rows = torch.arange(T, device=dev)[:, None]
        hi = torch.clamp((rows // _REF_BLOCK + 1) * _REF_BLOCK, max=Sp)
        s = torch.where(cols > rows, torch.full_like(s, _NEG_INF), s)
        s = torch.where(cols < hi, s, torch.full_like(s, -math.inf))
        n_pad = (hi - torch.clamp(hi, max=S)).to(torch.float32)  # (T, 1)
    else:
        n_pad = float(Sp - S)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True) + n_pad * torch.exp(_NEG_INF - m)
    l = torch.clamp(l, min=1e-30)
    o = torch.matmul(p, vf) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0]


def _fn(lib_name, sym, n_ptr):
    """The ctypes function ``sym`` of library ``lib_name``: ``n_ptr``
    pointers, seven ints (BH, T, S, d, mode, mask_bh, causal), the
    scale and the stream."""
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_operands(name, q3, k3, v3, mask3, mode, extra=()):
    """Check the operands a kernel takes (device, shapes, float32,
    contiguous); returns ``(dev, mask_bh)``, ``dev`` None for CPU
    tensors (which take the plain version)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    ops = [q3, k3, v3] + ([mask3] if mode != "none" else []) + list(extra)
    dev = q3.device
    if any(t.device != dev for t in ops):
        raise ValueError(f"{name}: operands on different devices")
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
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous operands")
    return dev, mask_bh


def flash_attention_fwd(q3, k3, v3, mask3, scale, mode, causal):
    """The kernel wrapper on ``(BH, T, d)`` operands: returns
    ``(o, lse)``.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/flash_attention_fwd.cu`` or raise."""
    global launches
    dev, mask_bh = _kernel_operands("flash_attention", q3, k3, v3, mask3,
                                    mode)
    if dev is None:
        return flash_attention_fwd_reference(q3, k3, v3, mask3, scale, mode,
                                             causal)
    BH, T, d = q3.shape
    S = k3.shape[1]
    o = torch.empty_like(q3)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    fn = _fn("flash_attention_fwd", "singa_flash_attention_fwd", 6)
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None,
             o.data_ptr(), lse.data_ptr(), BH, T, S, d, _MODES[mode],
             mask_bh, int(bool(causal)), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return o, lse


def _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode, causal):
    """``(p, ds)`` of the reference kernels on ``(BH, T, S)``:
    ``p = exp(s - lse)`` on every pair of the reference's sweep (all
    columns, or with ``causal`` those up to the row's diagonal
    128-block), 0 elsewhere; ``ds = p (dp - delta)``."""
    T, S = q3.shape[1], k3.shape[1]
    dev = q3.device
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if mode != "none":
        s = s + mask3
    if causal:
        rows = torch.arange(T, device=dev)[:, None]
        cols = torch.arange(S, device=dev)[None]
        s = torch.where(cols > rows, torch.full_like(s, _NEG_INF), s)
    p = torch.exp(s - lse[..., None])
    if causal:
        swept = cols // _REF_BLOCK <= rows // _REF_BLOCK
        p = torch.where(swept, p, torch.zeros_like(p))
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta, do3,
                                     scale, mode, causal):
    """Plain PyTorch version of the dq kernel (the reference's
    ``_dq_kernel``): ``dq = scale * ds @ k``."""
    _, ds = _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                       causal)
    return (torch.matmul(ds, k3.float()) * scale).to(q3.dtype)


def flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse, delta, do3,
                                      scale, mode, causal):
    """Plain PyTorch version of the dk/dv kernel (the reference's
    ``_dkv_kernel``): ``dk = scale * ds^T @ q``, ``dv = p^T @ dO``."""
    p, ds = _bwd_probs(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                       causal)
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), do3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_reference(q3, k3, v3, mask3, o3, lse, do3, scale,
                                  mode, causal):
    """Plain PyTorch version of :func:`flash_attention_bwd`, written from
    the reference kernels' formulas, not from autograd."""
    delta = (do3.float() * o3.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta, do3,
                                          scale, mode, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse, delta,
                                               do3, scale, mode, causal)
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
    global launches_dq
    dev, mask_bh = _bwd_operands("flash_attention_bwd", q3, k3, v3, mask3,
                                 lse, delta, do3, mode)
    if dev is None:
        return flash_attention_bwd_dq_reference(q3, k3, v3, mask3, lse, delta,
                                                do3, scale, mode, causal)
    BH, T, d = q3.shape
    dq = torch.empty_like(q3)
    fn = _fn("flash_attention_bwd", "singa_flash_attention_bwd_dq", 8)
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None, do3.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T,
             k3.shape[1], d, _MODES[mode], mask_bh, int(bool(causal)),
             float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dq kernel launch failed "
                           f"(cudaError {err})")
    launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, mask3, lse, delta, do3, scale, mode,
                            causal):
    """The dk/dv kernel's wrapper (``csrc/flash_attention_bwd.cu``):
    returns ``(dk, dv)``.  CPU tensors run the plain version; CUDA
    tensors launch or raise."""
    global launches_dkv
    dev, mask_bh = _bwd_operands("flash_attention_bwd", q3, k3, v3, mask3,
                                 lse, delta, do3, mode)
    if dev is None:
        return flash_attention_bwd_dkv_reference(q3, k3, v3, mask3, lse,
                                                 delta, do3, scale, mode,
                                                 causal)
    BH, T, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    fn = _fn("flash_attention_bwd", "singa_flash_attention_bwd_dkv", 9)
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             mask3.data_ptr() if mode != "none" else None, do3.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             BH, T, k3.shape[1], d, _MODES[mode], mask_bh,
             int(bool(causal)), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dk/dv kernel launch failed "
                           f"(cudaError {err})")
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q3, k3, v3, mask3, o3, lse, do3, scale, mode,
                        causal):
    """Flash-attention backward on ``(BH, T, d)`` operands (``o3`` and
    ``lse`` from :func:`flash_attention_fwd`, ``do3`` the output's
    cotangent): returns ``(dq, dk, dv)``.  ``delta = rowsum(dO * O)`` is
    one PyTorch op, as in the reference; then the dq and the dk/dv
    kernels run (their plain versions for CPU tensors)."""
    if o3.shape != q3.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o3.shape)} does "
                         f"not match q {tuple(q3.shape)}")
    delta = (do3 * o3).sum(dim=-1)
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
    docstring for the mask contract).  Returns ``(B, H, T, d)``.
    Differentiable in q, k and v; called without grad (or on inputs that
    need none) it runs the forward kernel alone and saves nothing."""
    B, H, T, d = q.shape
    q3, k3, v3, m3, scale, mode = _prepare(q, k, v, mask, sm_scale)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttentionFunction.apply(q3, k3, v3, m3, scale, mode,
                                         bool(causal))
    else:
        o, _ = flash_attention_fwd(q3, k3, v3, m3, scale, mode, causal)
    return o.reshape(B, H, T, d)


def flash_attention_reference(q, k, v, mask=None, sm_scale=None,
                              causal=False):
    """Plain PyTorch version of :func:`flash_attention`'s forward, on any
    device."""
    B, H, T, d = q.shape
    q3, k3, v3, m3, scale, mode = _prepare(q, k, v, mask, sm_scale)
    o, _ = flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode, causal)
    return o.reshape(B, H, T, d)
