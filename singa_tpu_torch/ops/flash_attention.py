"""Flash-attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart: ``singa_tpu/ops/pallas_kernels.py`` — ``flash_attention``
(the entry) and ``_flash_fwd_call`` / ``_fwd_kernel`` (the Pallas TPU
kernel).  The kernel source is ``csrc/flash_attention_fwd.cu``.

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
Both versions here reproduce that.  Forward only: the backward pass
(``_flash_bwd_call``) belongs to the training slice.

Routing: the tensor's device decides.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference"]

_NEG_INF = -1e9
_REF_BLOCK = 128          # the reference kernel's key/query block
_MODES = {"none": 0, "vec": 1, "dense": 2}
_KERNEL_D = (16, 32, 64, 128)

# kernel launches made by flash_attention_fwd (plain-version calls and
# CPU calls do not count)
launches = 0


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


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.singa_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q3, k3, v3, mask3, scale, mode, causal):
    """The kernel wrapper on ``(BH, T, d)`` operands: returns
    ``(o, lse)``.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/flash_attention_fwd.cu`` or raise."""
    global launches
    if mode not in _MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    ops = [q3, k3, v3] + ([mask3] if mode != "none" else [])
    dev = q3.device
    if any(t.device != dev for t in ops):
        raise ValueError("flash_attention: operands on different devices")
    if dev.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, mask3, scale, mode,
                                             causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    BH, T, d = q3.shape
    S = k3.shape[1]
    if k3.shape != (BH, S, d) or v3.shape != (BH, S, d):
        raise ValueError(f"flash_attention: k/v shapes {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)} do not match q {tuple(q3.shape)}")
    if d not in _KERNEL_D:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{_KERNEL_D}, got {d}")
    mask_bh = 0
    if mode != "none":
        want_t = 1 if mode == "vec" else T
        if (mask3.dim() != 3 or mask3.shape[0] not in (1, BH)
                or mask3.shape[1:] != (want_t, S)):
            raise ValueError(f"flash_attention: {mode} mask shape "
                             f"{tuple(mask3.shape)} is not (1|{BH}, "
                             f"{want_t}, {S})")
        mask_bh = int(mask3.shape[0] == BH and BH > 1)
    for t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous "
                             "operands")
    o = torch.empty_like(q3)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    fn = _lib()
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


def flash_attention(q, k, v, mask=None, sm_scale=None, causal=False):
    """Fused attention over ``(B, H, T, d)`` tensors (see the module
    docstring for the mask contract).  Returns ``(B, H, T, d)``."""
    B, H, T, d = q.shape
    q3, k3, v3, m3, scale, mode = _prepare(q, k, v, mask, sm_scale)
    o, _ = flash_attention_fwd(q3.contiguous(), k3.contiguous(),
                               v3.contiguous(), m3, scale, mode, causal)
    return o.reshape(B, H, T, d)


def flash_attention_reference(q, k, v, mask=None, sm_scale=None,
                              causal=False):
    """Plain PyTorch version of :func:`flash_attention`, on any device."""
    B, H, T, d = q.shape
    q3, k3, v3, m3, scale, mode = _prepare(q, k, v, mask, sm_scale)
    o, _ = flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode, causal)
    return o.reshape(B, H, T, d)
