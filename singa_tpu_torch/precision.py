"""Quantized-serving dtypes and the precision policy of the port.
Counterpart: ``singa_tpu/precision.py`` — its quantization half:
``QUANT_DTYPES``, ``FP8_DTYPES``, ``validate_quant_dtype`` and the
``kv_dtype`` / ``weight_dtype`` / ``scale_dtype`` fields of ``Policy``.

int8 dequantises exactly everywhere (the scale multiply is ordinary
float math).  The reference takes fp8 only on the TPU and rejects it on
every other backend; the port rejects it on both of its backends
(``"cuda"`` and ``"cpu"``): it adds no feature the reference lacks off
the TPU.  Mixed-precision compute (a ``compute_dtype`` other than
float32) belongs to a later slice and raises.
"""

from __future__ import annotations

import torch

__all__ = ["Policy", "validate_quant_dtype", "resolve_dtype", "dtype_name",
           "QUANT_DTYPES", "FP8_DTYPES"]

FP8_DTYPES = ("float8_e4m3fn", "float8_e5m2")
QUANT_DTYPES = ("int8",) + FP8_DTYPES


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy and JAX spell it (``"bfloat16"``)."""
    return str(dtype).rsplit(".", 1)[-1]


def resolve_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from one, or from its name (``"int8"``,
    ``"bfloat16"``, ``"float8_e4m3fn"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def validate_quant_dtype(dtype, kind="kv_dtype", backend=None):
    """Resolve and validate a serving quantization dtype.

    ``int8`` is accepted; the fp8 formats raise ``ValueError`` naming the
    backend (``backend``, or ``"cuda"`` / ``"cpu"`` by what this process
    has).  ``None`` passes through (quantization off for that tensor
    class)."""
    if dtype is None:
        return None
    dt = resolve_dtype(dtype)
    name = dtype_name(dt)
    if name not in QUANT_DTYPES:
        raise ValueError(
            f"{kind}={name!r} is not a supported quantization dtype "
            f"(expected one of {QUANT_DTYPES})")
    if name in FP8_DTYPES:
        backend = backend or ("cuda" if torch.cuda.is_available()
                              else "cpu")
        raise ValueError(
            f"{kind}={name!r} needs native fp8 support, which the "
            f"{backend!r} backend does not provide here — use int8 (fp8 "
            f"serving is TPU-only in the reference)")
    return dt


class Policy:
    """The reference's precision policy, as far as the port takes it:
    float32 compute, plus the quantized-inference fields (serving only)
    — ``kv_dtype`` stores the KV pool, ``weight_dtype`` the decode
    weights, ``scale_dtype`` (bfloat16 or float32) their dequant scales.
    Validated at construction."""

    def __init__(self, compute_dtype=torch.float32, *, kv_dtype=None,
                 weight_dtype=None, scale_dtype=torch.bfloat16,
                 backend=None):
        self.compute_dtype = resolve_dtype(compute_dtype)
        if self.compute_dtype != torch.float32:
            raise NotImplementedError(
                f"compute_dtype={dtype_name(self.compute_dtype)!r} belongs "
                f"to the mixed-precision slice of the port (ROADMAP.md "
                f"queue 1, item 4)")
        self.kv_dtype = validate_quant_dtype(kv_dtype, "kv_dtype", backend)
        self.weight_dtype = validate_quant_dtype(weight_dtype,
                                                 "weight_dtype", backend)
        self.scale_dtype = resolve_dtype(scale_dtype)
        if self.scale_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"scale_dtype={dtype_name(self.scale_dtype)!r} — dequant "
                f"scales must be bfloat16 or float32")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype is not None or self.weight_dtype is not None
