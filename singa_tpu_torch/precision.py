"""Mixed-precision policies and quantized-serving dtypes of the port.
Counterpart: ``singa_tpu/precision.py``.

A :class:`Policy` names three dtypes: ``param_dtype`` (what parameters
and optimizer state are stored in: float32), ``compute_dtype`` (what the
forward and backward run in) and ``output_dtype`` (what a step returns).
The master swap is the contract with :mod:`singa_tpu_torch.opt`:
:meth:`Policy.begin_step` replaces each float32 parameter's ``data`` by
a fresh leaf in the compute dtype and stashes the float32 leaf on the
optimizer; ``Optimizer.apply`` puts that same leaf back before the
update (so momenta stay float32 and a parameter stays one ``torch`` leaf
for its whole life), and :meth:`Policy.end_step` puts back any master
the backward never reached.  The casts are real device copies; in a step
captured as a CUDA graph (``Model.compile(use_graph=True)`` on the card)
the compute-dtype leaves live in the graph's memory pool and every
replay casts into them again, while the masters keep their storage.
Softmax, the loss and the LayerNorm statistics pin float32 whatever the
policy (``autograd.softmax`` / ``softmax_cross_entropy``,
``layer.LayerNorm``).

The float16 policy adds a :class:`DynamicLossScale`: the initial
cotangent is multiplied by the scale, ``Optimizer.apply`` unscales and
skips the whole round's update when any gradient is non-finite, and the
scale backs off or regrows on a good-step counter.  Its three scalars
are state tensors on the device, so the schedule adds no host sync to a
step.  bfloat16 keeps float32's exponent range and needs no scale.

Quantized serving: int8 dequantises exactly everywhere (the scale
multiply is ordinary float math).  The reference takes fp8 only on the
TPU and rejects it on every other backend; the port rejects it on both
of its backends (``"cuda"`` and ``"cpu"``): it adds no feature the
reference lacks off the TPU.
"""

from __future__ import annotations

import torch

from .tensor import Tensor

__all__ = ["Policy", "DynamicLossScale", "get_policy", "with_update_guard",
           "validate_quant_dtype", "resolve_dtype", "dtype_name",
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


class DynamicLossScale:
    """Loss-scale schedule as three device scalars (state tensors, in
    the optimizer's states): the scale backs off by ``backoff_factor``
    (never below 1.0) the step any gradient goes non-finite, and grows by
    ``growth_factor`` after ``growth_interval`` consecutive finite steps
    (``torch.cuda.amp.GradScaler`` semantics).  The scalars start on the
    host; the optimizer moves them to its loss's device
    (:meth:`to_device`) before their first use."""

    def __init__(self, initial: float = 2.0 ** 15, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000):
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.scale = Tensor(data=torch.tensor(float(initial),
                                              dtype=torch.float32),
                            requires_grad=False, name="loss_scale")
        self.good_steps = Tensor(data=torch.zeros((), dtype=torch.int32),
                                 requires_grad=False,
                                 name="loss_scale_good_steps")
        # sticky overflow flag of the round: OR-ed by every apply(),
        # consumed and reset by update() at opt.step()
        self.found_inf = Tensor(data=torch.zeros((), dtype=torch.bool),
                                requires_grad=False,
                                name="loss_scale_found_inf")

    def to_device(self, device):
        """Move the three scalars to ``device`` (a no-op where they are)."""
        for t in self.state_tensors():
            t.to_device(device)
        return self

    def state_tensors(self):
        return [self.scale, self.good_steps, self.found_inf]

    def record(self, nonfinite):
        """OR a device bool into the round's overflow flag, in place."""
        self.found_inf.data.logical_or_(nonfinite)

    def update(self, reducer=None):
        """Advance the schedule once per optimizer step, on the device and
        in place (the three scalars keep their storage, so a captured
        step's next replay reads the new values).  ``reducer`` (a
        mesh-wide vote) belongs to the ``DistOpt`` slice and stays None
        here."""
        if reducer is not None:
            raise NotImplementedError(
                "a mesh-wide overflow vote belongs to the DistOpt slice of "
                "the port (ROADMAP.md queue 1, item 12)")
        inf = self.found_inf.data
        scale, good = self.scale.data, self.good_steps.data
        grown = good + 1 >= self.growth_interval
        new_scale = torch.where(
            inf, torch.clamp_min(scale * self.backoff_factor, 1.0),
            torch.where(grown, scale * self.growth_factor, scale))
        new_good = torch.where(inf | grown, torch.zeros_like(good), good + 1)
        scale.copy_(new_scale)
        good.copy_(new_good)
        inf.zero_()


class Policy:
    """Precision policy threaded through ``Model`` and the optimizer (see
    the module docstring).  ``loss_scale``: None, a float (a static
    scale) or a :class:`DynamicLossScale`.  The quantized-inference
    fields (serving only; training never reads them): ``kv_dtype``
    stores the KV pool, ``weight_dtype`` the decode weights,
    ``scale_dtype`` (bfloat16 or float32) their dequant scales.
    Validated at construction."""

    def __init__(self, compute_dtype=torch.float32,
                 param_dtype=torch.float32, output_dtype=torch.float32,
                 loss_scale=None, kv_dtype=None, weight_dtype=None,
                 scale_dtype=torch.bfloat16, backend=None):
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.param_dtype = resolve_dtype(param_dtype)
        self.output_dtype = resolve_dtype(output_dtype)
        self.kv_dtype = validate_quant_dtype(kv_dtype, "kv_dtype", backend)
        self.weight_dtype = validate_quant_dtype(weight_dtype,
                                                 "weight_dtype", backend)
        self.scale_dtype = resolve_dtype(scale_dtype)
        if self.scale_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"scale_dtype={dtype_name(self.scale_dtype)!r} — dequant "
                f"scales must be bfloat16 or float32")
        if isinstance(loss_scale, (int, float)):
            ls = DynamicLossScale(initial=float(loss_scale),
                                  growth_interval=2 ** 31 - 1)
            ls.backoff_factor = 1.0  # static: never moves
            loss_scale = ls
        self.loss_scale = loss_scale

    # -- identity ---------------------------------------------------------
    @property
    def mixed(self) -> bool:
        return self.compute_dtype != self.param_dtype

    @property
    def quantized(self) -> bool:
        return self.kv_dtype is not None or self.weight_dtype is not None

    @property
    def active(self) -> bool:
        return self.mixed or self.quantized or self.loss_scale is not None

    @property
    def name(self) -> str:
        return dtype_name(self.compute_dtype)

    def __repr__(self):
        quant = ""
        if self.quantized:
            kv, w = (dtype_name(d) if d is not None else None
                     for d in (self.kv_dtype, self.weight_dtype))
            quant = (f", kv={kv}, weight={w}, "
                     f"scale={dtype_name(self.scale_dtype)}")
        return (f"Policy(compute={dtype_name(self.compute_dtype)}, "
                f"param={dtype_name(self.param_dtype)}, "
                f"output={dtype_name(self.output_dtype)}, "
                f"loss_scale={'dynamic' if self.loss_scale else None}"
                f"{quant})")

    def state_tensors(self):
        return self.loss_scale.state_tensors() if self.loss_scale else []

    # -- casts ------------------------------------------------------------
    def cast_input(self, a):
        """A batch tensor -> compute dtype iff it is a param-precision
        float (labels and integer ids pass through untouched)."""
        if self.mixed and getattr(a, "dtype", None) == self.param_dtype:
            return a.to(self.compute_dtype)
        return a

    def cast_output(self, a):
        """A step output -> output dtype iff it came out in compute
        dtype."""
        if self.mixed and getattr(a, "dtype", None) == self.compute_dtype:
            return a.to(self.output_dtype)
        return a

    # -- the master swap --------------------------------------------------
    def begin_step(self, registry, optimizer=None):
        """Give every param-precision parameter in ``registry`` a fresh
        leaf in ``compute_dtype`` (a device cast that requires grad) and
        stash its float32 leaf on the optimizer; returns a token for
        :meth:`end_step`."""
        if not self.mixed:
            return None
        masters, owners = {}, {}
        for t in registry:
            if (getattr(t, "stores_grad", False)
                    and getattr(t.data, "dtype", None) == self.param_dtype):
                masters[id(t)] = t.data
                owners[id(t)] = t
                t.data = t.data.detach().to(
                    self.compute_dtype).requires_grad_(True)
        if optimizer is not None:
            optimizer._masters = masters
        return (owners, masters)

    def end_step(self, token, optimizer=None):
        """Put back every master the optimizer did not consume (frozen or
        unused params), so every parameter is its float32 leaf again."""
        if token is None:
            return
        owners, masters = token
        for pid in list(masters):
            owners[pid].data = masters.pop(pid)


def with_update_guard(policy=None) -> Policy:
    """The given policy (or float32) with an exact no-op static unit loss
    scale added if it has none: a scale of 1.0 is the identity, the
    schedule never moves (backoff 1.0, a 2^31-1 growth interval), and
    the optimizer's overflow guard then turns every step with a
    non-finite gradient into an exact no-op on the device.  A policy that
    already carries a loss scale is returned unchanged."""
    pol = get_policy(policy) or Policy(torch.float32)
    if pol.loss_scale is not None:
        return pol
    return Policy(pol.compute_dtype, pol.param_dtype, pol.output_dtype,
                  loss_scale=1.0)


_NAMED = ("float32", "bfloat16", "float16")


def get_policy(policy):
    """Coerce a policy spec to a Policy (or None): None, a Policy, or a
    name — ``"bfloat16"`` (mixed, no scale), ``"float16"`` (mixed and a
    dynamic loss scale), ``"float32"`` (inert)."""
    if policy is None or isinstance(policy, Policy):
        return policy
    if policy == "float32":
        return Policy(torch.float32)
    if policy == "bfloat16":
        return Policy(torch.bfloat16)
    if policy == "float16":
        return Policy(torch.float16, loss_scale=DynamicLossScale())
    raise ValueError(
        f"unknown precision policy {policy!r} (expected one of {_NAMED} "
        "or a precision.Policy)")
