"""Optimizers of the port.  Counterpart: ``singa_tpu/opt.py``.

``Optimizer`` (:67): a step counter (``opt_step``), named per-parameter
state (``m:<param>``, ``v:<param>``, ``mom:<param>``, ``sq:<param>``,
where ``<param>`` is the parameter's dotted name from ``Model.compile``),
``get_states`` / ``set_states`` by those names (state restored before
it exists is applied when it is created), ``track_grad_norm`` (:140),
and ``__call__(loss)``, which runs backward, applies the update to every
parameter and steps the counter.  ``SGD`` (:303), ``RMSProp`` (:328),
``AdaGrad`` (:343), ``Adam`` (:357, bias correction with
``t = step + 1``), ``AdamW`` (:383, decoupled decay), and the schedules
``Constant``, ``ExponentialDecay`` (:51) and ``WarmupCosine`` (:401).

As in the reference, the counter is a device int32 scalar (a
:class:`Tensor` named ``opt_step``) and the schedules and Adam's bias
corrections are float32 torch ops on it, so a step captured in a CUDA
graph (``Model.compile(use_graph=True)``) advances them at every replay.
Every state update happens in place, under ``torch.no_grad()``: the
parameter's own ``torch`` leaf, its state tensors, the counter and the
norm keep their storage from step to step, which a replayed graph needs.
The counter and the norm start on the host and move to the parameters'
device at their first use.  The learning rate and the bias corrections
are computed once a round (``_backward`` .. ``step``) and shared by
every parameter's update.

Mixed precision (:mod:`singa_tpu_torch.precision`, reference opt.py:210-299):
``attach_precision_policy`` installs a ``Policy``.  ``apply`` then puts
the parameter's float32 master leaf back (stashed by
``Policy.begin_step``), casts the gradient to float32, and under a loss
scale unscales it and, when any gradient of the round is non-finite
(``_backward``'s one verdict for the whole round, recorded into the
scale once), makes the update an exact no-op: a zero gradient is fed,
then the parameter and its existing state are restored by
``torch.where`` on the device, so the scale adds no host sync to a
step.  ``apply`` alone under a loss scale raises: the verdict comes
from ``_backward``.  ``step`` advances the scale's schedule, and its
three scalars are optimizer states (``loss_scale``,
``loss_scale_good_steps``, ``loss_scale_found_inf``).  ``DistOpt``
belongs to a later slice (``ROADMAP.md`` queue 1, item 12).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import autograd
from .tensor import Tensor

__all__ = ["DecayScheduler", "Constant", "ExponentialDecay", "WarmupCosine",
           "Optimizer", "SGD", "RMSProp", "AdaGrad", "Adam", "AdamW"]


def _step_tensor(step) -> torch.Tensor:
    """The step counter as a tensor (a host int becomes an int32 CPU
    scalar)."""
    if isinstance(step, Tensor):
        return step.data
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(int(step), dtype=torch.int32)


class DecayScheduler:
    """Maps the step counter (a device int32 scalar, or a host int) to a
    learning rate: a float32 scalar on the counter's device."""

    def __init__(self, init_value: float):
        self.init_value = float(init_value)

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step):
        s = _step_tensor(step)
        return torch.full((), self.init_value, dtype=torch.float32,
                          device=s.device)


class ExponentialDecay(DecayScheduler):
    """lr = init * rate^(step/decay_steps)  (staircase optional)."""

    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step):
        p = _step_tensor(step).to(torch.float32) / self.decay_steps
        if self.staircase:
            p = torch.floor(p)
        return self.init_value * torch.pow(self.decay_rate, p)


class WarmupCosine(DecayScheduler):
    """Linear warmup to ``init_value`` over ``warmup_steps``, then cosine
    decay to ``final_value`` at ``total_steps``."""

    def __init__(self, init_value, warmup_steps, total_steps,
                 final_value=0.0):
        super().__init__(init_value)
        self.warmup_steps = max(1, int(warmup_steps))
        self.total_steps = max(self.warmup_steps + 1, int(total_steps))
        self.final_value = float(final_value)

    def __call__(self, step):
        s = _step_tensor(step).to(torch.float32)
        warm = self.init_value * s / self.warmup_steps
        frac = torch.clamp((s - self.warmup_steps)
                           / (self.total_steps - self.warmup_steps), 0.0, 1.0)
        cos = (self.final_value + 0.5 * (self.init_value - self.final_value)
               * (1.0 + torch.cos(math.pi * frac)))
        return torch.where(s < self.warmup_steps, warm, cos)


class Optimizer:
    """Base optimizer (reference: ``opt.Optimizer``).  Updates every
    parameter in place under ``torch.no_grad()``."""

    def __init__(self, lr):
        if not isinstance(lr, DecayScheduler):
            lr = Constant(lr)
        self.lr = lr
        self.step_counter = Tensor(data=torch.zeros((), dtype=torch.int32),
                                   requires_grad=False, name="opt_step")
        self._states: dict[int, dict[str, Tensor]] = {}
        self._used_state_names: set[str] = set()
        # restored entries whose (lazily created) state does not exist
        # yet: applied by _state_for when it is created
        self._pending_states: dict[str, object] = {}
        # mixed precision: Policy.begin_step stashes the float32 master
        # leaves here by param id; apply() puts each back before its
        # update
        self._masters: dict[int, torch.Tensor] = {}
        self._precision_policy = None
        self._round_finite = None  # the round's overflow verdict (device)
        self._grad_norm_sq: Tensor | None = None   # track_grad_norm
        self._scalars = None       # the round's lr (and bias corrections)

    # -- state management ------------------------------------------------
    def _state_name(self, kind: str, param: Tensor) -> str:
        """``<kind>:<param name>``; an ordinal suffix only on collision
        (params named outside a compiled Model)."""
        base = f"{kind}:{param.name or 'param'}"
        name = base
        ordinal = len(self._states)
        while name in self._used_state_names:
            name = f"{base}#{ordinal}"
            ordinal += 1
        self._used_state_names.add(name)
        return name

    def _state_for(self, param: Tensor, kinds) -> dict:
        """The param's state tensors (zeros like the param) by kind,
        created on first use."""
        key = id(param)
        if key not in self._states:
            group = {}
            for kind in kinds:
                t = Tensor(data=torch.zeros_like(param.data),
                           requires_grad=False, device=param.device,
                           name=self._state_name(kind, param))
                if t.name in self._pending_states:
                    t.copy_from_numpy(self._pending_states.pop(t.name))
                group[kind] = t
            self._states[key] = group
        return self._states[key]

    def _place(self, device) -> None:
        """Move the counter and the norm to ``device`` (a no-op where
        they are)."""
        self.step_counter.to_device(device)
        if self._grad_norm_sq is not None:
            self._grad_norm_sq.to_device(device)

    def track_grad_norm(self, enable: bool = True) -> None:
        """Opt in to the squared global gradient norm as a float32 state
        scalar (``grad_norm_sq``): ``_backward`` zeroes it and every
        :meth:`apply` adds ``sum(g * g)`` of the (unscaled, float32)
        gradient it consumes, so after a step it holds that step's
        ``||g||^2``; reading it is the caller's host sync, after the
        step.  Enable it before a captured step's first call: the
        tensor must be in the state when the step is captured."""
        if enable and self._grad_norm_sq is None:
            self._grad_norm_sq = Tensor(
                data=torch.zeros((), dtype=torch.float32),
                requires_grad=False, name="grad_norm_sq")
        elif not enable:
            self._grad_norm_sq = None

    def _track_grad(self, g: torch.Tensor) -> None:
        if self._grad_norm_sq is not None:
            g32 = g.to(torch.float32)
            self._grad_norm_sq.data.add_(torch.sum(g32 * g32))

    def state_tensors(self):
        out = [self.step_counter]
        if self._grad_norm_sq is not None:
            out.append(self._grad_norm_sq)
        if self._precision_policy is not None:
            out.extend(self._precision_policy.state_tensors())
        for st in self._states.values():
            out.extend(st.values())
        return out

    def get_states(self) -> dict:
        states = {t.name: t.numpy() for t in self.state_tensors()}
        for name, arr in self._pending_states.items():
            states.setdefault(name, np.asarray(arr))
        return states

    def set_states(self, states: dict):
        """Restore by name, in place, from numpy arrays, torch tensors or
        Tensors: the step counter, existing state tensors, and (buffered
        until created) state that does not exist yet."""
        by_name = {t.name: t for t in self.state_tensors()}
        for name, arr in states.items():
            if isinstance(arr, Tensor):
                arr = arr.data
            if name not in by_name:
                self._pending_states[name] = (
                    arr.detach().cpu().numpy()
                    if isinstance(arr, torch.Tensor) else np.asarray(arr))
            elif isinstance(arr, torch.Tensor):
                t = by_name[name]
                with torch.no_grad():
                    t.data.copy_(arr.reshape(t.shape))
            else:
                by_name[name].copy_from_numpy(arr)
        self._scalars = None

    # -- mixed precision ---------------------------------------------------
    def attach_precision_policy(self, policy):
        """Install a :class:`~singa_tpu_torch.precision.Policy` (see the
        module docstring)."""
        self._precision_policy = policy

    def _backward(self, loss: Tensor):
        """``autograd.backward`` with the policy's loss-scaled initial
        cotangent, and the round's global finite verdict: any non-finite
        gradient skips every update of the round (a per-param guard would
        not be a no-op: a NaN upstream can give a parameter below a zero
        gradient whose momentum update would still apply)."""
        self._place(loss.device)
        self._scalars = None
        if self._grad_norm_sq is not None:   # a fresh sum each step
            self._grad_norm_sq.data.zero_()
        pol = self._precision_policy
        self._round_finite = None
        if pol is None or pol.loss_scale is None:
            return autograd.backward(loss)
        ls = pol.loss_scale.to_device(loss.device)
        dy = ls.scale.data.to(loss.dtype).expand(loss.shape)
        pairs = list(autograd.backward(loss, dy))
        fin = torch.ones((), dtype=torch.bool, device=loss.data.device)
        for _, g in pairs:
            fin = fin & torch.isfinite(g.data).all()
        self._round_finite = fin
        ls.record(~fin)
        return pairs

    # -- API --------------------------------------------------------------
    def apply(self, param: Tensor, grad: Tensor) -> None:
        """Update ``param`` in place from ``grad`` (under
        ``torch.no_grad()``); policy-aware (see the module docstring)."""
        with torch.no_grad():
            pol = self._precision_policy
            if pol is None or not pol.active:
                self._track_grad(grad.data)
                return self._apply(param, grad.data)
            ls, finite = pol.loss_scale, self._round_finite
            if ls is not None and finite is None:
                raise RuntimeError(
                    "a loss-scaled update needs the round's overflow verdict: "
                    "call the optimizer on the loss (opt(loss)), which runs "
                    "the scaled backward, not apply() alone")
            master = self._masters.pop(id(param), None)
            if master is not None:
                param.data = master     # the same float32 leaf as before
            g = grad.data
            if g.dtype != param.data.dtype:
                g = g.to(param.data.dtype)
            if ls is None:
                self._track_grad(g)
                return self._apply(param, g)
            g = g * (1.0 / ls.scale.data)
            self._track_grad(g)   # unscaled; a non-finite round shows here
            # an exact no-op on overflow: a zero gradient keeps fresh state
            # finite, then the param and its existing state come back
            g = torch.where(finite, g, torch.zeros_like(g))
            p = param.data
            old_p = p.clone()
            old_st = [(t.data, t.data.clone())
                      for t in self._states.get(id(param), {}).values()]
            self._apply(param, g)
            p.copy_(torch.where(finite, p, old_p))
            for cur, old in old_st:
                cur.copy_(torch.where(finite, cur, old))

    def _apply(self, param: Tensor, g: torch.Tensor) -> None:
        raise NotImplementedError

    def _round_scalars(self) -> dict:
        """The round's schedule values on the counter's device, computed
        at the first update of the round."""
        if self._scalars is None:
            self._scalars = self._scalars_at(self.step_counter.data)
        return self._scalars

    def _scalars_at(self, step: torch.Tensor) -> dict:
        return {"lr": self.lr(step)}

    def step(self):
        """Advance the step counter in place (once per iteration) and the
        loss scale's schedule."""
        self._round_finite = None  # the round is over
        self._scalars = None
        self.step_counter.data.add_(1)
        pol = self._precision_policy
        if pol is not None and pol.loss_scale is not None:
            pol.loss_scale.update()

    def __call__(self, loss: Tensor):
        """Backprop + update every param (reference: ``opt(loss)``)."""
        for p, g in self._backward(loss):
            self.apply(p, g)
        self.step()


class SGD(Optimizer):
    """SGD with momentum / nesterov / weight decay / dampening
    (reference: ``opt.SGD``)."""

    def __init__(self, lr=0.1, momentum=0.0, weight_decay=0.0,
                 dampening=0.0, nesterov=False):
        super().__init__(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.dampening = dampening
        self.nesterov = nesterov

    def _apply(self, param, g):
        lr = self._round_scalars()["lr"]
        p = param.data
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum:
            buf = self._state_for(param, ("mom",))["mom"].data
            buf.mul_(self.momentum).add_((1 - self.dampening) * g)
            g = g + self.momentum * buf if self.nesterov else buf
        p.sub_(lr * g)


class RMSProp(Optimizer):
    """``sq = rho sq + (1 - rho) g^2``; ``p -= lr g / (sqrt(sq) + eps)``
    (reference: ``opt.RMSProp``)."""

    def __init__(self, lr=0.01, rho=0.9, epsilon=1e-8):
        super().__init__(lr)
        self.rho = rho
        self.epsilon = epsilon

    def _apply(self, param, g):
        lr = self._round_scalars()["lr"]
        sq = self._state_for(param, ("sq",))["sq"].data
        sq.mul_(self.rho).add_((1 - self.rho) * (g * g))
        param.data.sub_(lr * g / (torch.sqrt(sq) + self.epsilon))


class AdaGrad(Optimizer):
    """``sq += g^2``; ``p -= lr g / (sqrt(sq) + eps)`` (reference:
    ``opt.AdaGrad``)."""

    def __init__(self, lr=0.01, epsilon=1e-8):
        super().__init__(lr)
        self.epsilon = epsilon

    def _apply(self, param, g):
        lr = self._round_scalars()["lr"]
        sq = self._state_for(param, ("sq",))["sq"].data
        sq.add_(g * g)
        param.data.sub_(lr * g / (torch.sqrt(sq) + self.epsilon))


class Adam(Optimizer):
    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _scalars_at(self, step):
        t = step.to(torch.float32) + 1.0
        return {"lr": self.lr(step),
                "bc1": 1.0 - torch.pow(self.beta_1, t),
                "bc2": 1.0 - torch.pow(self.beta_2, t)}

    def _apply(self, param, g):
        if self.weight_decay:
            g = g + self.weight_decay * param.data
        self._adam_update(param, g)

    def _adam_update(self, param, g):
        """The moments and the bias-corrected step, on ``g`` as given."""
        sc = self._round_scalars()
        st = self._state_for(param, ("m", "v"))
        m, v = st["m"].data, st["v"].data
        m.mul_(self.beta_1).add_((1 - self.beta_1) * g)
        v.mul_(self.beta_2).add_((1 - self.beta_2) * (g * g))
        param.data.sub_(sc["lr"] * (m / sc["bc1"])
                        / (torch.sqrt(v / sc["bc2"]) + self.epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay: the decay scales the param by
    ``1 - lr * wd`` before the Adam update and stays out of the
    moments."""

    def _apply(self, param, g):
        if self.weight_decay:
            lr = self._round_scalars()["lr"]
            param.data.mul_(1.0 - lr * self.weight_decay)
        self._adam_update(param, g)
