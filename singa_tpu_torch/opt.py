"""Optimizers of the port.  Counterpart: ``singa_tpu/opt.py``.

``Optimizer`` (:67): a step counter (``opt_step``), named per-parameter
state (``m:<param>``, ``v:<param>``, ``mom:<param>``, where ``<param>``
is the parameter's dotted name from ``Model.compile``),
``get_states`` / ``set_states`` by those names (state restored before
it exists is applied when it is created), and ``__call__(loss)``, which
runs backward, applies the update to every parameter and steps the
counter.  ``SGD`` (:303), ``Adam`` (:357, bias correction with
``t = step + 1``), ``AdamW`` (:383, decoupled decay), and the schedules
``Constant``, ``ExponentialDecay`` (:51) and ``WarmupCosine`` (:401),
evaluated on the step counter.

The reference keeps the counter as a traced device scalar so its
schedules advance inside a compiled step; the port runs eagerly and
keeps it as a host integer, and evaluates the schedules and the bias
corrections in float32 as the reference does.  Updates happen in place,
under ``torch.no_grad()``, on the parameter's own ``torch`` leaf and on
its state tensors.  ``RMSProp``, ``AdaGrad`` and ``DistOpt`` belong to
later slices (``ROADMAP.md`` queue 1, items 4 and 12).
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .tensor import Tensor

__all__ = ["DecayScheduler", "Constant", "ExponentialDecay", "WarmupCosine",
           "Optimizer", "SGD", "Adam", "AdamW"]

_f32 = np.float32


class DecayScheduler:
    """Maps the step counter to a learning rate (a float32 value)."""

    def __init__(self, init_value: float):
        self.init_value = float(init_value)

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step):
        return _f32(self.init_value)


class ExponentialDecay(DecayScheduler):
    """lr = init * rate^(step/decay_steps)  (staircase optional)."""

    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step):
        p = _f32(step) / _f32(self.decay_steps)
        if self.staircase:
            p = np.floor(p)
        return _f32(self.init_value) * np.power(_f32(self.decay_rate), p)


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
        s = _f32(step)
        if s < self.warmup_steps:
            return _f32(self.init_value) * s / _f32(self.warmup_steps)
        frac = np.clip((s - _f32(self.warmup_steps))
                       / _f32(self.total_steps - self.warmup_steps),
                       _f32(0.0), _f32(1.0))
        return (_f32(self.final_value) + _f32(0.5) * _f32(
            self.init_value - self.final_value)
            * (_f32(1.0) + np.cos(_f32(np.pi) * frac)))


class Optimizer:
    """Base optimizer (reference: ``opt.Optimizer``).  Updates every
    parameter in place under ``torch.no_grad()``."""

    def __init__(self, lr):
        if not isinstance(lr, DecayScheduler):
            lr = Constant(lr)
        self.lr = lr
        self.step_counter = 0            # ``opt_step`` in the states
        self._states: dict[int, dict[str, Tensor]] = {}
        self._used_state_names: set[str] = set()
        # restored entries whose (lazily created) state does not exist
        # yet: applied by _state_for when it is created
        self._pending_states: dict[str, object] = {}

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

    def state_tensors(self):
        out = []
        for st in self._states.values():
            out.extend(st.values())
        return out

    def get_states(self) -> dict:
        states = {"opt_step": np.asarray(self.step_counter, np.int32)}
        states.update({t.name: t.numpy() for t in self.state_tensors()})
        for name, arr in self._pending_states.items():
            states.setdefault(name, np.asarray(arr))
        return states

    def set_states(self, states: dict):
        """Restore by name: the step counter, existing state tensors, and
        (buffered until created) state that does not exist yet."""
        by_name = {t.name: t for t in self.state_tensors()}
        for name, arr in states.items():
            if name == "opt_step":
                self.step_counter = int(np.asarray(arr))
            elif name in by_name:
                by_name[name].copy_from_numpy(arr)
            else:
                self._pending_states[name] = np.asarray(arr)

    # -- API --------------------------------------------------------------
    def apply(self, param: Tensor, grad: Tensor) -> None:
        """Update ``param`` in place from ``grad`` (under
        ``torch.no_grad()``)."""
        with torch.no_grad():
            self._apply(param, grad.data)

    def _apply(self, param: Tensor, g: torch.Tensor) -> None:
        raise NotImplementedError

    def step(self):
        """Advance the step counter (once per iteration)."""
        self.step_counter += 1

    def __call__(self, loss: Tensor):
        """Backprop + update every param (reference: ``opt(loss)``)."""
        for p, g in autograd.backward(loss):
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
        lr = float(self.lr(self.step_counter))
        p = param.data
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum:
            buf = self._state_for(param, ("mom",))["mom"].data
            buf.mul_(self.momentum).add_((1 - self.dampening) * g)
            g = g + self.momentum * buf if self.nesterov else buf
        p.sub_(lr * g)


class Adam(Optimizer):
    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _apply(self, param, g):
        if self.weight_decay:
            g = g + self.weight_decay * param.data
        self._adam_update(param, g)

    def _adam_update(self, param, g):
        """The moments and the bias-corrected step, on ``g`` as given."""
        lr = float(self.lr(self.step_counter))
        t = _f32(self.step_counter) + _f32(1.0)
        bc1 = float(_f32(1.0) - np.power(_f32(self.beta_1), t))
        bc2 = float(_f32(1.0) - np.power(_f32(self.beta_2), t))
        st = self._state_for(param, ("m", "v"))
        m, v = st["m"].data, st["v"].data
        m.mul_(self.beta_1).add_((1 - self.beta_1) * g)
        v.mul_(self.beta_2).add_((1 - self.beta_2) * (g * g))
        param.data.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay: the decay scales the param by
    ``1 - lr * wd`` before the Adam update and stays out of the
    moments."""

    def _apply(self, param, g):
        if self.weight_decay:
            lr = _f32(self.lr(self.step_counter))
            param.data.mul_(float(_f32(1.0) - lr * _f32(self.weight_decay)))
        self._adam_update(param, g)
