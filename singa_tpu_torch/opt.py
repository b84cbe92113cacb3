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
``loss_scale_good_steps``, ``loss_scale_found_inf``).

``DistOpt`` (reference opt.py:425-1004) wraps an optimizer for data
parallelism over a :class:`~singa_tpu_torch.parallel.Communicator`: one
process a rank, each holding a full replica of the model (see
:class:`DistOpt`).  It installs ``_overflow_reducer``: under a loss
scale the round's overflow verdict is all-reduced in ``_backward``
before any update, so every rank skips the round when any rank
overflowed and the scale's ``found_inf`` already holds the group's
verdict at ``step`` (the reference votes again in
``DynamicLossScale.update``; here that would change nothing).  The vote
is a device tensor and adds no host sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _graphs, autograd
from .tensor import Tensor

__all__ = ["DecayScheduler", "Constant", "ExponentialDecay", "WarmupCosine",
           "Optimizer", "SGD", "RMSProp", "AdaGrad", "Adam", "AdamW",
           "DistOpt"]


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
        self._overflow_reducer = None  # DistOpt: the group's overflow vote
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
        until created) state that does not exist yet.  A ZeRO-1
        checkpoint (``__zero1_layout__``) raises: only ``DistOpt`` reads
        its sharded state."""
        if "__zero1_layout__" in states:
            raise ValueError(
                "this checkpoint contains ZeRO-1 sharded optimizer state; "
                "restore it through opt.DistOpt (backward_and_sharded_"
                "update), not a plain optimizer")
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

    def _backward(self, loss: Tensor, ordered: bool = False):
        """``autograd.backward`` with the policy's loss-scaled initial
        cotangent, and the round's global finite verdict: any non-finite
        gradient skips every update of the round (a per-param guard would
        not be a no-op: a NaN upstream can give a parameter below a zero
        gradient whose momentum update would still apply).  ``ordered``:
        the pairs in the reference's emission order (``DistOpt``)."""
        self._place(loss.device)
        self._scalars = None
        if self._grad_norm_sq is not None:   # a fresh sum each step
            self._grad_norm_sq.data.zero_()
        pol = self._precision_policy
        self._round_finite = None
        if pol is None or pol.loss_scale is None:
            return autograd.backward(loss, ordered=ordered)
        ls = pol.loss_scale.to_device(loss.device)
        dy = ls.scale.data.to(loss.dtype).expand(loss.shape)
        pairs = list(autograd.backward(loss, dy, ordered=ordered))
        fin = torch.ones((), dtype=torch.bool, device=loss.data.device)
        for _, g in pairs:
            fin = fin & torch.isfinite(g.data).all()
        if self._overflow_reducer is not None:   # any rank's overflow
            fin = self._overflow_reducer((~fin).to(torch.float32)) == 0
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
        loss scale's schedule (its ``found_inf`` is ``_backward``'s
        verdict, the group's under ``DistOpt``)."""
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


def _host_array(arr) -> np.ndarray:
    """A checkpoint entry (numpy array, torch tensor or Tensor) as a
    numpy array."""
    if isinstance(arr, Tensor):
        arr = arr.data
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class DistOpt:
    """Data-parallel wrapper (reference: ``opt.DistOpt``, opt.py:425, over
    the NCCL ``Communicator``), one process a rank: every rank runs the
    whole step on its rows of the batch (``Model.compile(communicator=)``
    takes them), and the variants below exchange the gradients through
    the communicator's collectives, NCCL on the card and gloo on the
    CPU.

    ==========================  ==============================================
    method                      exchange
    ==========================  ==============================================
    ``backward_and_update``     grads under ``threshold`` elements in one flat
    (and ``__call__``)          all-reduce (``fusedSynch``), larger grads one
                                all-reduce each (``synch``); the mean
    ``backward_and_update_half``
                                one flat **bf16** all-reduce, as the
                                reference (not fp16)
    ``backward_and_partial_update``
                                every grad all-reduced, ``torch.where`` keeps
                                the rotating subset's means (the device int
                                ``partial_idx``, advanced in place); the rest
                                update from local grads
    ``backward_and_sparse_update``
                                top-K (ties to the lower index, as
                                ``lax.top_k``) or ``|g| >= spars`` with error
                                residuals (``resid:<param>``); ``dense``: a
                                masked all-reduce; ``indices``: all-gathered
                                int32 indices and values, summed in a fixed
                                order (``index_put_`` accumulate)
    ``backward_and_sharded_update``
                                ZeRO-1: grads reduce-scatter, each rank
                                updates its ``chunk`` of the flat (padded)
                                group with its own optimizer state, params
                                all-gather; world 1 takes the plain path
    ``backward_and_accumulate`` /
    ``backward_and_accum_update``
                                gradient accumulation into ``gaccum:<param>``;
                                the boundary step exchanges as the plain one
    ==========================  ==============================================

    Parameters and every buffer are updated in place (``copy_``), never
    rebound (the reference rebinds ``p.data``, opt.py:900-904), so a
    captured step's replay sees them.  State that differs between ranks
    stays each rank's own, as the reference's per-device shards: the
    unsynced parameters of ``partial``, the sparse residuals, and the
    ZeRO-1 optimizer state, of which each rank holds its ``chunk``
    (``<kind>:<group>@zshard``; ``<group>`` is the parameter's name, or
    ``zero_bucket`` for the small grads).  ``get_states`` all-gathers
    that state to the reference's global padded layout, stamped
    ``__zero1_layout__ = [world_size, threshold]``, so a zip checkpoint
    crosses to the JAX package by name; it is a collective there, so
    every rank calls it.  ``set_states`` slices it back to the rank's
    chunk, re-lays out a checkpoint of another world size into a fresh
    optimizer (the flat content differs only in padding), and refuses
    (``ValueError``) a restore across world sizes once the shard views
    exist, one into a world-1 optimizer, and a step whose ``threshold``
    differs from the checkpoint's.

    ``comm_stats()`` counts the all-reduces offered (the overflow votes
    included) and their bytes, per step: a captured step's replay
    credits what its capture recorded."""

    def __init__(self, opt: Optimizer, communicator=None, nccl_id=None,
                 local_rank=None, world_size=None, buffSize=4194304):
        self.opt = opt
        if communicator is None:
            from .parallel.communicator import Communicator
            communicator = Communicator.default()
        self.communicator = communicator
        self.buff_size = buffSize      # a parity knob, as in the reference
        self.world_size = world_size or communicator.data_parallel_size
        self.global_rank = communicator.global_rank
        self.local_rank = (local_rank if local_rank is not None
                           else communicator.local_rank)
        self.counters = {"allreduce_calls": 0, "allreduce_bytes": 0}
        _graphs.register_counters(self)
        self.partial_index = Tensor(data=torch.zeros((), dtype=torch.int32),
                                    requires_grad=False, name="partial_idx")
        self._residuals: dict[int, Tensor] = {}
        self._shard_views: dict = {}
        self._zero_threshold = 50000
        self._zero_expected_threshold = None
        self._zero_reshard_from_ws = None
        self._accum: dict[int, Tensor] = {}

    # -- state ------------------------------------------------------------
    def state_tensors(self):
        return (self.opt.state_tensors() + [self.partial_index]
                + list(self._residuals.values())
                + list(self._accum.values()))

    def get_states(self) -> dict:
        """Every state by name; ZeRO-1 state all-gathered to the global
        padded layout (a collective: every rank calls this) and stamped;
        entries restored but not yet created pass through."""
        states = {}
        for t in self.state_tensors():
            if "@zshard" in (t.name or ""):
                states[t.name] = _host_array(
                    self.communicator.all_gather(t.data))
            else:
                states[t.name] = t.numpy()
        pending_z = False
        for k, v in self.opt._pending_states.items():
            if k not in states:
                states[k] = np.asarray(v)
                pending_z = pending_z or "@zshard" in k
        if self._shard_views:
            states["__zero1_layout__"] = np.array(
                [self.world_size, self._zero_threshold], dtype=np.int64)
        elif pending_z:
            # pending sharded state is still in the checkpoint's layout
            ws = (self._zero_reshard_from_ws
                  if self._zero_reshard_from_ws is not None
                  else self.world_size)
            thr = (self._zero_expected_threshold
                   if self._zero_expected_threshold is not None
                   else self._zero_threshold)
            states["__zero1_layout__"] = np.array([ws, thr], dtype=np.int64)
        return states

    def set_states(self, states: dict):
        """Restore by name, in place (see the class docstring for the
        ZeRO-1 layout); state that does not exist yet waits in the
        wrapped optimizer's pending store."""
        states = dict(states)
        # every restore starts clean: no stale reshard arm, expected
        # threshold or buffered sharded entries of an earlier one
        self._zero_reshard_from_ws = None
        self._zero_expected_threshold = None
        for k in [k for k in self.opt._pending_states if "@zshard" in k]:
            del self.opt._pending_states[k]
        layout = states.pop("__zero1_layout__", None)
        if layout is not None:
            ws, thr = (int(x) for x in np.asarray(layout).ravel())
            if ws != self.world_size:
                if self._shard_views:
                    raise ValueError(
                        f"ZeRO-1 checkpoint was written with world_size="
                        f"{ws} but this optimizer has already built "
                        f"world_size={self.world_size} shard views; "
                        "cross-world-size restore only works into a "
                        "FRESH optimizer (before any sharded step).")
                if self.world_size == 1:
                    raise ValueError(
                        f"ZeRO-1 checkpoint was written with world_size="
                        f"{ws}; this process has world_size=1 and its "
                        "plain update path would silently discard the "
                        "sharded state — restore on a multi-rank group "
                        "(any size).")
                self._zero_reshard_from_ws = ws
            self._zero_expected_threshold = thr
        by_name = {t.name: t for t in self.state_tensors()}
        for name, arr in states.items():
            t = by_name.get(name)
            if t is None:
                self.opt._pending_states[name] = _host_array(arr)
                continue
            a = _host_array(arr)
            if "@zshard" in name:
                a = self._local_chunk(name, a.ravel(), t.data.numel())
            t.copy_from_numpy(a)
        self.opt._scalars = None

    def _local_chunk(self, name, a, chunk):
        """This rank's ``chunk`` of a global padded ZeRO-1 array."""
        if a.size != chunk * self.world_size:
            raise ValueError(
                f"{name}: {a.size} values for {self.world_size} ranks of "
                f"{chunk}: the checkpoint's ZeRO-1 layout does not match")
        r = self.communicator.axis_index()
        return a[r * chunk:(r + 1) * chunk]

    @property
    def step_counter(self):
        return self.opt.step_counter

    @property
    def _pending_states(self):
        return self.opt._pending_states

    # -- mixed precision (the wrapped optimizer's) ---------------------------
    def attach_precision_policy(self, policy):
        """Install a precision Policy on the wrapped optimizer, with the
        group's overflow vote (the module docstring)."""
        self.opt.attach_precision_policy(policy)
        self.opt._overflow_reducer = self.all_reduce

    def track_grad_norm(self, enable: bool = True) -> None:
        """The wrapped optimizer's (every variant updates through
        ``opt.apply``); each rank sums the gradients it applies."""
        self.opt.track_grad_norm(enable)

    @property
    def _grad_norm_sq(self):
        return self.opt._grad_norm_sq

    @property
    def _precision_policy(self):
        return self.opt._precision_policy

    @property
    def _masters(self):
        """The float32 master store (``Policy.begin_step`` fills it): the
        wrapped optimizer's."""
        return self.opt._masters

    @_masters.setter
    def _masters(self, masters):
        self.opt._masters = masters

    def _backward(self, loss: Tensor):
        """The wrapped optimizer's, in the reference's emission order,
        which buckets and selects the gradients (the ZeRO-1 layout,
        ``partial``'s rotation)."""
        self.partial_index.to_device(loss.device)
        return self.opt._backward(loss, ordered=True)

    # -- helpers ------------------------------------------------------------
    def all_reduce(self, raw):
        self.counters["allreduce_calls"] += 1
        self.counters["allreduce_bytes"] += raw.numel() * raw.element_size()
        return self.communicator.all_reduce(raw)

    def comm_stats(self) -> dict:
        return {"allreduce_calls": self.counters["allreduce_calls"],
                "allreduce_bytes": self.counters["allreduce_bytes"]}

    def publish_metrics(self, registry=None, **labels):
        raise NotImplementedError(
            "publish_metrics needs the port of the telemetry registry, "
            "which belongs to a later slice (ROADMAP.md queue 1, item 9)")

    def _mean(self, raw):
        return self.all_reduce(raw) / self.world_size

    def _lazy_buffer(self, kind: str, p: Tensor, store: dict) -> Tensor:
        """A zero buffer like ``p``'s float32 master (sparse residuals,
        accumulation buffers), created at first use from a restored entry
        when one waits."""
        buf = store.get(id(p))
        if buf is None:
            master = self.opt._masters.get(id(p), p.data)
            buf = Tensor(data=torch.zeros_like(master, requires_grad=False),
                         requires_grad=False, device=p.device,
                         name=self.opt._state_name(kind, p))
            pend = self.opt._pending_states.pop(buf.name, None)
            if pend is not None:
                buf.copy_from_numpy(pend)
            store[id(p)] = buf
        return buf

    def _apply_bucketed(self, pairs, threshold):
        """The plain exchange: grads under ``threshold`` elements in one
        flat all-reduce, the rest one each; the means applied."""
        small, big = [], []
        for p, g in pairs:
            (small if g.data.numel() < threshold else big).append((p, g))
        for p, g in big:
            g.data = self._mean(g.data)
            self.opt.apply(p, g)
        if small:
            flat = self._mean(torch.cat([g.data.reshape(-1)
                                         for _, g in small]))
            off = 0
            for p, g in small:
                n = g.data.numel()
                g.data = flat[off:off + n].view(g.data.shape)
                off += n
                self.opt.apply(p, g)

    # -- plain, with the fusion bucket for small grads -------------------
    def backward_and_update(self, loss: Tensor, threshold: int = 50000):
        """Plain synchronous data parallelism (reference opt.py:699)."""
        self._apply_bucketed(self._backward(loss), threshold)
        self.opt.step()

    update = backward_and_update

    def __call__(self, loss: Tensor):
        """``dist_opt(loss)``: the plain update."""
        self.backward_and_update(loss)

    # -- half precision -----------------------------------------------------
    def backward_and_update_half(self, loss: Tensor, threshold: int = 50000):
        """One flat bf16 all-reduce of every grad (reference opt.py:728)."""
        pairs = list(self._backward(loss))
        flat = torch.cat([g.data.to(torch.bfloat16).reshape(-1)
                          for _, g in pairs])
        flat = (self.all_reduce(flat) / self.world_size).to(torch.float32)
        off = 0
        for p, g in pairs:
            n = g.data.numel()
            g.data = flat[off:off + n].view(g.data.shape)
            off += n
            self.opt.apply(p, g)
        self.opt.step()

    # -- partial parameter sync -------------------------------------------
    def backward_and_partial_update(self, loss: Tensor, num_sync: int = 1):
        """A rotating subset of ``num_sync`` grads takes the group's mean,
        the rest the local grad (reference opt.py:744)."""
        pairs = list(self._backward(loss))
        n = len(pairs)
        pi = self.partial_index.data
        for i, (p, g) in enumerate(pairs):
            selected = torch.remainder(i - pi, n) < min(num_sync, n)
            g.data = torch.where(selected, self._mean(g.data), g.data)
            self.opt.apply(p, g)
        with torch.no_grad():
            pi.copy_(torch.remainder(pi + num_sync, max(n, 1)))
        self.opt.step()

    # -- sparse all-reduce --------------------------------------------------
    def backward_and_sparse_update(self, loss: Tensor, spars: float = 0.05,
                                   topK: bool = True, corr: bool = True,
                                   encoding: str = "dense"):
        """Top-K (or ``|g| >= spars``) sparsified exchange with error
        residuals (reference opt.py:764; the class docstring)."""
        if encoding not in ("dense", "indices"):
            raise ValueError(f"unknown sparse encoding {encoding!r} "
                             "(dense | indices)")
        if encoding == "indices" and not topK:
            raise ValueError("encoding='indices' requires topK=True: "
                             "threshold selection yields a data-dependent "
                             "K, which a fixed-size exchange cannot carry")
        comm = self.communicator
        for p, g in self._backward(loss):
            with torch.no_grad():
                raw = g.data
                res = None
                if corr:
                    res = self._lazy_buffer("resid", p, self._residuals)
                    raw = raw + res.data
                flat = raw.reshape(-1)
                if topK:
                    k = max(1, int(flat.shape[0] * spars))
                    idx = _top_k(flat, k)
                    sparse = torch.zeros_like(flat).scatter_(0, idx,
                                                             flat[idx])
                else:
                    sparse = torch.where(flat.abs() >= spars, flat,
                                         torch.zeros_like(flat))
                if res is not None:
                    res.data.copy_((flat - sparse).view(raw.shape))
                if encoding == "indices":
                    g_idx = comm.all_gather(idx.to(torch.int32), tiled=False)
                    g_val = comm.all_gather(flat[idx], tiled=False)
                    dense = torch.zeros_like(flat).index_put_(
                        (g_idx.reshape(-1).long(),), g_val.reshape(-1),
                        accumulate=True)
                    reduced = dense / self.world_size
                else:
                    reduced = self._mean(sparse)
                g.data = reduced.view(raw.shape)
            self.opt.apply(p, g)
        self.opt.step()

    # -- ZeRO-1 sharded optimizer -------------------------------------------
    def _zero_shard_group(self, pairs, key, name):
        """ZeRO-update one group of (param, grad) pairs as one flat
        exchange (reference opt.py:839): reduce-scatter the concatenated
        grads, update this rank's slice of the flat params with its own
        optimizer state, all-gather it and copy each param's values back
        in place."""
        N = self.world_size
        comm = self.communicator
        rank = comm.axis_index()
        n = sum(g.data.numel() for _, g in pairs)
        chunk = -(-n // N)
        # the update reads the float32 masters (popped: this group owns
        # them), so the sharded state stays float32 under any policy
        for p, _ in pairs:
            master = self.opt._masters.pop(id(p), None)
            if master is not None:
                p.data = master
        dev = pairs[0][0].device
        flat_g = _padded([g.data for _, g in pairs], chunk * N)
        flat_p = _padded([p.data.detach() for p, _ in pairs], chunk * N)
        view = self._shard_views.get(key)
        if view is None:
            view = Tensor(data=flat_p[:chunk], requires_grad=False,
                          device=dev, name=f"{name}@zshard")
            self._shard_views[key] = view
            self._localise_pending(name, n, chunk, rank)
        view.data = flat_p[rank * chunk:(rank + 1) * chunk]
        gs = comm.reduce_scatter(flat_g) / N
        self.opt.apply(view, Tensor(data=gs, requires_grad=False, device=dev))
        newp = comm.all_gather(view.data)
        off = 0
        for p, _ in pairs:
            k = p.data.numel()
            p.data.copy_(newp[off:off + k].view(p.data.shape))
            off += k

    def _localise_pending(self, name, n, chunk, rank):
        """Restored entries of this group's sharded state, in a
        checkpoint's global padded layout, become this rank's chunk;
        a checkpoint of another world size is re-padded first."""
        N = self.world_size
        old_ws = self._zero_reshard_from_ws
        pend = self.opt._pending_states
        for k in list(pend):
            if k.split(":", 1)[-1] != f"{name}@zshard":
                continue
            a = np.asarray(pend[k]).ravel()
            if old_ws and old_ws != N and a.size == -(-n // old_ws) * old_ws:
                a = np.pad(a[:n], (0, chunk * N - n))
            pend[k] = self._local_chunk(k, a, chunk)

    def backward_and_sharded_update(self, loss: Tensor,
                                    threshold: int = 50000):
        """ZeRO-1 data parallelism (reference opt.py:906): grads under
        ``threshold`` elements go in one flat group (``zero_bucket``),
        larger ones a group each; world 1 takes the plain per-grad path,
        as the reference does."""
        if (self._zero_expected_threshold is not None
                and self._zero_expected_threshold != threshold):
            raise ValueError(
                f"ZeRO-1 checkpoint was written with fusion "
                f"threshold={self._zero_expected_threshold}; this step uses "
                f"threshold={threshold}. The small-grad bucket composition "
                "would differ, silently mismatching restored optimizer "
                "state — use the original threshold.")
        self._zero_threshold = threshold
        small, big = [], []
        with torch.no_grad():
            for p, g in self._backward(loss):
                if self.world_size == 1:
                    g.data = self._mean(g.data)
                    self.opt.apply(p, g)
                    continue
                (small if g.data.numel() < threshold else big).append((p, g))
            for p, g in big:
                self._zero_shard_group([(p, g)], id(p), p.name or "param")
            if small:
                self._zero_shard_group(small, "zero_bucket", "zero_bucket")
        self.opt.step()

    # -- gradient accumulation ------------------------------------------------
    def backward_and_accumulate(self, loss: Tensor):
        """A micro-batch: add its grads into the accumulation buffers; no
        exchange, no update (reference opt.py:966)."""
        with torch.no_grad():
            for p, g in self._backward(loss):
                buf = self._lazy_buffer("gaccum", p, self._accum)
                buf.data.add_(g.data.to(buf.data.dtype))

    def backward_and_accum_update(self, loss: Tensor, accum_steps: int,
                                  threshold: int = 50000):
        """The boundary micro-batch: the mean of the buffers and this
        backward over ``accum_steps`` micro-batches, exchanged as the plain
        update; the buffers zeroed (reference opt.py:976)."""
        k = max(1, int(accum_steps))
        pairs = []
        with torch.no_grad():
            for p, g in self._backward(loss):
                buf = self._lazy_buffer("gaccum", p, self._accum)
                g.data = (buf.data + g.data) / k
                buf.data.zero_()
                pairs.append((p, g))
        self._apply_bucketed(pairs, threshold)
        self.opt.step()


def _top_k(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest ``|flat|``, largest first, ties to
    the lower index (``lax.top_k``'s order): a stable descending sort."""
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def _padded(tensors, size: int) -> torch.Tensor:
    """The tensors flattened and concatenated, zero-padded to ``size``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return torch.nn.functional.pad(flat, (0, size - flat.numel()))
