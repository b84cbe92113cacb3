"""``ResilientTrainer`` of the port: a training-loop wrapper that turns
bad steps into skipped or rolled-back steps instead of dead jobs.
Counterpart: ``singa_tpu/resilience/trainer.py``, whose policies,
counters and events it keeps.

* **Non-finite watchdog.**  It probes the loss the host fetches anyway
  (``loss.item()``) and, with ``track_grad_norm=True``, the optimizer's
  ``grad_norm_sq`` scalar: no extra sync inside the step.  Policies:

  - ``"skip"`` (default): the update is already an exact no-op inside
    the step.  The trainer arms the optimizer's overflow guard
    (:func:`singa_tpu_torch.precision.with_update_guard`, a static unit
    loss scale, bit-identical for float32 models): a step with any
    non-finite gradient feeds a zero gradient and ``torch.where``
    restores every parameter and optimizer state on the device, inside
    the captured graph.  Arming it changes the step's state, so the
    model's captured steps are dropped once, at construction: one
    capture before the first step, none after.  As in the reference,
    state the forward writes outside the optimizer (BatchNorm's running
    statistics) takes the poisoned batch.  The trainer counts the event
    and raises after ``max_consecutive_nonfinite`` in a row.
  - ``"rollback"``: restore the newest valid checkpoint in place
    (``reset_caches=False``: the captured step's tensors take the
    restored values, nothing is captured again), rewind the loader
    cursor and the step index, and reseed the device generator from
    its restored state and the rollback count (:func:`_reseed`), so the
    replayed steps draw other masks, the same in every run of the same
    seed, on the eager and the captured path alike.
  - ``"raise"``: fail with :class:`NonFiniteLossError`.

* **Grad-norm spike detector** (``track_grad_norm=True``): a step whose
  ``||g||`` exceeds ``spike_factor`` times the rolling median is
  counted and logged.
* **Stalled-step timeout**: ``max_slow_steps`` consecutive steps over
  ``step_budget_ms`` raise :class:`TrainingStalledError`.
* **Periodic async checkpoints** every ``save_every`` steps through the
  attached :class:`~singa_tpu_torch.resilience.checkpoint.CheckpointManager`,
  with the loader cursor and the step index.

Chaos seams (``faults=TrainFaultPlan(...)``) fire at the top of each
step and on the batch, never inside a captured step.  Watchdog activity
publishes ``train_watchdog_*`` counters to the default metrics registry
and instants on the installed tracer.
"""

from __future__ import annotations

import hashlib
import math
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from ..logging import LOG, WARNING
from ..precision import with_update_guard
from ..telemetry import registry as _registry_mod
from ..telemetry import tracer as _tracer_mod

__all__ = ["ResilientTrainer", "StepReport", "NonFiniteLossError",
           "TrainingStalledError"]


class NonFiniteLossError(FloatingPointError):
    """Loss/grad-norm went non-finite and the policy chose to fail."""


class TrainingStalledError(RuntimeError):
    """Too many consecutive steps blew the wall-clock budget."""


@dataclass
class StepReport:
    """What the last :meth:`ResilientTrainer.step` observed."""
    index: int
    loss: float
    grad_norm: float | None = None
    wall_ms: float = 0.0
    nonfinite: bool = False
    skipped: bool = False
    rolled_back: bool = False
    spike: bool = False
    slow: bool = False
    events: list = field(default_factory=list)


def _registry():
    return _registry_mod.default_registry()


def _tracer():
    return _tracer_mod.current()


def _reseed(device, nonce: int) -> None:
    """Seed ``device``'s generator from its current state and ``nonce``
    (the port's counterpart of ``jax.random.fold_in``): a function of
    both, so a rollback's replay draws other numbers than the run that
    went bad, and the same ones in every run.  Written through
    ``set_rng_state``, which a captured step's replay reads."""
    digest = hashlib.sha256(device.get_rng_state().numpy().tobytes()
                            + int(nonce).to_bytes(8, "little")).digest()
    g = torch.Generator(device=device.torch_device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    device.set_rng_state(g.get_state())


class ResilientTrainer:
    """Wraps a compiled ``model`` (anything with ``train_one_batch``)
    with watchdogs and periodic checkpoints.  Build it before the first
    training step: arming the skip guard or grad-norm tracking changes
    the step's state, so the trainer drops the model's captured steps
    once, at construction; after that the step is captured once and
    never again.

    ``loss_from``: maps the ``train_one_batch`` return value to the loss
    tensor (default: last element of a tuple, else the value itself).
    ``clock`` is injectable for the stall watchdog tests.
    """

    def __init__(self, model, *, checkpoint=None, loader=None,
                 save_every: int = 0,
                 nonfinite_policy: str = "skip",
                 max_consecutive_nonfinite: int = 8,
                 track_grad_norm: bool = False,
                 spike_factor: float = 100.0, spike_window: int = 32,
                 step_budget_ms: float | None = None,
                 max_slow_steps: int = 8,
                 faults=None, loss_from=None, clock=time.perf_counter):
        if nonfinite_policy not in ("skip", "rollback", "raise"):
            raise ValueError(f"unknown nonfinite_policy "
                             f"{nonfinite_policy!r} (skip|rollback|raise)")
        if nonfinite_policy == "rollback" and checkpoint is None:
            raise ValueError("nonfinite_policy='rollback' needs a "
                             "CheckpointManager to roll back to")
        self.model = model
        self.checkpoint = checkpoint
        self.loader = loader
        self.save_every = int(save_every)
        self.nonfinite_policy = nonfinite_policy
        self.max_consecutive_nonfinite = int(max_consecutive_nonfinite)
        self.spike_factor = float(spike_factor)
        self.step_budget_ms = step_budget_ms
        self.max_slow_steps = int(max_slow_steps)
        self.faults = faults
        self._loss_from = loss_from or self._default_loss_from
        self._clock = clock
        self.step_index = 0
        self.last: StepReport | None = None
        self.save_aux: dict = {}
        self.rollbacks = 0
        self._consec_nonfinite = 0
        self._consec_slow = 0
        self._norm_window: deque = deque(maxlen=int(spike_window))
        if faults is not None:
            faults.bind(_tracer())
        if nonfinite_policy == "skip":
            self._arm_skip_guard()
        if track_grad_norm:
            opt = getattr(model, "optimizer", None)
            if opt is None or not hasattr(opt, "track_grad_norm"):
                raise ValueError("track_grad_norm=True needs a model "
                                 "with an optimizer attached")
            opt.track_grad_norm(True)
            self._track_grad_norm = True
            model._drop_graphs()  # the state changed: one fresh capture
        else:
            self._track_grad_norm = False

    # ------------------------------------------------------------------
    @staticmethod
    def _default_loss_from(outs):
        return outs[-1] if isinstance(outs, (tuple, list)) else outs

    def _arm_skip_guard(self) -> None:
        """Ensure the step carries the exact update-skip guard: a model
        with no precision policy (or one without a loss scale) gets its
        policy upgraded with a static unit scale (bit-identical
        numerics); ``set_precision_policy`` drops the captured steps."""
        pol = getattr(self.model, "precision_policy", None)
        if pol is not None and pol.loss_scale is not None:
            return  # a real loss scale is already the guard
        self.model.set_precision_policy(with_update_guard(pol))

    # ------------------------------------------------------------------
    def resume(self):
        """Restore the newest valid checkpoint (a fresh-process resume:
        captured steps dropped, loader cursor, step index and the device
        generator rewound).  Returns
        the checkpoint meta or None when nothing to resume from."""
        if self.checkpoint is None:
            return None
        meta = self.checkpoint.restore_latest(self.model)
        if meta is None:
            return None
        self.step_index = int(meta.get("step", 0))
        if self.loader is not None and meta.get("loader"):
            self.loader.load_state_dict(meta["loader"])
        return meta

    def _grad_norm(self) -> float | None:
        if not self._track_grad_norm:
            return None
        sq = self.model.optimizer._grad_norm_sq
        if sq is None:
            return None
        v = float(sq.item())
        return math.sqrt(v) if v >= 0 and math.isfinite(v) else v

    # ------------------------------------------------------------------
    def step(self, *batch):
        """One resilient training step.  Returns ``train_one_batch``'s
        output; the observation record lands in :attr:`last`."""
        i = self.step_index
        t0 = self._clock()  # before the fault seam: injected latency is
        if self.faults is not None:  # exactly what the stall watchdog is for
            self.faults.on_step(i)
            batch = self.faults.poison_batch(i, batch)
        outs = self.model.train_one_batch(*batch)
        loss = float(self._loss_from(outs).item())
        wall_ms = (self._clock() - t0) * 1e3
        gn = self._grad_norm()
        rep = StepReport(index=i, loss=loss, grad_norm=gn,
                         wall_ms=wall_ms)
        self._watch_stall(rep)
        bad = not math.isfinite(loss) or (gn is not None
                                          and not math.isfinite(gn))
        if bad:
            self._on_nonfinite(rep)
        else:
            self._consec_nonfinite = 0
            self._watch_spike(rep)
        self.last = rep
        if not rep.rolled_back:
            self.step_index = i + 1
            if (self.save_every and self.checkpoint is not None
                    and self.step_index % self.save_every == 0):
                self.save()
        return outs

    def save(self, blocking: bool | None = None, *, aux=None) -> None:
        """Checkpoint now at the current step index (also called by the
        periodic cadence).  ``aux`` — merged over the persistent
        :attr:`save_aux` stamp — rides the checkpoint: in the manifest
        entry's meta and as the file's aux records, with the step index
        under ``"step"``; :meth:`CheckpointManager.restore_latest`
        returns it under ``"aux"``."""
        extra = dict(self.save_aux)
        if aux:
            extra.update(aux)
        extra["step"] = self.step_index
        self.checkpoint.save(self.step_index, aux=extra,
                             loader=self.loader, blocking=blocking)

    def run(self, loader, epochs: int, *, extra_args=(), on_step=None,
            on_epoch=None):
        """Epoch-loop convenience over a cursor-carrying
        :class:`~singa_tpu_torch.data.DataLoader`: drives :meth:`step` for
        every batch, re-entering the loader after a rollback (the
        restored cursor makes re-iteration resume at the rewound
        position).  ``on_step(trainer)`` after every step;
        ``on_epoch(epoch, losses)`` after each completed epoch."""
        while loader.epoch < epochs:
            epoch = loader.epoch
            losses = []
            rolled = False
            for batch in loader:
                self.step(*batch, *extra_args)
                losses.append(self.last.loss)
                if on_step is not None:
                    on_step(self)
                if self.last.rolled_back:
                    rolled = True
                    break  # cursor was rewound: re-enter iteration
            if rolled:
                continue
            if on_epoch is not None:
                on_epoch(epoch, losses)
        if self.checkpoint is not None:
            self.checkpoint.wait()

    # ------------------------------------------------------------------
    # watchdogs
    # ------------------------------------------------------------------
    def _event(self, rep: StepReport, tag: str, counter: str,
               help_: str) -> None:
        rep.events.append(tag)
        _registry().counter(counter, help=help_).inc()
        tr = _tracer()
        if tr is not None:
            tr.instant("watchdog", cat="train", args={"event": tag})
        LOG(WARNING, "watchdog: %s", tag)

    def _watch_stall(self, rep: StepReport) -> None:
        if self.step_budget_ms is None:
            return
        if rep.wall_ms > self.step_budget_ms:
            rep.slow = True
            self._consec_slow += 1
            self._event(rep, f"slow_step:{rep.index}:"
                        f"{rep.wall_ms:.0f}ms",
                        "train_watchdog_slow_steps_total",
                        "steps over the wall-clock budget")
            if self._consec_slow > self.max_slow_steps:
                raise TrainingStalledError(
                    f"{self._consec_slow} consecutive steps over "
                    f"{self.step_budget_ms}ms (last: {rep.wall_ms:.0f}ms)")
        else:
            self._consec_slow = 0

    def _watch_spike(self, rep: StepReport) -> None:
        gn = rep.grad_norm
        if gn is None:
            return
        win = self._norm_window
        if len(win) >= 8:
            med = sorted(win)[len(win) // 2]
            if med > 0 and gn > self.spike_factor * med:
                rep.spike = True
                self._event(rep, f"grad_spike:{rep.index}:"
                            f"{gn:.3g}x~{med:.3g}",
                            "train_watchdog_spike_total",
                            "grad-norm spikes vs rolling median")
                return  # a spike must not poison the median window
        win.append(gn)

    def _on_nonfinite(self, rep: StepReport) -> None:
        rep.nonfinite = True
        self._consec_nonfinite += 1
        self._event(rep, f"nonfinite:{rep.index}:loss={rep.loss}",
                    "train_watchdog_nonfinite_total",
                    "steps with non-finite loss/grad-norm")
        if self.nonfinite_policy == "raise":
            raise NonFiniteLossError(
                f"non-finite loss at step {rep.index}: {rep.loss}")
        if self._consec_nonfinite > self.max_consecutive_nonfinite:
            raise NonFiniteLossError(
                f"{self._consec_nonfinite} consecutive non-finite steps "
                f"(policy={self.nonfinite_policy}) — giving up")
        if self.nonfinite_policy == "skip":
            # the in-step guard already dropped the update exactly
            rep.skipped = True
            self._event(rep, f"skip:{rep.index}",
                        "train_watchdog_skip_total",
                        "updates dropped by the skip policy")
            return
        self._rollback(rep)

    def _rollback(self, rep: StepReport) -> None:
        self.checkpoint.wait()  # an in-flight save must land first
        meta = self.checkpoint.restore_latest(self.model,
                                              reset_caches=False)
        if meta is None:
            raise NonFiniteLossError(
                f"non-finite loss at step {rep.index} and no valid "
                "checkpoint to roll back to")
        self.rollbacks += 1
        rep.rolled_back = True
        self.step_index = int(meta.get("step", 0))
        if self.loader is not None and meta.get("loader"):
            self.loader.load_state_dict(meta["loader"])
        # reseed: fold the rollback count into the restored state so the
        # replayed steps draw other numbers than the run that went bad
        dev = getattr(self.model, "device", None)
        if dev is not None:
            _reseed(dev, self.rollbacks)
        self._consec_nonfinite = 0
        self._norm_window.clear()
        self._event(rep, f"rollback:{rep.index}->"
                    f"step{self.step_index}",
                    "train_watchdog_rollback_total",
                    "checkpoint rollbacks by the watchdog")
