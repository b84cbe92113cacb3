"""Deterministic fault injection for the training loop of the port.
Counterpart: ``singa_tpu/resilience/faults.py``, at the same seams of
``ResilientTrainer`` / ``CheckpointManager``:

* :class:`NaNGrads` — the batch feeding steps ``at_step..at_step+count-1``
  is poisoned with NaNs, so the backward produces non-finite gradients and
  the step's overflow guard / watchdog policies fire (the poisoned array
  keeps its shape, dtype and device, so the captured step's input
  signature is unchanged: it replays, with no new capture).
  TRANSIENT: the fault fires at most ``count`` times, so a
  rollback-replayed step runs clean — it models a data/hardware glitch,
  not deterministically bad data (which rollback could never escape);
* :class:`SpikeGrads` — the batch is scaled by ``factor`` (finite but
  huge), exercising the grad-norm spike detector without tripping the
  non-finite probe; transient like :class:`NaNGrads`;
* :class:`CrashAtStep` — ``kill()`` (default ``SIGKILL`` to self) fires at
  the top of step ``at_step``: the hard preemption the checkpoint/resume
  path must survive;
* :class:`KillMidCheckpointWrite` — ``kill()`` fires inside the
  ``at_save``-th checkpoint write, at a chosen ``phase`` ("staged" = tmp
  bytes on disk but not yet published; "published" = file renamed into
  place but manifest not yet updated), proving atomic publication: either
  way the manifest still points at the previous good checkpoint;
* :class:`SlowStep` — ``plan.sleep(ms)`` at the top of steps
  ``at_step..at_step+count-1``, tripping the stalled-step watchdog.

Every fault fires at a deterministic point (step index or checkpoint-save
ordinal), so a failing chaos test replays exactly; fired faults land in
``events``.  ``kill`` and ``sleep`` are injectable so in-process tests can
observe the would-be kill / drive a fake clock instead of dying.  Seams
are guarded with ``if faults is not None`` and none exist inside a
captured step, so a disabled plan costs nothing.

``TrainFaultPlan.random(seed, ...)`` draws a reproducible multi-fault
plan for soak runs; the fast deterministic tests (``chaos`` marker)
construct plans explicitly.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TrainFaultPlan", "NaNGrads", "SpikeGrads", "CrashAtStep",
           "KillMidCheckpointWrite", "SlowStep"]


@dataclass(frozen=True)
class NaNGrads:
    """Poison the batch of steps ``at_step .. at_step+count-1`` (0-based)
    with NaNs so the backward's gradients go non-finite."""
    at_step: int
    count: int = 1


@dataclass(frozen=True)
class SpikeGrads:
    """Scale the batch of step ``at_step`` by ``factor`` — finite but
    huge gradients, for the spike detector."""
    at_step: int
    factor: float = 1e6


@dataclass(frozen=True)
class CrashAtStep:
    """Hard-kill the process at the top of step ``at_step`` (0-based)."""
    at_step: int


@dataclass(frozen=True)
class KillMidCheckpointWrite:
    """Hard-kill during the ``at_save``-th checkpoint write (1-based
    ordinal over saves), at ``phase``: "staged" (tmp file written, not
    yet renamed) or "published" (renamed, manifest not yet updated)."""
    at_save: int = 1
    phase: str = "staged"


@dataclass(frozen=True)
class SlowStep:
    """Sleep ``ms`` at the top of steps ``at_step .. at_step+count-1``."""
    at_step: int
    ms: float
    count: int = 1


def _default_kill():
    os.kill(os.getpid(), signal.SIGKILL)


class TrainFaultPlan:
    """An ordered collection of training fault specs plus the firing log.

    ``sleep`` and ``kill`` are injectable: tests drive :class:`SlowStep`
    against a fake clock and observe :class:`CrashAtStep` /
    :class:`KillMidCheckpointWrite` by passing a callable that raises
    instead of sending ``SIGKILL``.
    """

    def __init__(self, *faults, sleep=time.sleep, kill=_default_kill):
        self.faults = list(faults)
        self.sleep = sleep
        self.kill = kill
        self.saves = 0                 # checkpoint writes observed
        self._spent: dict[int, int] = {}  # fault idx -> times fired
        self.events: list[str] = []
        self._tracer = None

    def bind(self, tracer=None) -> None:
        """Attach a telemetry tracer (the trainer/manager call this):
        every fired fault also lands as an instant event on the host
        lane, so injected faults are visible in exported traces."""
        self._tracer = tracer

    def _fire(self, tag: str) -> None:
        self.events.append(tag)
        tr = self._tracer
        if tr is not None:
            from ..telemetry.tracer import PID_HOST
            tr.instant("fault", pid=PID_HOST, cat="fault",
                       args={"fault": tag})

    @classmethod
    def random(cls, seed: int, n_steps: int, n_saves: int = 4,
               n_faults: int = 3, **kw) -> "TrainFaultPlan":
        """A reproducible mixed plan for soak runs: ``n_faults`` faults
        drawn over the five kinds, targeting the given step/save ranges.
        Crash-type faults are capped at one per plan (a second would
        never be reached)."""
        rng = np.random.RandomState(seed)
        faults, crashed = [], False
        for _ in range(n_faults):
            kind = int(rng.randint(5))
            if kind == 0:
                faults.append(NaNGrads(int(rng.randint(n_steps)),
                                       int(rng.randint(1, 3))))
            elif kind == 1:
                faults.append(SpikeGrads(int(rng.randint(n_steps)),
                                         float(10.0 ** rng.randint(4, 8))))
            elif kind == 2 and not crashed:
                faults.append(CrashAtStep(int(rng.randint(n_steps))))
                crashed = True
            elif kind == 3 and not crashed:
                faults.append(KillMidCheckpointWrite(
                    int(rng.randint(1, max(2, n_saves + 1))),
                    phase=("staged", "published")[int(rng.randint(2))]))
                crashed = True
            else:
                faults.append(SlowStep(int(rng.randint(n_steps)),
                                       float(1 + rng.randint(4)),
                                       int(rng.randint(1, 3))))
        return cls(*faults, **kw)

    # ---- seams (trainer/manager call these; each is O(#faults)) --------
    def on_step(self, step_idx: int) -> None:
        """Top-of-step seam: latency spikes, then hard crashes."""
        for f in self.faults:
            if (isinstance(f, SlowStep)
                    and f.at_step <= step_idx < f.at_step + f.count):
                self._fire(f"slow_step:step{step_idx}")
                self.sleep(f.ms / 1e3)
        for f in self.faults:
            if isinstance(f, CrashAtStep) and f.at_step == step_idx:
                self._fire(f"crash:step{step_idx}")
                self.kill()

    def poison_batch(self, step_idx: int, batch: tuple) -> tuple:
        """Batch seam: NaN or spike the first floating array of the
        batch (a port ``Tensor``, a ``torch.Tensor`` or a numpy array),
        keeping its type, shape, dtype and device, so the captured step's
        signature (and its graph) is untouched."""
        fill = None
        for idx, f in enumerate(self.faults):
            if (isinstance(f, NaNGrads)
                    and f.at_step <= step_idx < f.at_step + f.count
                    and self._spent.get(idx, 0) < f.count):
                self._spent[idx] = self._spent.get(idx, 0) + 1
                self._fire(f"nan_grads:step{step_idx}")
                fill = ("nan", None)
            elif (isinstance(f, SpikeGrads) and f.at_step == step_idx
                    and self._spent.get(idx, 0) < 1):
                self._spent[idx] = 1
                self._fire(f"spike_grads:step{step_idx}")
                fill = ("scale", f.factor)
        if fill is None:
            return batch
        from ..tensor import Tensor  # lazy: avoid import cycle
        out = []
        done = False
        for item in batch:
            raw = item.data if isinstance(item, Tensor) else item
            if not done and _floating(raw):
                raw = _poison(raw, fill)
                done = True
                if isinstance(item, Tensor):
                    item = Tensor(data=raw, device=item.device,
                                  requires_grad=False)
                else:
                    item = raw
            out.append(item)
        return tuple(out)

    def on_checkpoint_write(self, phase: str) -> None:
        """Checkpoint-writer seam.  Called with ``phase="begin"`` once
        per save (advances the ordinal), then at each kill point."""
        if phase == "begin":
            self.saves += 1
            return
        for f in self.faults:
            if (isinstance(f, KillMidCheckpointWrite)
                    and f.at_save == self.saves and f.phase == phase):
                self._fire(f"kill_mid_ckpt:save{self.saves}:{phase}")
                self.kill()


def _floating(raw) -> bool:
    if isinstance(raw, torch.Tensor):
        return raw.is_floating_point()
    return (isinstance(raw, np.ndarray)
            and np.issubdtype(raw.dtype, np.floating))


def _poison(raw, fill):
    """NaNs like ``raw``, or ``raw`` times the spike factor."""
    if isinstance(raw, torch.Tensor):
        return (torch.full_like(raw, float("nan")) if fill[0] == "nan"
                else raw * fill[1])
    return (np.full_like(raw, np.nan) if fill[0] == "nan"
            else raw * np.asarray(fill[1], raw.dtype))
