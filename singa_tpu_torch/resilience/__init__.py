"""Fault-tolerant training on the port: atomic async checkpoints with
exact resume, step watchdogs, and a deterministic training chaos
harness.  Counterpart: ``singa_tpu/resilience/``, with its ``__all__``.

* :class:`CheckpointManager` — periodic async checkpoints off the
  training thread; atomic publication (tmp + fsync + ``os.replace`` +
  manifest with per-file CRC32); keep-last-K retention; shard-aware saves
  under ZeRO-1; exact resume (optimizer state, loss scale, the device
  generator, loader cursor).
* :class:`ResilientTrainer` — non-finite loss/grad watchdog with
  ``skip`` / ``rollback`` / ``raise`` policies, grad-norm spike detector,
  stalled-step timeout, periodic save cadence.
* :class:`TrainFaultPlan` — deterministic chaos injection (NaN grads,
  crash-at-step, kill-mid-checkpoint-write, slow steps).

Checkpoint directories cross between the two packages both ways.
"""

from ..snapshot import CorruptCheckpointError
from .checkpoint import CheckpointManager
from .faults import (CrashAtStep, KillMidCheckpointWrite, NaNGrads,
                     SlowStep, SpikeGrads, TrainFaultPlan)
from .trainer import (NonFiniteLossError, ResilientTrainer, StepReport,
                      TrainingStalledError)

__all__ = [
    "CheckpointManager",
    "ResilientTrainer",
    "StepReport",
    "NonFiniteLossError",
    "TrainingStalledError",
    "CorruptCheckpointError",
    "TrainFaultPlan",
    "NaNGrads",
    "SpikeGrads",
    "CrashAtStep",
    "KillMidCheckpointWrite",
    "SlowStep",
]
