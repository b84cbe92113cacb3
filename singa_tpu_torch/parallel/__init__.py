"""Data parallelism of the port.  Counterpart: ``singa_tpu/parallel/``.

:mod:`.communicator` holds the ``Communicator`` over
``torch.distributed`` (NCCL on the card, gloo on the CPU), the
``init_distributed`` bootstrap, ``NcclIdHolder`` and the ``launch``
helper that runs one process per rank; ``opt.DistOpt`` is built on it.
The reference's sequence, tensor, pipeline and expert parallelism and
``serving_submeshes`` belong to a later slice (ROADMAP.md queue 1,
item 12).
"""

from .communicator import (Communicator, NcclIdHolder,  # noqa: F401
                           init_distributed, launch)

__all__ = ["Communicator", "NcclIdHolder", "init_distributed", "launch"]
