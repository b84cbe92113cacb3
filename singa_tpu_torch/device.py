"""Device selection and seeded generators for the PyTorch/CUDA port.

Counterpart: the device-selection part of ``singa_tpu/device.py``
(``get_default_device`` / ``create_cpu_device`` / ``create_tpu_device``).
The port has one rule where the JAX package picks a backend implicitly:
entry points run on the CUDA card unless the caller asks for the CPU by
name.  A machine without CUDA raises instead of quietly running the
plain (kernel-free) versions on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "seeded_generator"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` (the default) means the CUDA card and raises when CUDA is
    absent; ``"cpu"`` (or a CPU ``torch.device``) is honoured only
    because the caller named it; any ``"cuda[:i]"`` must exist."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU explicitly")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seeded_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (resolved as above) seeded
    with ``seed`` — the port's stand-in for ``jax.random.PRNGKey(seed)``.
    The two produce different numbers from the same seed."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
