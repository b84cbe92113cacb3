"""Devices of the PyTorch/CUDA port.

Counterpart: ``singa_tpu/device.py`` — ``Device`` (:57), ``CppCPU``
(:263) and ``create_cuda_gpu`` (:417).  A
:class:`Device` holds a ``torch.device`` and a seeded
``torch.Generator`` on it (``set_rand_seed``), the port's stand-in for
the reference's device-resident RNG key; layers draw their initial
weights from it.

The port has one rule where the JAX package picks a backend implicitly:
entry points run on the CUDA card unless the caller asks for the CPU by
name, and :func:`resolve_device` is the one place that picks CUDA or
raises.  A machine without CUDA raises instead of quietly running the
plain (kernel-free) versions on the CPU.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "seeded_generator", "Device", "CppCPU",
           "CudaGPU", "create_cuda_gpu", "get_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` (the default) means the CUDA card and raises when CUDA is
    absent; ``"cpu"`` (or a CPU ``torch.device``) is honoured only
    because the caller named it; any ``"cuda[:i]"`` must exist.  A
    :class:`Device` resolves to its ``torch.device``."""
    if isinstance(device, Device):
        return device.torch_device
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


class Device:
    """A placement and RNG handle over one ``torch.device``.

    ``lang`` is ``"cpp"`` for the host CPU and ``"cuda"`` for a card
    (the reference's ``lang::Cpp`` / ``lang::Cuda``).  ``generator`` is
    seeded from ``seed`` (a random seed when None) and reseeded by
    :meth:`set_rand_seed`."""

    def __init__(self, device, seed: int | None = None):
        self.torch_device = resolve_device(device)
        self.lang = "cpp" if self.torch_device.type == "cpu" else "cuda"
        self.id = self.torch_device.index or 0
        self.generator = torch.Generator(device=self.torch_device)
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self.set_rand_seed(seed)

    def set_rand_seed(self, seed: int) -> None:
        """Reference: ``Device::SetRandSeed``."""
        self.generator.manual_seed(int(seed))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.id}, lang={self.lang})"


class CppCPU(Device):
    """The host CPU (reference: ``src/core/device/cpp_cpu.cc``)."""

    def __init__(self, device_id: int = 0, seed: int | None = None):
        super().__init__("cpu", seed)


class CudaGPU(Device):
    """One CUDA card (reference: ``src/core/device/cuda_gpu.cc``); raises
    when CUDA is absent."""

    def __init__(self, device_id: int = 0, seed: int | None = None):
        super().__init__(f"cuda:{int(device_id)}", seed)


def create_cuda_gpu(seed: int | None = None) -> CudaGPU:
    return CudaGPU(0, seed=seed)


_DEVICES: dict[torch.device, Device] = {}


def get_device(device=None) -> Device:
    """The :class:`Device` for ``device`` (a :class:`Device`, a
    ``torch.device``, a string or None for the card): one shared
    instance per ``torch.device``, so tensors and layers placed there
    draw from one generator (reference: the default device)."""
    if isinstance(device, Device):
        return device
    dev = resolve_device(device)
    found = _DEVICES.get(dev)
    if found is None:
        found = _DEVICES[dev] = (CppCPU() if dev.type == "cpu"
                                 else CudaGPU(dev.index))
    return found
