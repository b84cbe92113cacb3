"""Devices of the PyTorch/CUDA port.

Counterpart: ``singa_tpu/device.py`` — ``Device`` (:57), ``CppCPU``
(:263), ``DeviceMemPool``/``CnMemPool`` (:295), ``Platform`` (:340) and
the module functions (:388-422), by their names.  A :class:`Device`
holds a ``torch.device`` and a seeded ``torch.Generator`` on it
(``set_rand_seed``, ``get_rng_state``/``set_rng_state``), the port's
stand-in for the reference's device-resident RNG key; layers draw their
initial weights from it and ``Tensor.uniform`` & co. their values.  It
carries the reference's parity surface: ``put``, ``EnableGraph``
(a flag nothing reads, as in the reference), ``RunGraph`` (nothing to
do), ``Sync`` (``torch.cuda.synchronize`` on a card), ``Reset``
(which, unlike the reference's, also forgets the banked flop tables) and
the profiling knob:

* ``SetVerbosity(v)`` also sets :func:`singa_tpu_torch.logging.SetVerbosity`.
  At ``v >= 1`` ``Model.train_one_batch`` times every step, blocking,
  from before its dispatch to after :meth:`Device.Sync`
  (:meth:`record_step_time`), and banks a flop table once per input
  signature (:meth:`record_cost_analysis`); at ``v >= 2`` a
  ``torch.profiler`` trace runs into ``trace_dir`` (default
  ``./profile_traces``), written when the verbosity drops below 2 or at
  exit.  :meth:`PrintTimeProfiling` prints and returns the table.  Each
  timed step also lands in the default telemetry registry's
  ``train_step_time_ms`` histogram (labelled ``device="<lang>:<id>"``),
  as the reference's does.

The port has one rule where the JAX package picks a backend implicitly:
entry points run on the CUDA card unless the caller asks for the CPU by
name, and :func:`resolve_device` is the one place that picks CUDA or
raises.  A machine without CUDA raises instead of quietly running the
plain (kernel-free) versions on the CPU.  Where the reference's names
meet that rule, the port diverges on purpose:

* **The default device is the card.**  The reference's is the host CPU
  (:388-394).  :func:`get_default_device` returns the card and raises
  without CUDA until :func:`set_default_device` names another device;
  ``set_default_device(create_cpu_device())`` is how a caller (or a test
  fixture) asks for the CPU by name.  ``get_device(None)`` returns the
  default device, so ``Tensor(device=None)`` and the tensor
  constructors follow ``set_default_device`` as the reference's do;
  ``resolve_device(None)``, which the engines and ``generate`` use,
  stays the card.
* **No fallback to the CPU.**  The reference's
  ``Platform.accelerator_devices`` falls back to the CPU with a warning
  and ``TpuDevice(i)`` clamps ``i`` to the devices there are
  (:346-359, :274); ``Platform.CreateCudaGPUs``, ``create_cuda_gpu_on``
  and ``create_cuda_gpus`` raise instead when CUDA is absent or the card
  does not exist, and ``accelerator_devices`` is empty without CUDA.
* ``Tensor.to_host()`` goes to a CPU device, never to "the default
  device", which the reference's does (the two are the same there).

``CudaGPU``, ``create_cuda_gpu_on``, ``create_cuda_gpus`` and
``Platform.CreateCudaGPUs`` stand for ``TpuDevice``,
``create_tpu_device``, ``create_tpu_devices`` and ``CreateTpuDevices``.
"""

from __future__ import annotations

import atexit
import os
import socket
import time

import numpy as np
import torch

from . import logging as _log

__all__ = ["resolve_device", "seeded_generator", "Device", "CppCPU",
           "CudaGPU", "Platform", "DeviceMemPool", "CnMemPool",
           "create_cpu_device", "create_cuda_gpu", "create_cuda_gpu_on",
           "create_cuda_gpus", "get_default_device", "set_default_device",
           "get_device"]

# host data follows the JAX package's 32-bit default
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _host_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    return torch.tensor(a, device=device)


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
    elif dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def seeded_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (resolved as above) seeded
    with ``seed`` — the port's stand-in for ``jax.random.PRNGKey(seed)``.
    The two produce different numbers from the same seed."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g


class Device:
    """A placement, RNG and profiling handle over one ``torch.device``.

    ``lang`` is ``"cpp"`` for the host CPU and ``"cuda"`` for a card
    (the reference's ``lang::Cpp`` / ``lang::Cuda``).  ``generator`` is
    seeded from ``seed`` (a random seed when None) and reseeded by
    :meth:`set_rand_seed`."""

    def __init__(self, device, seed: int | None = None):
        self.torch_device = resolve_device(device)
        self.lang = "cpp" if self.torch_device.type == "cpu" else "cuda"
        self.id = self.torch_device.index or 0
        self.generator = torch.Generator(device=self.torch_device)
        self.graph_enabled = False
        self.verbosity = 0
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self.set_rand_seed(seed)
        # profiling state (SetVerbosity / PrintTimeProfiling)
        self._step_times_ms: list = []
        self._cost_tables: dict = {}
        self._profiler = None
        self._trace_dir = None
        self.trace_files: list = []     # the traces written, in order

    # ---- placement -----------------------------------------------------
    def put(self, array) -> torch.Tensor:
        """``array`` (a ``torch.Tensor``, numpy data or a Python scalar)
        on this device (reference: ``CopyDataToFrom``); host data takes
        the 32-bit default."""
        if isinstance(array, torch.Tensor):
            return array.to(self.torch_device)
        return _host_to_torch(array, self.torch_device)

    # ---- RNG -----------------------------------------------------------
    def set_rand_seed(self, seed: int) -> None:
        """Reference: ``Device::SetRandSeed``."""
        self.generator.manual_seed(int(seed))

    def get_rng_state(self) -> torch.Tensor:
        """The generator's state (a CPU byte tensor): on a card its seed
        and Philox offset, which a captured step's replay reads."""
        return self.generator.get_state()

    def set_rng_state(self, state) -> None:
        self.generator.set_state(state)

    # ---- graph / execution-mode parity API ----------------------------
    def EnableGraph(self, enabled: bool = True) -> None:
        """Parity with ``Device::EnableGraph``: sets the flag, which
        nothing reads (``Model.compile(use_graph=...)`` picks the mode),
        as in the reference."""
        self.graph_enabled = bool(enabled)

    def RunGraph(self, sequential: bool = False) -> None:
        """Nothing to do: a captured step replays its CUDA graph when
        ``train_one_batch`` is called."""
        del sequential

    def Sync(self) -> None:
        """Block until the work queued on this device is done (reference:
        ``Device::Sync``); the CPU runs synchronously."""
        if self.lang == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def Reset(self) -> None:
        """Forget the steps timed and the flop tables banked."""
        self._step_times_ms = []
        self._cost_tables = {}

    # ---- profiling -----------------------------------------------------
    def SetVerbosity(self, v: int, trace_dir: str | None = None) -> None:
        """Reference: ``Device::SetVerbosity`` (see the module
        docstring).  At 2 or more a ``torch.profiler`` trace of this
        device's work starts (once); below 2 a running trace stops and is
        written."""
        self.verbosity = int(v)
        _log.SetVerbosity(self.verbosity)
        if self.verbosity >= 2 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            self._trace_dir = trace_dir or os.path.join(os.getcwd(),
                                                        "profile_traces")
            acts = [ProfilerActivity.CPU]
            if self.lang == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts,
                                     on_trace_ready=self._write_trace)
            self._profiler.start()
            atexit.register(self._stop_trace)
        elif self.verbosity < 2:
            self._stop_trace()

    def _write_trace(self, prof) -> None:
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(
            self._trace_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.trace_files.append(path)

    def _stop_trace(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is not None:
            prof.stop()

    def record_step_time(self, ms: float) -> None:
        """A training step's blocking wall time (``Model`` calls it at
        verbosity >= 1), also observed by the default registry's
        ``train_step_time_ms`` histogram."""
        self._step_times_ms.append(ms)
        from .telemetry.registry import default_registry
        default_registry().histogram(
            "train_step_time_ms",
            help="blocking compiled-step wall time (SetVerbosity >= 1)",
            device=f"{self.lang}:{self.id}").observe(ms)

    def record_cost_analysis(self, label: str, cost: dict) -> None:
        """``Model`` banks a step's flop table (by op, from
        ``torch.utils.flop_counter``) and its kernel launches here."""
        self._cost_tables[label] = dict(cost)

    def PrintTimeProfiling(self) -> str:
        """Print (and return) the profiling table (reference:
        ``Device::PrintTimeProfiling``): the steps timed, each banked
        flop table, and the trace's directory while one runs."""
        lines = [f"Time Profiling: {self!r}"]
        if self._step_times_ms:
            ts = sorted(self._step_times_ms)
            n = len(ts)
            lines.append(
                f"  compiled steps timed: {n}  "
                f"mean {sum(ts) / n:.3f} ms  p50 {ts[n // 2]:.3f} ms  "
                f"max {ts[-1]:.3f} ms")
        else:
            lines.append("  no steps timed (SetVerbosity(>=1) before "
                         "running compiled steps)")
        for label, cost in self._cost_tables.items():
            lines.append(
                f"  [{label}] flop count (torch.utils.flop_counter; the "
                f"hand-written kernels, launched through ctypes, are not "
                f"in it: their launches are listed):")
            for key in sorted(cost):
                val = cost[key]
                if isinstance(val, (int, float)) and val:
                    lines.append(f"    {key:<28} {val:.4g}")
        if self._profiler is not None:
            lines.append(f"  torch.profiler trace capturing -> "
                         f"{self._trace_dir}")
        table = "\n".join(lines)
        print(table)
        return table

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.id}, lang={self.lang})"


class CppCPU(Device):
    """The host CPU (reference: ``src/core/device/cpp_cpu.cc``)."""

    def __init__(self, device_id: int = 0, seed: int | None = None):
        super().__init__("cpu", seed)


class CudaGPU(Device):
    """One CUDA card (reference: ``src/core/device/cuda_gpu.cc``); raises
    when CUDA is absent or the card does not exist."""

    def __init__(self, device_id: int = 0, seed: int | None = None):
        super().__init__(f"cuda:{int(device_id)}", seed)


class DeviceMemPool:
    """Memory statistics of a device (reference:
    ``include/singa/core/memory.h`` ``DeviceMemPool``/``CnMemPool``):
    on a card, the CUDA caching allocator's counters and
    ``cudaMemGetInfo``; on the CPU nothing, as the JAX package's CPU
    client reports (``memory_stats()`` is None there).  ``device``: a
    :class:`Device`, a ``torch.device`` or a string; None is the default
    device."""

    def __init__(self, device=None, init_size_mb: int = 256, flags: int = 0):
        # reference-API knobs; the caching allocator takes no pool size
        self.init_size_mb = init_size_mb
        self.flags = flags
        self._device = device

    def _card(self):
        """The ``torch.device`` of a card, or None on the CPU."""
        dev = self._device if self._device is not None \
            else get_default_device()
        dev = resolve_device(dev)
        return dev if dev.type == "cuda" else None

    def GetMemUsage(self):
        """``(free, total)`` bytes (reference:
        ``CnMemPool::GetMemUsage(size_t* free, size_t* total)``)."""
        dev = self._card()
        return tuple(torch.cuda.mem_get_info(dev)) if dev is not None \
            else (0, 0)

    def used_bytes(self) -> int:
        dev = self._card()
        return torch.cuda.memory_allocated(dev) if dev is not None else 0

    def peak_bytes(self) -> int:
        dev = self._card()
        return torch.cuda.max_memory_allocated(dev) if dev is not None \
            else 0

    def stats(self) -> dict:
        """The allocator's whole counter dict (``torch.cuda.memory_stats``);
        ``{}`` on the CPU."""
        dev = self._card()
        return dict(torch.cuda.memory_stats(dev)) if dev is not None else {}


# reference-named alias: the cnmem-backed pool class
CnMemPool = DeviceMemPool


def _need_cards(n: int) -> None:
    have = Platform.GetNumGPUs()
    if n > have:
        raise RuntimeError(f"{n} CUDA device(s) asked for, {have} present "
                           f"(no fallback to the CPU)")


class Platform:
    """Device enumeration (reference: ``src/core/device/platform.cc``)."""

    @staticmethod
    def accelerator_devices() -> list:
        """The CUDA cards as ``torch.device``s; none without CUDA."""
        return [torch.device("cuda", i)
                for i in range(Platform.GetNumGPUs())]

    @staticmethod
    def GetNumGPUs() -> int:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @staticmethod
    def CreateCudaGPUs(n: int) -> list:
        _need_cards(n)
        return [CudaGPU(i) for i in range(n)]

    @staticmethod
    def GetGPUMemSize(device_id: int = 0):
        """``(free, total)`` bytes of one card (reference:
        ``Platform::GetGPUMemSize``, ``cudaMemGetInfo``)."""
        _need_cards(device_id + 1)
        return DeviceMemPool(f"cuda:{device_id}").GetMemUsage()


_default_device: Device | None = None


def get_default_device() -> Device:
    """The device that ``device=None`` means for tensors: the one
    :func:`set_default_device` set, else the card (raising without
    CUDA; see the module docstring)."""
    dev = _default_device
    return dev if dev is not None else get_device("cuda")


def set_default_device(dev: Device | None) -> None:
    """Make ``dev`` the default device (None: back to the card)."""
    global _default_device
    if dev is not None and not isinstance(dev, Device):
        dev = get_device(dev)
    _default_device = dev


def create_cpu_device(seed: int | None = None) -> CppCPU:
    return CppCPU(seed=seed)


def create_cuda_gpu(seed: int | None = None) -> CudaGPU:
    return CudaGPU(0, seed=seed)


def create_cuda_gpu_on(device_id: int, seed: int | None = None) -> CudaGPU:
    return CudaGPU(device_id, seed=seed)


def create_cuda_gpus(n: int) -> list:
    return Platform.CreateCudaGPUs(n)


_DEVICES: dict[torch.device, Device] = {}


def get_device(device=None) -> Device:
    """The :class:`Device` for ``device`` (a :class:`Device`, a
    ``torch.device`` or a string; None is :func:`get_default_device`):
    one shared instance per ``torch.device``, so tensors and layers
    placed there draw from one generator."""
    if isinstance(device, Device):
        return device
    if device is None:
        return get_default_device()
    dev = resolve_device(device)
    found = _DEVICES.get(dev)
    if found is None:
        found = _DEVICES[dev] = (CppCPU() if dev.type == "cpu"
                                 else CudaGPU(dev.index))
    return found
