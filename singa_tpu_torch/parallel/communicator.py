"""The port's communicator.  Counterpart:
``singa_tpu/parallel/communicator.py`` (``NcclIdHolder`` :69,
``init_distributed`` :80, ``Communicator`` :94).

The reference is one process driving every chip: ``Model.compile(
communicator=)`` wraps the step in ``shard_map``, and its collectives
lower to XLA collectives while the mesh axes are bound.  The port runs
**one process a device**, in a ``torch.distributed`` process group: NCCL
for CUDA tensors, gloo for CPU tensors, chosen by the rank's device.  A
collective on a CUDA tensor goes through NCCL and nothing else: it never
stages through the host or gloo, and a tensor on the wrong device for
the group's backend raises.

* :func:`init_distributed` joins a group over TCP (the reference's
  ``jax.distributed.initialize``); :func:`launch` spawns ``world_size``
  processes on this host, one a rank, over one ``FileStore``, runs a
  function in each and returns rank 0's result (the reference's
  ``examples/cnn/train_multiprocess.py`` drives its chips from one
  process instead).  Both give a CUDA rank the card of its local rank
  and pass it as ``device_id``, so the NCCL communicator exists before
  any step is captured.
* :class:`Communicator` ``default()`` is world 1 with no group: every
  collective is the identity.  ``from_devices`` is one device a rank of
  the initialised group; a communicator on a group issues its
  collectives at every world size, world 1 included (the card's world-1
  run goes through NCCL).  ``from_mesh_shape`` takes a one-axis
  ``{"data": N}`` mesh only.
* ``active`` is true for a communicator on a group: each rank runs the
  step itself, eagerly or as a captured CUDA graph, so there is no
  trace whose axes need binding.  ``bind_axes`` keeps the reference's
  context manager: it records the axes (only the data axis exists) and
  changes nothing about what is issued.  ``axis_index`` is the rank, a
  host int.
* ``comm_stats()`` counts the collectives issued, by ``(op, axis)``,
  and their bytes: per **step** (every eager call and every replay of a
  captured step; a replay credits what its capture recorded, as the
  kernel launch counters are credited, ``_graphs.register_counters``),
  where the reference counts per trace.  ``publish_metrics`` sets them
  as the reference's ``comm_calls`` / ``comm_bytes`` gauges by ``(op,
  axis)`` in a telemetry registry (the reference's per-trace
  ``comm_collectives_total`` counters have no counterpart: nothing is
  traced); ``serving_submeshes`` belongs to sharded serving (item 12).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
import warnings

import torch
import torch.distributed as dist

from .. import _graphs
from ..device import Device, resolve_device

__all__ = ["Communicator", "NcclIdHolder", "init_distributed", "launch"]

_lock = threading.Lock()
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class NcclIdHolder:
    """Carries the coordinator address, as in the reference: the process
    group meets there (``init_distributed``), so no id is exchanged."""

    def __init__(self, coordinator_address: str | None = None):
        self.coordinator_address = coordinator_address or \
            os.environ.get("SINGA_TPU_COORDINATOR", "127.0.0.1:12345")


def _rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: ``device`` (None: the card), a CUDA device
    without an index taking the card of ``local_rank``."""
    if isinstance(device, Device):
        return device.torch_device
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)              # raises without CUDA
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolve_device(dev)


def _init_group(dev: torch.device, world_size: int, rank: int, **kw):
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev            # the NCCL communicator, eagerly
    dist.init_process_group(_BACKEND[dev.type], world_size=world_size,
                            rank=rank, **kw)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None):
    """Join the process group of ``num_processes`` ranks that meets at
    ``coordinator_address`` (``host:port``, by TCP; default
    ``NcclIdHolder``'s) as rank ``process_id`` (reference: ``MPI_Init``
    and the NCCL id broadcast).  Unset arguments come from ``WORLD_SIZE``
    and ``RANK`` (1 and 0 when those are unset too).  ``device``: the
    card (None; the card of ``LOCAL_RANK``, else of the rank) over NCCL,
    or ``"cpu"`` over gloo."""
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", 1))
    r = int(process_id if process_id is not None
            else os.environ.get("RANK", 0))
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", r)))
    addr = NcclIdHolder(coordinator_address).coordinator_address
    _init_group(dev, n, r, init_method=f"tcp://{addr}")


def launch(fn, world_size: int, args=(), device=None,
           timeout: float | None = None):
    """Run ``fn(*args)`` in ``world_size`` spawned processes, one a rank
    of a process group on ``device`` (None: the cards of this host over
    NCCL, rank r on card r; ``"cpu"``: gloo) that meets in one
    ``FileStore``; return rank 0's result.  ``fn`` and ``args`` are
    pickled (``fn`` by its import path); each child sets ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE``.  A rank that raises or dies makes
    this raise with its traceback, and every child still running is
    killed; so are all of them when ``timeout`` seconds pass first."""
    n = int(world_size)
    if n < 1:
        raise ValueError(f"launch needs world_size >= 1, got {world_size}")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        resolve_device(dev)              # raises without CUDA
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="singa_launch_") as tmp:
        store = os.path.join(tmp, "store")
        # the call goes by file: a child that dies while it starts would
        # leave a large argument blocking the pipe that starts it
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(call, r, n, str(dev), store, results))
                 for r in range(n)]
        try:
            for p in procs:
                p.start()
            got = _collect(procs, results, deadline)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return got[0]


def _collect(procs, results, deadline) -> dict:
    """Every rank's report, in arrival order; raises on a failure, a rank
    that exited without one, or the deadline."""
    got = {}
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"launch: ranks {sorted(set(range(len(procs))) - set(got))}"
                    f" did not finish in time") from None
            gone = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in got]
            if gone and results.empty():
                raise RuntimeError(
                    f"launch: rank {gone[0]} exited (code "
                    f"{procs[gone[0]].exitcode}) without a result") from None
            continue
        if not ok:
            raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
        got[rank] = payload
    return got


def _rank_main(call, rank, world_size, device, store_path, results):
    """One rank of :func:`launch`: join the group, run the call that
    :func:`launch` pickled to ``call``, report."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        dev = _rank_device(device, rank)
        _init_group(dev, world_size, rank,
                    store=dist.FileStore(store_path, world_size))
        out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        # peers may sit in a collective with this rank: no teardown
        os._exit(1)
    results.put((rank, True, out if rank == 0 else None))
    dist.destroy_process_group()


@contextlib.contextmanager
def _quiet():
    """torch >= 2.12 warns that these two names are deprecated; the card's
    torch has no replacement for them."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=r".*(all_gather_into_tensor|"
                              r"reduce_scatter_tensor).* is deprecated")
        yield


class Communicator:
    """A data-parallel group of ranks and its collectives (see the module
    docstring).  ``group``: a ``torch.distributed`` group, or None for
    world 1 with identity collectives; ``device``: this rank's
    ``torch.device``; one axis, ``data_axis``."""

    _default = None

    def __init__(self, group=None, world_size: int = 1, rank: int = 0,
                 device=None, data_axis: str = "data"):
        self.group = group
        self._world = int(world_size)
        self._rank = int(rank)
        self.device = device
        self.data_axis = data_axis
        self._local_rank = int(os.environ.get("LOCAL_RANK", rank))
        self._active_axes: tuple[str, ...] = ()
        # ("calls" | "bytes", op, axis) -> count; replays credit it
        self.counters: dict = {}
        if group is not None:
            _graphs.register_counters(self)

    # ---- construction ---------------------------------------------------
    @classmethod
    def default(cls) -> "Communicator":
        with _lock:
            if cls._default is None:
                cls._default = cls()
            return cls._default

    @classmethod
    def from_devices(cls, devices=None,
                     data_axis: str = "data") -> "Communicator":
        """One device a rank of the initialised group (``devices[rank]`` is
        this rank's; None: the card set by ``init_distributed`` /
        ``launch`` under NCCL, the CPU under gloo)."""
        if not dist.is_initialized():
            raise RuntimeError("Communicator.from_devices needs an "
                               "initialised process group: call "
                               "init_distributed(...) or run under launch()")
        n, r = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        if devices is None:
            mine = (torch.device("cuda", torch.cuda.current_device())
                    if backend == "nccl" else torch.device("cpu"))
        else:
            devices = list(devices)
            if len(devices) != n:
                raise ValueError(f"{len(devices)} devices for a group of {n} "
                                 f"ranks: give one device a rank")
            mine = resolve_device(devices[r])
        if _BACKEND.get(mine.type) != backend:
            raise ValueError(f"rank {r}'s device {mine} does not match the "
                             f"group's backend {backend!r} (NCCL for CUDA, "
                             f"gloo for the CPU)")
        return cls(dist.group.WORLD, n, r, mine, data_axis)

    @classmethod
    def from_mesh_shape(cls, shape: dict, devices=None) -> "Communicator":
        """A one-axis ``{"data": N}`` mesh over the initialised group of N
        ranks; other axes belong to tensor parallelism."""
        if tuple(shape) != ("data",):
            raise NotImplementedError(
                f"mesh axes {tuple(shape)}: only a one-axis {{'data': N}} "
                f"mesh is ported; tensor-parallel axes belong to a later "
                f"slice of the port (ROADMAP.md queue 1, item 12)")
        comm = cls.from_devices(devices)
        if comm.world_size != int(shape["data"]):
            raise ValueError(f"mesh {shape} over a group of "
                             f"{comm.world_size} ranks")
        return comm

    # ---- topology -------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self._world

    @property
    def data_parallel_size(self) -> int:
        return self._world

    @property
    def global_rank(self) -> int:
        return self._rank

    @property
    def local_rank(self) -> int:
        return self._local_rank

    @property
    def num_processes(self) -> int:
        return self._world           # one process a rank

    # ---- axis binding ---------------------------------------------------
    @contextlib.contextmanager
    def bind_axes(self, *axes: str):
        """Record ``axes`` as bound for the block (only the data axis
        exists); collectives issue either way."""
        for a in axes:
            self._check_axis(a)
        prev = self._active_axes
        self._active_axes = tuple(axes)
        try:
            yield self
        finally:
            self._active_axes = prev

    @property
    def active(self) -> bool:
        return self.group is not None

    def _check_axis(self, axis):
        axis = axis or self.data_axis
        if axis != self.data_axis:
            raise ValueError(f"axis {axis!r}: this communicator has one axis,"
                             f" {self.data_axis!r}")
        return axis

    # ---- accounting -----------------------------------------------------
    def _issue(self, op: str, raw: torch.Tensor, axis) -> bool:
        """Whether ``op`` goes to the group (counting it when it does);
        raises on a tensor the group's backend does not take."""
        axis = self._check_axis(axis)
        if self.group is None:
            return False
        if raw.device != self.device:
            raise ValueError(f"{op} of a tensor on {raw.device} on a "
                             f"communicator of {self.device}: the port "
                             f"stages nothing through the host")
        for kind, n in (("calls", 1), ("bytes", raw.numel()
                                       * raw.element_size())):
            key = (kind, op, axis)
            self.counters[key] = self.counters.get(key, 0) + n
        return True

    def comm_stats(self) -> dict:
        """``{"calls": {(op, axis): n}, "bytes": {(op, axis): n},
        "total_calls": n, "total_bytes": n}`` of the collectives issued."""
        out = {"calls": {}, "bytes": {}}
        for (kind, op, axis), n in self.counters.items():
            out[kind][(op, axis)] = n
        out["total_calls"] = sum(out["calls"].values())
        out["total_bytes"] = sum(out["bytes"].values())
        return out

    def publish_metrics(self, registry=None, **labels):
        """Publish :meth:`comm_stats` into a telemetry
        :class:`~singa_tpu_torch.telemetry.MetricsRegistry` (the default
        one when ``registry`` is None) as ``comm_calls`` and
        ``comm_bytes`` gauges by ``(op, axis)``: set to the cumulative
        totals, so repeated publishes are idempotent.  Returns the
        registry."""
        from ..telemetry.registry import default_registry
        reg = default_registry() if registry is None else registry
        stats = self.comm_stats()
        for (op, axis), n in stats["calls"].items():
            reg.gauge("comm_calls", op=op, axis=axis, **labels).set(n)
        for (op, axis), n in stats["bytes"].items():
            reg.gauge("comm_bytes", op=op, axis=axis, **labels).set(n)
        return reg

    # ---- collectives ----------------------------------------------------
    def all_reduce(self, raw, axis: str | None = None):
        """The sum over the ranks (reference ``synch``); a new tensor."""
        if not self._issue("all_reduce", raw, axis):
            return raw
        out = raw.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_mean(self, raw, axis: str | None = None):
        if not self._issue("all_reduce_mean", raw, axis):
            return raw
        out = raw.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out / self._world

    def all_gather(self, raw, axis: str | None = None, tiled: bool = True):
        """Every rank's ``raw`` in rank order: concatenated on the first
        axis (``tiled``) or stacked on a new one."""
        if tiled and raw.dim() == 0:
            raise ValueError("a tiled all_gather needs at least one axis")
        if not self._issue("all_gather", raw, axis):
            return raw if tiled else raw.unsqueeze(0)
        x = raw.reshape(-1)
        out = torch.empty(self._world * x.numel(), dtype=x.dtype,
                          device=x.device)
        with _quiet():
            dist.all_gather_into_tensor(out, x, group=self.group)
        out = out.view((self._world,) + tuple(raw.shape))
        return out.flatten(0, 1) if tiled else out

    def reduce_scatter(self, raw, axis: str | None = None):
        """The sum over the ranks, this rank's ``1 / world`` of the first
        axis (reference ``psum_scatter(tiled=True)``)."""
        if raw.dim() == 0 or raw.shape[0] % self._world:
            raise ValueError(f"reduce_scatter of shape {tuple(raw.shape)} "
                             f"over {self._world} ranks")
        if not self._issue("reduce_scatter", raw, axis):
            return raw
        x = raw.contiguous()
        out = torch.empty((x.shape[0] // self._world,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _quiet():
            dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def ppermute(self, raw, perm, axis: str | None = None):
        """``raw`` sent along ``perm``'s ``(source, destination)`` pairs; a
        rank no pair sends to gets zeros (``lax.ppermute``)."""
        if not self._issue("ppermute", raw, axis):
            return raw
        x = raw.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == dst == self._rank:
                out.copy_(x)
            elif src == self._rank:
                ops.append(dist.P2POp(dist.isend, x, dst, self.group))
            elif dst == self._rank:
                ops.append(dist.P2POp(dist.irecv, out, src, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def axis_index(self, axis: str | None = None) -> int:
        self._check_axis(axis)
        return self._rank if self.group is not None else 0

    def wait(self) -> None:
        """Block the host until the collectives issued so far are done
        (they are ordered on the current stream; gloo's on the CPU are
        done when they return)."""
        if self.group is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it."""
        if self.group is None:
            return
        if self.device.type == "cuda":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)

    def __repr__(self):
        return (f"Communicator(world={self._world}, rank={self._rank}, "
                f"device={self.device}, axis={self.data_axis!r})")
