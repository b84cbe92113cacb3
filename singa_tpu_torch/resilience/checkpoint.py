"""Atomic, asynchronous, shard-aware training checkpoints of the port.
Counterpart: ``singa_tpu/resilience/checkpoint.py``, whose directory
layout, manifest, file formats, record names and telemetry names it
keeps, so a directory either package writes restores in the other.

A :class:`CheckpointManager` owns a DIRECTORY of checkpoints plus a
``manifest.json`` describing them:

* **Async off the training thread.**  :meth:`save` copies every state to
  host numpy on the caller's thread and hands the payload to a
  background writer; training goes on while the bytes serialize and
  reach the disk.  On the card the copy is the synchronous device-to-host
  copy of ``Tensor.numpy()``: the captured step writes parameters and
  optimizer state in place, so the next replay would overwrite any view
  or unfinished copy while the writer reads it.  That copy is the save's
  whole cost on the training thread (the ``checkpoint_snapshot`` span).
  ``async_save=None`` (default) keeps the background writer except on a
  single-core host whose model lives on the CPU, where nothing can
  overlap (decided from the model's device); True/False force either.
* **Atomic publication.**  The writer stages the file at a temporary
  path, fsyncs, renames it into place, and only then rewrites the
  manifest (itself staged, fsynced and renamed), so a crash at any
  instant leaves the manifest pointing at a complete checkpoint.
* **Integrity.**  The manifest records each file's CRC32 and size and
  the metadata an exact resume needs (step, loss scale, loader cursor,
  the device generator's state); :meth:`restore_latest` walks the
  entries newest to oldest, verifies each and falls back past corrupt or
  missing ones (:class:`~singa_tpu_torch.snapshot.CorruptCheckpointError`)
  to the newest valid checkpoint.
* **Keep-last-K retention**, pruned after the manifest stops naming the
  files.
* **Shard-aware saves** (``shard_aware=True``, under a ZeRO-1
  ``DistOpt`` of world >= 2): each ``@zshard`` optimizer state, gathered
  by ``DistOpt.get_states`` to the global padded layout (a collective
  every rank joins, on the training thread), is written as one record a
  rank's range (``name@shard{i}``, ``i`` the rank) with the ranges in
  the manifest's ``shards`` entry, as the JAX package writes the same
  state at the same world size; restore stitches them back (JAX-written
  directories too) and ``DistOpt.set_states`` takes the rank's chunk.

Under a communicator every rank calls :meth:`save` (the state gathering
is collective) and rank 0 alone writes files and the manifest; every
rank's :meth:`wait` (the next ``save`` calls it) joins rank 0's writer
and meets the others at a barrier, so no rank goes past a wait before
the publish it waits for.

The RNG state: the JAX package stores its key under the meta key
``"rng"``, which only ``jax.random.wrap_key_data`` reads.  The port
stores its generator's byte state under ``"torch_rng"`` and reads only
that: a JAX-written checkpoint leaves the generator as it is (logged),
and the JAX package restores a port checkpoint without touching its
key.

Telemetry: ``checkpoint_snapshot`` / ``checkpoint_write`` /
``checkpoint_restore`` spans (cat ``"train"``) on the installed tracer,
and ``train_checkpoint_{saved,bytes,corrupt,restore}_total`` counters
plus the ``train_checkpoint_save_ms`` histogram in the default registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from ..logging import INFO, LOG, WARNING
from ..model import Model
from ..snapshot import CorruptCheckpointError, atomic_publish
from ..telemetry import registry as _registry_mod
from ..telemetry import tracer as _tracer_mod

__all__ = ["CheckpointManager", "CorruptCheckpointError"]

_SEP = "."           # Layer.sep: optimizer states save as "opt.<name>"
_OPT = f"opt{_SEP}"
_SHARD_TAG = "@shard"
_ZSHARD = "@zshard"
MANIFEST = "manifest.json"
RNG_KEY = "torch_rng"


def _jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _single_core_host(model) -> bool:
    """True on a single-core machine whose model lives on the CPU: a
    background writer could only time-slice against the step there."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    if cores > 1:
        return False
    dev = getattr(model, "device", None)
    return dev is None or dev.lang == "cpp"


class CheckpointManager:
    """See the module docstring.  ``model`` must be compiled with its
    optimizer set before the first :meth:`save` (state names come from
    it); ``fmt`` is ``"zip"`` or ``"snapshot"``; ``faults`` is an
    optional :class:`~singa_tpu_torch.resilience.faults.TrainFaultPlan`
    whose checkpoint-write seams fire inside the writer."""

    def __init__(self, model, directory: str, *, keep: int = 3,
                 fmt: str = "zip", async_save: bool | None = None,
                 shard_aware: bool = False, faults=None):
        if fmt not in ("zip", "snapshot"):
            raise ValueError(f"unknown checkpoint format {fmt!r} "
                             "(zip | snapshot)")
        self.model = model
        self.directory = str(directory)
        self.keep = max(1, int(keep))
        self.fmt = fmt
        if async_save is None:
            async_save = not _single_core_host(model)
        self.async_save = bool(async_save)
        self.shard_aware = bool(shard_aware)
        self.faults = faults
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()  # manifest read/modify/write
        self.saved = 0                 # successfully published saves

    @property
    def _comm(self):
        comm = getattr(self.model, "communicator", None)
        return comm if comm is not None and comm.world_size > 1 else None

    # ------------------------------------------------------------------
    # manifest
    # ------------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _load_manifest(self) -> dict:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            if not isinstance(m.get("checkpoints"), list):
                raise ValueError("manifest missing checkpoint list")
            return m
        except FileNotFoundError:
            return {"version": 1, "format": self.fmt, "checkpoints": []}
        except (ValueError, OSError):
            # a corrupt manifest: recover what the directory proves, every
            # complete checkpoint file, unverified (no CRC), so
            # restore_latest still decodes each before trusting it
            entries = []
            suffix = ".zip" if self.fmt == "zip" else ".bin"
            for name in sorted(os.listdir(self.directory)):
                if name.startswith("ckpt-") and name.endswith(suffix):
                    try:
                        step = int(name[len("ckpt-"):].split(".")[0])
                    except ValueError:
                        continue
                    entries.append({"step": step,
                                    "files": [{"name": name}],
                                    "meta": {"step": step}})
            entries.sort(key=lambda e: e["step"])
            return {"version": 1, "format": self.fmt,
                    "checkpoints": entries, "recovered": True}

    def _store_manifest(self, manifest: dict) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        atomic_publish(tmp, self.manifest_path)

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step: int, *, aux: dict | None = None, loader=None,
             blocking: bool | None = None) -> str:
        """Checkpoint the model at ``step``: copy the state to the host
        on this thread, then write in the background (unless
        ``blocking`` or ``async_save=False``).  Returns the path the save
        publishes.  A failure of a previous background write re-raises
        here (and from :meth:`wait`)."""
        self.wait()  # one writer at a time; surfaces prior errors
        if blocking is None:
            blocking = not self.async_save
        tr = _tracer_mod.current()
        t0 = time.perf_counter()
        payload, shard_meta = self._snapshot_states()
        fname = self._filename(step)
        path = os.path.join(self.directory, fname)
        comm = self._comm
        if comm is not None and comm.global_rank != 0:
            return path                   # rank 0 writes
        meta = self._build_meta(step, aux, loader, shard_meta)
        if tr is not None:
            tr.span("checkpoint_snapshot", t0, time.perf_counter(),
                    cat="train", args={"step": int(step)})
        if blocking:
            self._write(payload, meta, fname)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(payload, meta, fname),
                name=f"ckpt-write-{step}", daemon=True)
            self._thread.start()
        return path

    def wait(self) -> None:
        """Block until an in-flight background save lands (under a
        communicator, until rank 0's has: a barrier); re-raise its error
        if it failed."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._comm is not None:
            self._comm.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def in_flight(self) -> bool:
        """Whether a background write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def _filename(self, step: int) -> str:
        return f"ckpt-{int(step):08d}" + (".zip" if self.fmt == "zip"
                                          else ".bin")

    def _snapshot_states(self):
        """Every state copied to host numpy (see the module docstring);
        the optimizer's through its ``get_states`` (a collective under
        ZeRO-1)."""
        model = self.model
        states = {name: t.numpy() for name, t in model.get_states().items()}
        opt = model.optimizer
        if opt is not None:      # get_states copies (Tensor.numpy) too
            for name, arr in opt.get_states().items():
                states[_OPT + name] = np.asarray(arr)
        shard_meta = {}
        if self.shard_aware and self._comm is not None:
            states, shard_meta = self._split_shards(states,
                                                    self._comm.world_size)
        return states, shard_meta

    @staticmethod
    def _split_shards(states, world: int):
        """Each ``@zshard`` state (its global padded flat layout) as one
        record a rank's range, with the ranges for the manifest."""
        shard_meta = {}
        for name in [n for n in states
                     if n.startswith(_OPT) and _ZSHARD in n]:
            a = states.pop(name)
            chunk = a.shape[0] // world
            parts = []
            for i in range(world):
                rec = f"{name}{_SHARD_TAG}{i}"
                states[rec] = a[i * chunk:(i + 1) * chunk]
                parts.append({"record": rec, "start": [i * chunk],
                              "stop": [(i + 1) * chunk]})
            shard_meta[name] = {"shape": list(a.shape),
                                "dtype": a.dtype.name, "parts": parts}
        return states, shard_meta

    def _build_meta(self, step, aux, loader, shard_meta) -> dict:
        meta = {"step": int(step),
                "wall_time": time.time(),
                "aux": _jsonable(dict(aux or {})),
                "shards": shard_meta}
        dev = getattr(self.model, "device", None)
        if dev is not None:
            meta[RNG_KEY] = {
                "data": dev.get_rng_state().numpy().tobytes().hex(),
                "device_type": dev.torch_device.type}
        pol = getattr(self.model, "precision_policy", None)
        if pol is not None and pol.loss_scale is not None:
            meta["loss_scale"] = float(pol.loss_scale.scale.item())
        if loader is not None and hasattr(loader, "state_dict"):
            meta["loader"] = loader.state_dict()
        return meta

    # ------------------------------------------------------------------
    # background writer
    # ------------------------------------------------------------------
    def _write_guarded(self, payload, meta, fname):
        try:
            self._write(payload, meta, fname)
        except BaseException as e:  # surfaced by the next save()/wait()
            self._error = e

    def _seam(self, phase: str) -> None:
        if self.faults is not None:
            self.faults.on_checkpoint_write(phase)

    def _write(self, payload: dict, meta: dict, fname: str) -> None:
        tr = _tracer_mod.current()
        t0 = time.perf_counter()
        final = os.path.join(self.directory, fname)
        tmp = final + ".tmp"
        self._seam("begin")
        aux = {k: np.asarray(v) for k, v in meta["aux"].items()}
        # Model's file layout, so Model.load_states reads these files
        Model._write_states_file(tmp, self.fmt, payload, aux)
        self._seam("staged")      # tmp complete on disk, final untouched
        atomic_publish(tmp, final)
        self._seam("published")   # file live, manifest not yet updated
        entry = {"step": meta["step"],
                 "files": [{"name": fname, "crc32": _crc32(final),
                            "size": os.path.getsize(final)}],
                 "meta": meta}
        with self._lock:
            manifest = self._load_manifest()
            manifest["format"] = self.fmt
            manifest["checkpoints"] = [
                e for e in manifest["checkpoints"]
                if e["step"] != meta["step"]] + [entry]
            manifest["checkpoints"].sort(key=lambda e: e["step"])
            pruned = manifest["checkpoints"][:-self.keep]
            manifest["checkpoints"] = manifest["checkpoints"][-self.keep:]
            manifest.pop("recovered", None)
            self._store_manifest(manifest)
            for old in pruned:  # after the manifest stops naming them
                for f in old["files"]:
                    try:
                        os.remove(os.path.join(self.directory, f["name"]))
                    except OSError:
                        pass
            self.saved += 1   # the writer bumps it while readers poll
        nbytes = entry["files"][0]["size"]
        dt_ms = (time.perf_counter() - t0) * 1e3
        if tr is not None:
            tr.span("checkpoint_write", t0, time.perf_counter(),
                    cat="train", args={"step": meta["step"],
                                       "bytes": nbytes})
        reg = _registry_mod.default_registry()
        reg.counter("train_checkpoint_saved_total",
                    help="published training checkpoints").inc()
        reg.counter("train_checkpoint_bytes_total",
                    help="bytes of published training checkpoints"
                    ).inc(nbytes)
        reg.histogram("train_checkpoint_save_ms",
                      help="background checkpoint write+publish latency"
                      ).observe(dt_ms)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def restore_latest(self, model=None, *, reset_caches: bool = True):
        """Restore the newest valid checkpoint into ``model`` (default:
        the manager's own); entries failing CRC, size or decoding are
        skipped with a counter bump.  Returns the manifest entry's
        ``meta`` (the caller's ``aux`` under ``"aux"``), or None when no
        valid checkpoint exists.  ``reset_caches=False`` keeps the
        captured steps: the restore copies in place into the tensors
        they read (an in-process rollback; see ``Model._apply_states``)."""
        model = model if model is not None else self.model
        tr = _tracer_mod.current()
        reg = _registry_mod.default_registry()
        manifest = self._load_manifest()
        for entry in reversed(manifest["checkpoints"]):
            t0 = time.perf_counter()
            try:
                states, aux, path = self._read_entry(entry)
                meta = dict(entry.get("meta") or {})
                states = self._stitch_shards(states,
                                             meta.get("shards") or {})
            except (CorruptCheckpointError, OSError) as e:
                reg.counter("train_checkpoint_corrupt_total",
                            help="checkpoints skipped by restore as "
                            "corrupt/missing").inc()
                LOG(WARNING, "skipping corrupt checkpoint step %s: %s",
                    entry.get("step"), e)
                continue
            model._apply_states(states, aux, reset_caches=reset_caches)
            self._restore_rng(model, meta)
            # in-file aux (epoch etc.) backfills the manifest's, so an
            # entry recovered from a directory scan still resumes
            aux_meta = (dict(meta["aux"])
                        if isinstance(meta.get("aux"), dict) else {})
            for k, v in aux.items():
                aux_meta.setdefault(k, _jsonable(np.asarray(v)))
            meta["aux"] = aux_meta
            reg.counter("train_checkpoint_restore_total",
                        help="successful checkpoint restores").inc()
            if tr is not None:
                tr.span("checkpoint_restore", t0, time.perf_counter(),
                        cat="train", args={"step": meta.get("step"),
                                           "path": path})
            return meta
        return None

    def _read_entry(self, entry):
        files = entry.get("files") or []
        if not files:
            raise CorruptCheckpointError(self.manifest_path,
                                         "manifest entry lists no files")
        f = files[0]
        path = os.path.join(self.directory, f["name"])
        if not os.path.exists(path):
            raise CorruptCheckpointError(path, "checkpoint file missing")
        if "size" in f and os.path.getsize(path) != f["size"]:
            raise CorruptCheckpointError(
                path, f"size mismatch (manifest {f['size']}, "
                f"disk {os.path.getsize(path)})")
        if "crc32" in f and _crc32(path) != f["crc32"]:
            raise CorruptCheckpointError(path, "CRC32 mismatch")
        states, aux = Model._read_states_file(path)
        return states, aux, path

    def _stitch_shards(self, states: dict, shard_meta: dict) -> dict:
        for name, info in shard_meta.items():
            out = np.zeros(tuple(info["shape"]), np.dtype(info["dtype"]))
            for part in info["parts"]:
                rec = part["record"]
                if rec not in states:
                    raise CorruptCheckpointError(
                        self.manifest_path, "missing shard record", key=rec)
                sl = tuple(slice(a, b) for a, b in
                           zip(part["start"], part["stop"]))
                out[sl] = states.pop(rec)
            states[name] = out
        return states

    @staticmethod
    def _restore_rng(model, meta: dict) -> None:
        dev = getattr(model, "device", None)
        if dev is None:
            return
        rng = meta.get(RNG_KEY)
        if rng is None:
            if meta.get("rng") is not None:
                LOG(INFO, "checkpoint step %s holds the JAX package's RNG "
                    "key only: the device generator is left as it is",
                    meta.get("step"))
            return
        state = torch.frombuffer(bytearray.fromhex(rng["data"]),
                                 dtype=torch.uint8)
        if (rng.get("device_type") != dev.torch_device.type
                or state.numel() != dev.get_rng_state().numel()):
            LOG(WARNING, "checkpoint step %s holds a %s generator state: "
                "the %s device generator is left as it is",
                meta.get("step"), rng.get("device_type"),
                dev.torch_device.type)
            return
        dev.set_rng_state(state)

    # convenience for `with` use around a training run
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
